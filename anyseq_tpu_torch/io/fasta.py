"""FASTA / FASTQ sequence readers.

A copy of the JAX package's ``anyseq_tpu/io/fasta.py`` (pure Python), so
that this package imports nothing of it. Mirrors the reference reader
semantics (src/sequence_io.{h,cpp}): format chosen by file extension,
falling back to sniffing the first character ('>' = FASTA, '@' = FASTQ);
readers are thread-safe iterators; the CLI uses only the first record of
each file (src/main.cpp:182-189).

The JAX package's native C++ reader (``anyseq_tpu/io/_native.py``) is not
ported: this pure-Python reader is the semantic definition it follows.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Iterator, Optional


class IOError_(Exception):
    pass


class FileAccessError(IOError_):
    pass


class FileReadError(IOError_):
    pass


class IOFormatError(IOError_):
    pass


@dataclasses.dataclass
class SequenceRecord:
    index: int
    header: str
    data: bytes
    qualities: bytes = b""


class SequenceReader:
    """Thread-safe sequential record reader (reference sequence_io.h:24-66)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._index = 0
        self._valid = True

    def has_next(self) -> bool:
        return self._valid

    def next(self) -> SequenceRecord:
        with self._lock:
            if not self._valid:
                return SequenceRecord(self._index, "", b"")
            self._index += 1
            rec = SequenceRecord(self._index, "", b"")
            self._read_next(rec)
            return rec

    def skip(self, n: int) -> None:
        with self._lock:
            for _ in range(n):
                if not self._valid:
                    break
                self._index += 1
                self._read_next(SequenceRecord(self._index, "", b""))

    def __iter__(self) -> Iterator[SequenceRecord]:
        while self.has_next():
            rec = self.next()
            if rec.data or rec.header:
                yield rec

    def _invalidate(self):
        self._valid = False

    def _read_next(self, rec: SequenceRecord) -> None:
        raise NotImplementedError


class FastaReader(SequenceReader):
    def __init__(self, filename: str):
        super().__init__()
        try:
            self._file = open(filename, "rb")
        except OSError as e:
            self._invalidate()
            raise FileAccessError(f"can't open file {filename}") from e
        self._linebuffer = b""

    def _read_next(self, rec: SequenceRecord) -> None:
        if self._linebuffer:
            line = self._linebuffer
            self._linebuffer = b""
        else:
            line = self._file.readline()
            if not line:
                self._invalidate()
                return
        line = line.rstrip(b"\r\n")
        if not line.startswith(b">"):
            self._invalidate()
            raise IOFormatError(
                "malformed fasta file - expected header char > not found"
            )
        rec.header = line[1:].decode(errors="replace")
        chunks = []
        while True:
            line = self._file.readline()
            if not line:
                self._invalidate()
                break
            if line.startswith(b">"):
                self._linebuffer = line
                break
            chunks.append(line.rstrip(b"\r\n"))
        rec.data = b"".join(chunks)
        if not rec.data:
            self._invalidate()
            raise IOFormatError(
                f"malformed fasta file - zero-length sequence: {rec.header}"
            )


class FastqReader(SequenceReader):
    def __init__(self, filename: str):
        super().__init__()
        try:
            self._file = open(filename, "rb")
        except OSError as e:
            self._invalidate()
            raise FileAccessError(f"can't open file {filename}") from e

    def _read_next(self, rec: SequenceRecord) -> None:
        line = self._file.readline()
        if not line:
            self._invalidate()
            return
        line = line.rstrip(b"\r\n")
        if not line.startswith(b"@"):
            self._invalidate()
            if line:
                raise IOFormatError(
                    f"malformed fastq file - sequence header: {line!r}"
                )
            return
        rec.header = line[1:].decode(errors="replace")
        rec.data = self._file.readline().rstrip(b"\r\n")
        plus = self._file.readline().rstrip(b"\r\n")
        if not plus.startswith(b"+"):
            self._invalidate()
            if plus:
                raise IOFormatError(
                    f"malformed fastq file - quality header: {plus!r}"
                )
            return
        rec.qualities = self._file.readline().rstrip(b"\r\n")


class SequenceHeaderReader(SequenceReader):
    """Reads sequence header lines only (reference
    sequence_io.h:115-143 / sequence_io.cpp:168-200): each ``next()``
    scans forward to the next line starting with '>' or '@' and returns
    its text (without the marker) as the record header; ``data`` stays
    empty. Works on both FASTA and FASTQ files -- with the reference's
    own quirk preserved: the line scan is blind, so a FASTQ quality
    string whose first character is '@' (Phred+33 Q31) or '>' (Q29)
    is misread as a phantom header, exactly as the C++ reader does
    (use :class:`FastqReader` for structural 4-line parsing)."""

    def __init__(self, filename: str):
        super().__init__()
        try:
            self._file = open(filename, "rb")
        except OSError as e:
            self._invalidate()
            raise FileAccessError(f"can't open file {filename}") from e

    def _read_next(self, rec: SequenceRecord) -> None:
        while True:
            line = self._file.readline()
            if not line:
                self._invalidate()
                return
            line = line.rstrip(b"\r\n")
            if line.startswith((b">", b"@")):
                rec.header = line[1:].decode(errors="replace")
                return


def make_sequence_reader(filename: str) -> SequenceReader:
    """Pick a reader by extension, else sniff the first byte
    (reference: sequence_io.cpp:206-241)."""
    lower = filename.lower()
    if lower.endswith((".fq", ".fnq", ".fastq")):
        return FastqReader(filename)
    if lower.endswith((".fa", ".fna", ".fasta")):
        return FastaReader(filename)
    if not os.path.exists(filename):
        raise FileAccessError("file not accessible")
    with open(filename, "rb") as f:
        first = f.read(1)
    if first == b">":
        return FastaReader(filename)
    if first == b"@":
        return FastqReader(filename)
    raise FileReadError("file format not recognized")


def read_first_sequence(filename: str) -> bytes:
    """First record of a file -- the reference CLI's input convention
    (main.cpp:182-189)."""
    reader = make_sequence_reader(filename)
    if reader.has_next():
        return reader.next().data
    return b""
