"""The port's CLI (``anyseq_tpu_torch.cli`` with ``--device cpu``) against
the JAX package's (``anyseq_tpu.cli``): the same lines for the same
arguments, with the "N ms" timings masked; and the port's FASTA / FASTQ
readers (``anyseq_tpu_torch.io.fasta``), as ``tests/test_cli_io.py``
tests the JAX package's."""
import io
import json
import os
import re

import pytest

from anyseq_tpu import cli as jax_cli
from anyseq_tpu_torch import cli
from anyseq_tpu_torch.core.types import Alignment
from anyseq_tpu_torch.io import fasta
from anyseq_tpu_torch.io.alignment import print_alignment
from anyseq_tpu_torch.parity import GOLDEN_DIR

from conftest import mutate, random_dna


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, re.sub(r"\d+ ms$", "N ms", out, flags=re.M)


def _same(argv, capsys):
    """Both CLIs on `argv`; returns the port's output."""
    want = _run(jax_cli.main, argv, capsys)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    return got[1]


@pytest.fixture
def pair_files(tmp_path):
    q = tmp_path / "q.fna"
    s = tmp_path / "s.fna"
    q.write_bytes(b">q\nGATTACA\n")
    s.write_bytes(b">s\nGATTTACA\n")
    return str(q), str(s)


@pytest.fixture
def batch_files(tmp_path):
    import numpy as np

    rng = np.random.default_rng(5)
    qs = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(12)]
    ss = [mutate(rng, x) for x in qs]
    qs.append(b"AAAAAA")
    ss.append(b"CCCCCC")
    paths = []
    for name, seqs in (("qs.fa", qs), ("ss.fa", ss)):
        p = tmp_path / name
        p.write_bytes(b"".join(b">r%d\n%s\n" % (i, x)
                               for i, x in enumerate(seqs)))
        paths.append(str(p))
    return paths


def test_cli_random_mode(capsys):
    out = _same(["-r", "16", "24", "--mode", "global"], capsys)
    assert "random strings with length from [16,24]" in out
    assert "testing global alignment N ms" in out


def test_cli_file_mode_print(pair_files, capsys):
    out = _same(["-i", *pair_files, "--mode", "local", "--print"], capsys)
    assert "sequence lengths: 7, 8" in out


def test_cli_all_modes_fulltb(pair_files, capsys):
    out = _same(["-i", *pair_files, "--fulltb", "--print"], capsys)
    assert out.count("testing") == 6


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_cli_batch_scores(batch_files, mode, capsys):
    out = _same(["-b", *batch_files, "--mode", mode, "--score-only"], capsys)
    assert f"batch: 13 pairs, mode {mode}" in out
    assert "pair 12: score" in out


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_cli_batch_alignments(batch_files, mode, capsys):
    out = _same(["-b", *batch_files, "--mode", mode, "--print"], capsys)
    assert f"testing batch {mode} alignment N ms" in out


def test_cli_batch_affine(batch_files, capsys):
    _same(["-b", *batch_files, "--mode", "local", "--score-only",
           "--affine", "-3", "-1"], capsys)


def test_cli_affine_flag(capsys):
    _same(["-r", "20", "30", "--mode", "global", "--affine", "-3", "-1",
           "--print"], capsys)


def test_cli_bad_lengths(capsys):
    assert cli.main(["-r", "0", "5", "--device", "cpu"]) == 1
    assert jax_cli.main(["-r", "0", "5"]) == 1


def test_cli_mesh_not_ported(capsys):
    assert cli.main(["-r", "16", "24", "--mesh", "--device", "cpu"]) != 0
    assert "item 12" in capsys.readouterr().err


def _recorded_outputs(directory, corrupt_first: bool):
    """`align -r <min> <max>` outputs of a timing-only reference binary,
    built from the golden corpus; the first class's lengths are wrong
    where `corrupt_first`."""
    with open(os.path.join(GOLDEN_DIR, "golden.json")) as f:
        golden = json.load(f)
    calls = ["global score", "semiglobal score", "local score",
             "global alignment", "semiglobal alignment", "local alignment"]
    for k, cls in enumerate(golden["classes"]):
        rec = cls["pairs"][0]
        m = rec["m"] + (1 if corrupt_first and k == 0 else 0)
        text = f"sequence lengths: {m}, {rec['n']}\n" + "".join(
            f"testing {c} 3 ms\n" for c in calls)
        path = directory / f"r_{cls['minlen']}x{cls['maxlen']}.txt"
        path.write_text(text)


@pytest.mark.parametrize("corrupt", [False, True], ids=["match", "mismatch"])
def test_cli_parity_recorded(tmp_path, corrupt, capsys):
    _recorded_outputs(tmp_path, corrupt)
    rc_out = _same(["--parity", str(tmp_path)], capsys)
    assert ("MISMATCH" in rc_out) == corrupt


def test_fasta_reader_multirecord(tmp_path):
    p = tmp_path / "x.fna"
    p.write_bytes(b">r1 header one\nACGT\nACG\n>r2\nTTTT\n")
    r = fasta.make_sequence_reader(str(p))
    rec1 = r.next()
    assert rec1.header == "r1 header one"
    assert rec1.data == b"ACGTACG"
    rec2 = r.next()
    assert rec2.data == b"TTTT"
    assert rec2.index == 2


def test_fasta_malformed(tmp_path):
    p = tmp_path / "x.fa"
    p.write_bytes(b"ACGT\n")
    r = fasta.make_sequence_reader(str(p))
    with pytest.raises(fasta.IOFormatError):
        r.next()


def test_fastq_reader(tmp_path):
    p = tmp_path / "x.fastq"
    p.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nGGGG\n+\nJJJJ\n")
    r = fasta.make_sequence_reader(str(p))
    rec = r.next()
    assert rec.data == b"ACGT"
    assert rec.qualities == b"IIII"
    assert r.next().data == b"GGGG"


def test_sequence_header_reader(tmp_path):
    p = tmp_path / "x.fna"
    p.write_bytes(b">r1 header one\nACGT\nACG\n>r2\nTTTT\n")
    r = fasta.SequenceHeaderReader(str(p))
    assert r.next().header == "r1 header one"
    rec2 = r.next()
    assert rec2.header == "r2"
    assert rec2.data == b""
    assert list(r) == []
    assert not r.has_next()
    p2 = tmp_path / "x.fastq"
    p2.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nGGGG\n+\nJJJJ\n")
    r2 = fasta.SequenceHeaderReader(str(p2))
    assert [rec.header for rec in r2] == ["r1", "r2"]
    with pytest.raises(fasta.FileAccessError):
        fasta.SequenceHeaderReader(str(tmp_path / "missing.fa"))


def test_format_sniffing(tmp_path):
    p = tmp_path / "noext"
    p.write_bytes(b">x\nAC\n")
    assert isinstance(fasta.make_sequence_reader(str(p)), fasta.FastaReader)
    p2 = tmp_path / "noext2"
    p2.write_bytes(b"@x\nAC\n+\nII\n")
    assert isinstance(fasta.make_sequence_reader(str(p2)), fasta.FastqReader)
    p3 = tmp_path / "garbage"
    p3.write_bytes(b"xyz\n")
    with pytest.raises(fasta.FileReadError):
        fasta.make_sequence_reader(str(p3))


def test_missing_file():
    with pytest.raises(fasta.FileAccessError):
        fasta.make_sequence_reader("/nonexistent/file.xyz")


def test_read_first_sequence(tmp_path):
    p = tmp_path / "y.fasta"
    p.write_bytes(b">a\nAAA\nCCC\n>b\nGGG\n")
    assert fasta.read_first_sequence(str(p)) == b"AAACCC"


def test_print_alignment_format():
    a = Alignment(5, b" AC_T", b" ACGT", (0, 0))
    buf = io.StringIO()
    print_alignment(a, max_width=3, file=buf)
    lines = buf.getvalue().splitlines()
    assert lines[:4] == ["5", "AC_", "|| ", "ACG"]
    assert lines[5:8] == ["T", "|", "T"]
