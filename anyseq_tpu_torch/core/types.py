"""Core scalar types, predecessor codes and scheme descriptions.

The same semantics as ``anyseq_tpu.core.types``, without JAX:

- scores are int32 on the device; the public API widens them to Python int;
- predecessor codes::

    PRED_NONE   = 0   # stop marker / local-alignment zero cell
    PRED_GAP_Q  = 1   # came from (i, j-1)  -- gap in the query
    PRED_GAP_S  = 2   # came from (i-1, j)  -- gap in the subject
    PRED_NO_GAP = 3   # came from (i-1, j-1)

- ``SCORE_MIN`` is the running-maximum sentinel; ``NEG`` is the affine
  -inf, safe within int32 under repeated gap additions.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import itertools

import numpy as np
import torch

SCORE_MIN = -2147483647
NEG = -(2**29)

PRED_NONE = 0
PRED_GAP_Q = 1
PRED_GAP_S = 2
PRED_NO_GAP = 3

GAP_SYM = ord("_")
EMPTY_SYM = ord(" ")


class Mode(enum.Enum):
    """Alignment scheme."""

    GLOBAL = "global"
    SEMIGLOBAL = "semiglobal"
    LOCAL = "local"

    @classmethod
    def parse(cls, value: "Mode | str") -> "Mode":
        if isinstance(value, Mode):
            return value
        return cls(str(value).lower())


@dataclasses.dataclass(frozen=True)
class LinearScoring:
    """Linear (constant) gap scoring; ``gap`` must be <= 0."""

    match: int = 2
    mismatch: int = -1
    gap: int = -1

    def __post_init__(self):
        if self.gap > 0:
            raise ValueError("gap penalty must be <= 0")


@dataclasses.dataclass(frozen=True)
class AffineScoring:
    """Gotoh affine gap scoring: a gap of k symbols costs
    gap_open + k * gap_extend."""

    match: int = 2
    mismatch: int = -1
    gap_open: int = -2
    gap_extend: int = -1

    def __post_init__(self):
        if self.gap_open > 0 or self.gap_extend > 0:
            raise ValueError("gap penalties must be <= 0")


Scoring = LinearScoring | AffineScoring


def check_scoring(scoring) -> Scoring:
    """The scoring, if it is one that the engines run: linear or affine."""
    if not isinstance(scoring, (LinearScoring, AffineScoring)):
        raise TypeError("expected LinearScoring or AffineScoring, got "
                        f"{type(scoring).__name__}")
    return scoring


def scoring_from_reference(obj) -> Scoring:
    """This package's scoring from any object with ``match`` / ``mismatch``
    and either ``gap`` or ``gap_open`` / ``gap_extend`` attributes (for
    example the JAX package's own ``LinearScoring`` or ``AffineScoring``)."""
    if hasattr(obj, "gap_open"):
        return AffineScoring(int(obj.match), int(obj.mismatch),
                             int(obj.gap_open), int(obj.gap_extend))
    return LinearScoring(int(obj.match), int(obj.mismatch), int(obj.gap))


@dataclasses.dataclass(frozen=True)
class Alignment:
    """Result of an alignment construction.

    ``query_aligned`` / ``subject_aligned`` are byte buffers of length
    ``len(query) + len(subject)`` prefilled with ``' '``; the aligned pair
    of cell (i, j) is written at offset ``i + j + 1``; gaps are ``'_'``.
    Use :meth:`compact` for the conventional dense gapped strings.
    """

    score: int
    query_aligned: bytes
    subject_aligned: bytes
    start: tuple[int, int]

    def compact(self) -> tuple[str, str]:
        """Strip the sparse ' ' padding, returning dense aligned strings."""
        q = []
        s = []
        for cq, cs in zip(self.query_aligned, self.subject_aligned):
            if cq == EMPTY_SYM and cs == EMPTY_SYM:
                continue
            q.append(chr(cq))
            s.append(chr(cs))
        return "".join(q), "".join(s)


def _alignments(n: int, *columns) -> list[Alignment]:
    """``[Alignment(*row) for row in zip(*columns)]`` for `n` rows, one
    iterable a field in the fields' order, built column by column in C
    loops: ``object.__new__`` for every instance, then ``object.__setattr__``
    of one field over all of them, where the frozen ``__init__`` makes four
    calls a row from Python. The instances are the same as ``Alignment``'s
    own: type, ``==``, ``hash``, ``repr``, and frozen."""
    out = list(map(object.__new__, itertools.repeat(Alignment, n)))
    for field, column in zip(dataclasses.fields(Alignment), columns):
        collections.deque(map(object.__setattr__, out,
                              itertools.repeat(field.name), column),
                          maxlen=0)
    return out


def as_u8(seq) -> np.ndarray:
    """Coerce a sequence (str | bytes | uint8 array) to a numpy uint8 array."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    arr = np.asarray(seq)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


def as_tensor(seq, device) -> torch.Tensor:
    """A sequence (str | bytes | uint8 array) as a 1-D uint8 tensor on
    `device`."""
    return torch.from_numpy(as_u8(seq).copy()).to(device)
