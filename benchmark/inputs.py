"""The inputs of a cell, made from its seed by one general generator.

A configuration's ``sequences`` names one of two sequence classes and
their parameters; a traffic mix says how many calls' inputs the pool
holds and how many pairs a call takes:

- ``related_pair``: a random DNA sequence of ``length`` bp and a mutated
  copy of it (``sub_rate`` substitutions, ``indel_rate`` insertions and
  deletions), one pair per pool entry;
- ``reads``: one random reference of ``reference_bp``, reads sampled from
  it (length ``read_length``; where ``full_share`` is below 1, that share
  of them, the rest trimmed, spread evenly over ``trimmed_lengths``), each
  mutated at ``sub_rate`` / ``indel_rate``, and against each read the
  window of the reference from ``flank`` bp before its start to ``flank``
  bp after the read's length. Every batch holds the same multiset of read
  lengths, so every seed gives the same work, in another order.

The same seed gives the same bytes; a seed may be any whole number.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", np.uint8)


def related_pair(rng, n: int, sub_rate=0.1, indel_rate=0.05):
    """A random DNA sequence of length n and a mutated copy (substitutions,
    insertions and deletions), as bytes.

    Frozen copy of ``chip_smoke.py`` ``related_pair`` (the seeded pairs of
    the port's bring-up checks)."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    q = alphabet[rng.integers(0, 4, n)]
    s = q.copy()
    sub = rng.random(n) < sub_rate
    s[sub] = alphabet[rng.integers(0, 4, int(sub.sum()))]
    r = rng.random(n)
    dele = r < indel_rate / 2
    ins = (r >= indel_rate / 2) & (r < indel_rate)
    both = np.stack([np.where(ins, alphabet[rng.integers(0, 4, n)], 0),
                     np.where(dele, 0, s)], 1).ravel()
    return q.tobytes(), both[both != 0].tobytes()


def read_lengths(count: int, read_length: int, full_share: float = 1.0,
                 trimmed=None) -> np.ndarray:
    """The lengths of a batch of `count` reads, in a fixed order: the
    full-length reads, then the trimmed ones spread evenly over the
    closed range `trimmed`."""
    full = int(round(count * full_share))
    if full == count:
        return np.full(count, read_length, np.int64)
    lo, hi = trimmed
    short = np.linspace(lo, hi, count - full).round().astype(np.int64)
    return np.concatenate([np.full(full, read_length, np.int64), short])


def mutate_reads(rng, source: np.ndarray, lengths: np.ndarray,
                 sub_rate: float, indel_rate: float) -> list[bytes]:
    """Each row of `source` (uint8 symbols, at least a few bp longer than
    its length) mutated as :func:`related_pair` mutates a sequence, then
    cut to its length."""
    R, W = source.shape
    s = source.copy()
    sub = rng.random((R, W)) < sub_rate
    s[sub] = ALPHABET[rng.integers(0, 4, int(sub.sum()))]
    r = rng.random((R, W))
    dele = r < indel_rate / 2
    ins = (r >= indel_rate / 2) & (r < indel_rate)
    reads = []
    edited = (dele | ins).any(1)
    for b in range(R):
        L = int(lengths[b])
        if not edited[b]:
            reads.append(s[b, :L].tobytes())
            continue
        both = np.stack([np.where(ins[b], ALPHABET[rng.integers(0, 4, W)],
                                  0), np.where(dele[b], 0, s[b])], 1).ravel()
        reads.append(both[both != 0][:L].tobytes())
    return reads


def rng_of(seed: int, *salt: int):
    """A generator for `seed` (any whole number, negative too) and the
    stream `salt` names."""
    seed = int(seed)
    return np.random.default_rng([seed if seed >= 0 else 2**64 - seed,
                                  *salt])


@dataclasses.dataclass
class Item:
    """One call's inputs: its queries and subjects (one pair for a
    single-pair entry), and the cells m * n they hold."""

    queries: list
    subjects: list
    cells: int


def _item(queries, subjects) -> Item:
    cells = sum(len(a) * len(b) for a, b in zip(queries, subjects))
    return Item(queries, subjects, cells)


def make_pool(config: dict, traffic: dict, seed: int) -> list[Item]:
    """The pool of calls' inputs of a cell for `seed`."""
    rng = rng_of(seed)
    spec = config["sequences"]
    pool, per_call = int(traffic["pool"]), int(traffic["pairs_per_call"])
    if spec["class"] == "related_pair":
        items = []
        for _ in range(pool):
            pairs = [related_pair(rng, int(spec["length"]), spec["sub_rate"],
                                  spec["indel_rate"]) for _ in range(per_call)]
            items.append(_item([p[0] for p in pairs], [p[1] for p in pairs]))
        return items
    if spec["class"] != "reads":
        raise ValueError(f"unknown sequence class {spec['class']!r}")
    genome = ALPHABET[rng.integers(0, 4, int(spec["reference_bp"]))]
    flank, L = int(spec["flank"]), int(spec["read_length"])
    slack = 16              # source past a read's length, for its deletions
    base = read_lengths(per_call, L, spec.get("full_share", 1.0),
                        spec.get("trimmed_lengths"))
    items = []
    for _ in range(pool):
        lengths = rng.permutation(base)
        starts = rng.integers(flank, genome.shape[0] - L - flank - slack,
                              per_call)
        source = genome[starts[:, None] + np.arange(L + slack)]
        reads = mutate_reads(rng, source, lengths, spec["sub_rate"],
                             spec["indel_rate"])
        windows = [genome[a - flank: a + n + flank].tobytes()
                   for a, n in zip(starts.tolist(), lengths.tolist())]
        items.append(_item(reads, windows))
    return items
