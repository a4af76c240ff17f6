"""Pairs whose linear Hirschberg constructions (stripes of at most 256
columns) end in terminal stripes of several kinds, for the port's tests
of the terminal phase."""
import numpy as np

from conftest import mutate, random_dna

TERMINAL_KINDS = ["two buckets", "root terminal", "one row", "levels"]


def terminal_pair(kind: str):
    """(q, s, mode): "two buckets" splits its 257 columns once, into
    stripes of 128 and 129 columns (two padded widths); "root terminal"
    is one stripe; "one row" a stripe of one row and 600 columns; "levels"
    a related 1,400 bp pair, three levels before its stripes."""
    rng = np.random.default_rng(len(kind))
    if kind == "two buckets":
        return random_dna(rng, 700), random_dna(rng, 257), "global"
    if kind == "root terminal":
        q = random_dna(rng, 300)
        return q, mutate(rng, q)[:200], "global"
    if kind == "one row":
        return random_dna(rng, 1), random_dna(rng, 600), "global"
    if kind == "levels":
        q = random_dna(rng, 1400)
        return q, mutate(rng, q), "semiglobal"
    raise ValueError(kind)
