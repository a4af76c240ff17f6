"""Alignment pretty-printing.

Prints score, then the two aligned strings interleaved in blocks of
``max_width`` columns with '|' markers on matching positions.
"""
from __future__ import annotations

import sys

from anyseq_tpu_torch.core.types import Alignment


def print_alignment(alignment: Alignment, max_width: int = 80, file=None,
                    dense: bool = True) -> None:
    out = file or sys.stdout
    if dense:
        q, s = alignment.compact()
    else:
        q = alignment.query_aligned.decode(errors="replace")
        s = alignment.subject_aligned.decode(errors="replace")
    print(alignment.score, file=out)
    n = len(q)
    for i in range(0, max(n, 1), max_width):
        j = min(n, i + max_width)
        print(q[i:j], file=out)
        print(
            "".join("|" if q[k] == s[k] else " " for k in range(i, j)),
            file=out,
        )
        print(s[i:j], file=out)
        print(file=out)
