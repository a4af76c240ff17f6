"""DP-state introspection: the H (E, F) and predecessor matrices of a
tiny problem as text tables.

The counterpart of the JAX package's ``utils/debug.py`` (the reference's
``print_matrix`` printers, ``utils.impala:51-152``), wired into test
failure messages so that a kernel's miscompare shows the whole DP state
of its small input instead of a bare array diff. The matrices come from
the plain full-matrix recurrence below, kept whole (O(m * n) Python; keep
inputs small), not from the linear-memory sweeps, and carry the -1
boundary row and column at index 0. The text is the JAX package's.
"""
from __future__ import annotations

import io
import sys

import numpy as np

from anyseq_tpu_torch.core.types import (
    NEG,
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    AffineScoring,
    LinearScoring,
    Mode,
    as_u8,
)

_PRED_CHAR = {0: ".", 1: "<", 2: "^", 3: "\\"}  # NONE/GAP_Q/GAP_S/NO_GAP


def dp_full(q8, s8, mode: Mode, sc: LinearScoring):
    """(H, P), (m+1, n+1): scores and predecessor codes of the linear
    recurrence (ties: diagonal, then gap in the query, then gap in the
    subject; LOCAL clamps at 0 with no predecessor)."""
    m, n = len(q8), len(s8)
    H = np.zeros((m + 1, n + 1), np.int64)
    P = np.zeros((m + 1, n + 1), np.uint8)
    if mode is Mode.GLOBAL:
        H[:, 0] = np.arange(m + 1) * sc.gap
        H[0, :] = np.arange(n + 1) * sc.gap
        P[1:, 0] = PRED_GAP_S
        P[0, 1:] = PRED_GAP_Q
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = sc.match if q8[i - 1] == s8[j - 1] else sc.mismatch
            best, pred = H[i - 1, j - 1] + sub, PRED_NO_GAP
            if H[i, j - 1] + sc.gap > best:
                best, pred = H[i, j - 1] + sc.gap, PRED_GAP_Q
            if H[i - 1, j] + sc.gap > best:
                best, pred = H[i - 1, j] + sc.gap, PRED_GAP_S
            if mode is Mode.LOCAL and best < 0:
                best, pred = 0, PRED_NONE
            H[i, j], P[i, j] = best, pred
    return H, P


def dp_full_affine(q8, s8, mode: Mode, sc: AffineScoring):
    """(H, E, F, PH, PE, PF), (m+1, n+1): the Gotoh recurrence (E a gap
    in the query, F in the subject; ties: opening over extending, then
    diagonal, E, F for H; LOCAL clamps H at 0)."""
    m, n = len(q8), len(s8)
    go, ge = sc.gap_open, sc.gap_extend
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), NEG, np.int64)
    F = np.full((m + 1, n + 1), NEG, np.int64)
    PH, PE, PF = (np.zeros((m + 1, n + 1), np.uint8) for _ in range(3))
    if mode is Mode.GLOBAL:
        H[0, 1:] = E[0, 1:] = go + np.arange(1, n + 1) * ge
        H[1:, 0] = F[1:, 0] = go + np.arange(1, m + 1) * ge
        PH[0, 1:] = PRED_GAP_Q
        PH[1:, 0] = PRED_GAP_S
        PE[0, 2:] = 1
        PF[2:, 0] = 1
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            e_open, e_ext = H[i, j - 1] + go + ge, E[i, j - 1] + ge
            E[i, j], PE[i, j] = (e_open, 0) if e_open >= e_ext else (e_ext, 1)
            f_open, f_ext = H[i - 1, j] + go + ge, F[i - 1, j] + ge
            F[i, j], PF[i, j] = (f_open, 0) if f_open >= f_ext else (f_ext, 1)
            sub = sc.match if q8[i - 1] == s8[j - 1] else sc.mismatch
            best, pred = H[i - 1, j - 1] + sub, PRED_NO_GAP
            if E[i, j] > best:
                best, pred = E[i, j], PRED_GAP_Q
            if F[i, j] > best:
                best, pred = F[i, j], PRED_GAP_S
            if mode is Mode.LOCAL and best < 0:
                best, pred = 0, PRED_NONE
            H[i, j], PH[i, j] = best, pred
    return H, E, F, PH, PE, PF


def _heads(q8, s8, m1: int, n1: int):
    def label(c):
        return chr(c) if 32 <= c < 127 else str(c)

    return (["*"] + [label(c) for c in s8[: n1 - 1]],
            ["*"] + [label(c) for c in q8[: m1 - 1]])


def format_matrix(M, q8, s8, title="H", neg_inf_below=-(2**28)) -> str:
    """One (m+1, n+1) boundary-haloed matrix as an aligned text table.

    The column header is the subject, the row header the query; the 0
    row and column (the -1 boundary) are labelled '*'. Values below
    ``neg_inf_below`` print as '-inf'."""
    m1, n1 = M.shape
    cells = [["-inf" if v < neg_inf_below else str(int(v)) for v in row]
             for row in np.asarray(M)]
    w = max(4, max(len(c) for row in cells for c in row))
    head, qhead = _heads(q8, s8, m1, n1)
    out = [f"{title}:", " " * 2 + "".join(h.rjust(w + 1) for h in head)]
    for i, row in enumerate(cells):
        out.append(qhead[i].rjust(2) + "".join(c.rjust(w + 1) for c in row))
    return "\n".join(out)


def format_preds(P, q8, s8, title="preds") -> str:
    """A predecessor matrix as direction glyphs: '\\\\' diagonal, '<' gap
    in the query (left), '^' gap in the subject (up), '.' none."""
    m1, n1 = P.shape
    head, qhead = _heads(q8, s8, m1, n1)
    out = [f"{title}:", "   " + " ".join(h.rjust(1) for h in head)]
    for i, row in enumerate(np.asarray(P)):
        out.append(qhead[i].rjust(2) + " "
                   + " ".join(_PRED_CHAR.get(int(v) & 3, "?") for v in row))
    return "\n".join(out)


def format_dp_state(query, subject, mode="global",
                    scoring=LinearScoring()) -> str:
    """The full DP state of a tiny problem as a string: H (+ E and F,
    affine) and the predecessor matrix."""
    q8, s8 = as_u8(query), as_u8(subject)
    mode = Mode.parse(mode)
    buf = io.StringIO()
    print(f"mode={mode.name} m={len(q8)} n={len(s8)} scoring={scoring}",
          file=buf)
    if isinstance(scoring, AffineScoring):
        H, E, F, PH, _, _ = dp_full_affine(q8, s8, mode, scoring)
        print(format_matrix(H, q8, s8, "H"), file=buf)
        print(format_matrix(E, q8, s8, "E (gap in query / horizontal)"),
              file=buf)
        print(format_matrix(F, q8, s8, "F (gap in subject / vertical)"),
              file=buf)
        print(format_preds(PH, q8, s8, "preds (H choice)"), file=buf)
    else:
        H, P = dp_full(q8, s8, mode, scoring)
        print(format_matrix(H, q8, s8, "H"), file=buf)
        print(format_preds(P, q8, s8), file=buf)
    return buf.getvalue()


def dump_matrix(query, subject, mode="global", scoring=LinearScoring(),
                file=None):
    """Print the full DP state of a tiny problem (for debugging a
    miscompare: keep inputs small)."""
    print(format_dp_state(query, subject, mode, scoring),
          file=file or sys.stdout)
