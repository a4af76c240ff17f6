"""The least time one H100 could take for the work of a call: the frozen
table of operations a cell and the card's peaks.

Frozen copy of the bound of ``chip_smoke.py`` (``OPS``, ``cell_ops``,
``HBM_BYTES_PER_S``, ``INT32_LANES_PER_SM``) at the card's published
numbers. It counts the work the inputs need, not the strips, widths or
passes a kernel chooses: m * n cells once (a Hirschberg construction
sweeps them several times, and counts them once), each cell's int32
instructions as the card issues them (a DPX max-plus as one), a walk
step for every column of a constructed alignment, each input byte read
once and each output byte written once.
"""
from __future__ import annotations

# int32 instructions a cell: linear gaps take the diagonal max-plus, the
# vertical max-plus, the left chain's max-plus and the substitution's
# compare and select (5); affine gaps carry E and F as well (7); LOCAL
# keeps a running best, a three-input max for two cells (0.5). A walk
# step decodes its code, compares, decrements and forms its address (8).
OPS_PER_CELL = {"linear": 5, "affine": 7}
LOCAL_BEST = 0.5
WALK_STEP = 8

# one NVIDIA H100 SXM5 (data sheet): 132 SMs of 64 int32 lanes at the
# 1980 MHz boost clock, 3.35 TB/s of HBM3; at the full 700 W power limit
SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ


def ops_per_cell(mode: str, scoring: dict) -> float:
    return OPS_PER_CELL[scoring["kind"]] + (LOCAL_BEST if mode == "local"
                                            else 0.0)


def bound_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, what bounds them): the larger of the operations over the
    int32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
