"""What the sweep wrappers share: the kernels' mode codes, the lanes of a
warp strip (K1/K2, K5/K5p, K4/K5L, K7, K8), the strips of a width, their
input check and the reduction of their per-strip bests."""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import Mode

LANES = 32     # a warp strip's lanes (csrc/band_sweep.cuh)
MODE_CODE = {Mode.GLOBAL: 0, Mode.SEMIGLOBAL: 1, Mode.LOCAL: 2}
_INT_MAX = 2**31 - 1


def check_pair(q: torch.Tensor, s: torch.Tensor) -> None:
    for name, t in (("query", q), ("subject", s)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
        if not 0 < t.shape[0] < 2**31 // 2:
            raise ValueError(f"{name} length {t.shape[0]} out of range")
    if q.device != s.device:
        raise ValueError("query and subject must be on one device")


def strips_of(n: int, lane_cols: int) -> int:
    """Warp strips of `lane_cols` columns a lane over n columns."""
    return -(-n // (LANES * lane_cols))


def reduce_best(bests: torch.Tensor) -> torch.Tensor:
    """(S, 3) per-strip first maxima -> (3,) overall first maximum in
    row-major order: highest score, then smallest i, then smallest j."""
    s, i, j = bests.unbind(1)
    top = s.max()
    at_top = s == top
    i_min = torch.where(at_top, i, _INT_MAX).min()
    j_min = torch.where(at_top & (i == i_min), j, _INT_MAX).min()
    return torch.stack([top, i_min, j_min])
