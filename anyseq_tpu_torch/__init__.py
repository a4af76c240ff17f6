"""anyseq_tpu_torch -- pairwise sequence alignment in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of the JAX package ``anyseq_tpu``, which stays the reference:
global (Needleman-Wunsch), semiglobal and local (Smith-Waterman) alignment
of one pair with linear or affine (Gotoh) gap scoring, score-only,
full-matrix traceback and linear-memory construction (Hirschberg, or
Myers-Miller for affine gaps). Every entry point takes an
explicit ``device`` ("cuda" by default; "cpu" runs the kernels' plain
torch versions).
"""
from anyseq_tpu_torch.core.types import (
    AffineScoring,
    Alignment,
    LinearScoring,
    Mode,
    scoring_from_reference,
)
from anyseq_tpu_torch.engine.api import align, align_full_tb, align_score

__all__ = [
    "AffineScoring",
    "Alignment",
    "LinearScoring",
    "Mode",
    "align",
    "align_full_tb",
    "align_score",
    "scoring_from_reference",
]

__version__ = "0.1.0"
