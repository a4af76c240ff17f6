"""User-facing alignment API: score-only, full-matrix traceback and the
linear-memory construction (Hirschberg, or Myers-Miller for affine gaps),
global / semiglobal / local, with linear or affine (Gotoh) gap scoring,
on an explicit torch device.

The device is never chosen silently: the default is ``"cuda"``, and CPU
runs (the tests) pass ``device="cpu"``, which runs every kernel's plain
torch version.
"""
from __future__ import annotations

from anyseq_tpu_torch.core.types import (
    Alignment,
    LinearScoring,
    Mode,
    as_tensor,
    as_u8,
    check_scoring,
)
from anyseq_tpu_torch.engine import device_tb, hirschberg, linmem
from anyseq_tpu_torch.kernels import wavefront
from anyseq_tpu_torch.utils import profiling

# align(traceback="auto") runs the full-matrix traceback up to this many
# cells and Hirschberg above.
FULL_TB_MAX_CELLS = 1 << 22


def _prep(query, subject, device):
    with profiling.wait():
        q = as_tensor(query, device)
        s = as_tensor(subject, device)
    if q.shape[0] == 0 or s.shape[0] == 0:
        raise ValueError("empty sequences are not supported")
    return q, s


@profiling.entry("api.align_score")
def align_score(query, subject, mode="global", scoring=LinearScoring(),
                device="cuda") -> int:
    """Score-only alignment."""
    mode = Mode.parse(mode)
    sc = check_scoring(scoring)
    q, s = _prep(query, subject, device)
    outs = wavefront.score(q, s, mode, sc)
    score = linmem.extract_end(outs, q.shape[0], s.shape[0], mode)[0]
    with profiling.wait():
        return int(score)


@profiling.entry("api.align_full_tb")
def align_full_tb(query, subject, mode="global", scoring=LinearScoring(),
                  device="cuda") -> Alignment:
    """Full-matrix traceback alignment: O(m*n/4) bytes of predecessor
    codes on the device; use :func:`align` for long sequences."""
    mode = Mode.parse(mode)
    sc = check_scoring(scoring)
    q, s = _prep(query, subject, device)
    score, _, out_q, out_s, start = device_tb.fulltb(q, s, mode, sc)
    return Alignment(score, bytes(out_q), bytes(out_s), start)


@profiling.entry("api.align")
def align(query, subject, mode="global", scoring=LinearScoring(),
          traceback="auto", device="cuda", mesh=None) -> Alignment:
    """Construct an alignment.

    traceback: "hirschberg" (linear memory), "full" (O(m*n) predecessor
    codes), or "auto" (full up to 2^22 cells, Hirschberg above). With a
    ``mesh`` (``dist.mesh.Mesh``) the construction runs over its devices
    (``hirschberg.align_hirschberg``) and `device` is not read; over a
    mesh of several processes every process makes the call and gets the
    alignment."""
    mode = Mode.parse(mode)
    if mesh is not None:
        # as in the JAX package, a mesh always means Hirschberg
        return hirschberg.align_hirschberg(query, subject, mode, scoring,
                                           device=device, mesh=mesh)
    if traceback == "auto":
        cells = len(as_u8(query)) * len(as_u8(subject))
        traceback = "full" if cells <= FULL_TB_MAX_CELLS else "hirschberg"
    if traceback == "full":
        return align_full_tb(query, subject, mode, scoring, device)
    if traceback != "hirschberg":
        raise ValueError(f"unknown traceback {traceback!r}")
    return hirschberg.align_hirschberg(query, subject, mode, scoring,
                                       device=device)
