"""A dry run of every multi-device path on small inputs, each held bit for
bit to the single-device port.

    python -m anyseq_tpu_torch.dist.dryrun [N] [--device cpu]

The counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:28-165``): on a mesh of N devices (default: every
CUDA device; ``--device cpu`` repeats the CPU N times, which runs the
plain versions) it runs the sharded score in three modes, linear and
affine; the distributed construction (Hirschberg and Myers-Miller) with
levels over the whole mesh and data-parallel levels; the data-parallel
batch (scores and alignments); and the 2-D (dp x sp) collective batch.
Any difference raises.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from anyseq_tpu_torch.core.types import (
    AffineScoring,
    LinearScoring,
    Mode,
    as_tensor,
)


def _same(got, want, what: str) -> None:
    if isinstance(want, dict):
        same = got.keys() == want.keys() and all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    elif dataclasses.is_dataclass(want):
        same = dataclasses.astuple(got) == dataclasses.astuple(want)
    elif isinstance(want, list) and want and dataclasses.is_dataclass(want[0]):
        same = ([dataclasses.astuple(a) for a in got]
                == [dataclasses.astuple(a) for a in want])
    else:
        same = np.array_equal(np.asarray(got), np.asarray(want))
    if not same:
        raise RuntimeError(f"dryrun_multichip: {what} differs from the "
                           "single-device port")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run each multi-device path over `devices` (default: the first
    `n_devices` CUDA devices; repeats allowed) against the single-device
    port on the first of them; raise on any difference."""
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.dist import batch as dist_batch
    from anyseq_tpu_torch.dist.collective import score_pairs_collective
    from anyseq_tpu_torch.dist.mesh import make_mesh
    from anyseq_tpu_torch.dist.sharded import score_pair_sharded
    from anyseq_tpu_torch.engine.hirschberg import align_hirschberg
    from anyseq_tpu_torch.kernels import wavefront

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    home = devices[0]
    sc, asc = LinearScoring(2, -1, -1), AffineScoring(2, -1, -3, -1)
    mesh = make_mesh(sp=n_devices, dp=1, devices=devices)
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = bytes(alpha[rng.integers(0, 4, 200)])
    s = bytes(alpha[rng.integers(0, 4, 1500)])
    qt, st = as_tensor(q, home), as_tensor(s, home)

    # (a) the sharded score, every mode and scheme, all outputs
    for scoring in (sc, asc):
        for mode in Mode:
            kw = ({"emit_col_e": True} if isinstance(scoring, AffineScoring)
                  else {})
            want = wavefront.score(qt, st, mode, scoring, **kw)
            got = score_pair_sharded(q, s, mode, scoring, mesh)
            got.pop("last_row_f", None)
            _same(got, want, f"score_pair_sharded {mode.value} {scoring}")

    # (b) the construction: levels over the whole mesh (halves of at
    # least 256 columns), data-parallel levels and terminal stripes
    for scoring in (sc, asc):
        for mode in Mode:
            want = align_hirschberg(q, s, mode, scoring, device=home)
            got = align_hirschberg(q, s, mode, scoring, mesh=mesh,
                                   sp_min_width=256)
            _same(got, want, f"align_hirschberg(mesh=) {mode.value} "
                             f"{scoring}")

    # (c) the data-parallel batch over a (dp, sp) mesh, an odd batch
    dp = 2 if n_devices % 2 == 0 else 1
    mesh2 = make_mesh(dp=dp, sp=n_devices // dp, devices=devices)
    B = 2 * n_devices + 1
    qs = [bytes(alpha[rng.integers(0, 4, 200)]) for _ in range(B)]
    ss = [bytes(alpha[rng.integers(0, 4, 210)]) for _ in range(B)]
    got = dist_batch.align_scores_batch_sharded(qs, ss, Mode.LOCAL, sc,
                                                mesh2)
    _same(got, pt.align_scores_batch(qs, ss, Mode.LOCAL, sc, device=home),
          "align_scores_batch_sharded")
    _same(pt.align_batch(qs, ss, Mode.LOCAL, sc, mesh=mesh2),
          pt.align_batch(qs, ss, Mode.LOCAL, sc, device=home),
          "align_batch(mesh=)")

    # (d) the 2-D (dp x sp) collective batch, chained bands, both schemes
    if dp >= 2:
        sl = [bytes(alpha[rng.integers(0, 4, 2500)]) for _ in range(3)]
        for scoring in (sc, asc):
            res = score_pairs_collective(qs[:3], sl, Mode.GLOBAL, scoring,
                                         mesh2, band_rows=128)
            want = [pt.align_score(a, b, Mode.GLOBAL, scoring, device=home)
                    for a, b in zip(qs[:3], sl)]
            _same([r[0] for r in res], want,
                  f"score_pairs_collective {scoring}")
    print(f"dryrun_multichip({n_devices}): ok")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    n = int(argv[0]) if argv else (torch.cuda.device_count()
                                   if device == "cuda" else 8)
    devices = ([torch.device(device)] * n if device != "cuda"
               else [torch.device("cuda", i) for i in range(n)])
    dryrun_multichip(n, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
