#!/usr/bin/env python3
"""A quick check of K7 (the batch sweep, ``csrc/swarm.cu``) on one CUDA
card, for work on that kernel alone.

    python3 tools/k7_probe.py

Prints ptxas's registers and spills for each K7 instantiation, holds K7
to its plain version bit for bit on ragged batches (3,000 problems up to
300 x 300 and 129 up to 17 x 40; 3 modes; linear with and without codes;
affine with mixed start-gap flags, also with gap_extend 0), times it at
the batch path's shape (5,000 problems of 256 x 256), and times
``align_scores_batch`` / ``align_batch`` on 10,000 related ~256 bp pairs
and ``align_scores_batch`` on 200 pairs of ~4,096 bp.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (pairs, batches, timing helpers)


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 2
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.kernels import _build, swarm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "swarm.o"), str(_build.CSRC / "swarm.cu")],
            capture_output=True, text=True, check=True).stderr
    print("\n".join(x for x in out.splitlines() if "Used" in x or "spill" in x))

    rng = np.random.default_rng(cs.SEED)
    dev = torch.device("cuda")
    for B, M, N in ((3000, 300, 300), (129, 17, 40)):
        q3, s3, ms, ns = cs.random_batch(rng, dev, B, M, N)
        sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        for mode in Mode:
            for sc, preds in ((LinearScoring(), False), (LinearScoring(), True),
                              (AffineScoring(2, -1, -3, -1), False),
                              (AffineScoring(1, -6, -4, 0), False)):
                flags = sg if isinstance(sc, AffineScoring) else None
                args = (q3, s3, ms, ns, mode, sc, flags, True, preds)
                cs.compare(f"K7 {B} up to {M}x{N} {mode.value} {sc} "
                           f"preds={preds}",
                           lambda: swarm.score_pairs_swarm(*args),
                           lambda: swarm.plain(*args), reps=3)

    pairs = [cs.related_pair(rng, 256) for _ in range(10_000)]
    qs, ss = map(list, zip(*pairs))
    q = torch.from_numpy(np.frombuffer(b"".join(
        a[:256] for a in qs[:5000]), np.uint8).reshape(5000, 256).copy())
    s = torch.from_numpy(np.frombuffer(b"".join(
        (b + b"A" * 256)[:256] for b in ss[:5000]), np.uint8).reshape(
            5000, 256).copy())
    q, s = q.to(dev), s.to(dev)
    full = torch.full((5000,), 256, dtype=torch.int32, device=dev)
    for sc, preds in ((LinearScoring(), False), (LinearScoring(), True),
                      (AffineScoring(2, -1, -3, -1), False)):
        ms_ = cs.cuda_ms(lambda: swarm.score_pairs_swarm(
            q, s, full, full, Mode.LOCAL, sc, need_pos=not preds,
            emit_preds=preds), 5)
        print(f"K7 5000 x 256 x 256 local {sc} preds={preds}: {ms_:.3f} ms",
              flush=True)

    for name, sc in (("align_scores_batch", LinearScoring()),
                     ("align_scores_batch", AffineScoring(2, -1, -3, -1)),
                     ("align_batch", LinearScoring())):
        for rep in range(3):
            t0 = time.perf_counter()
            getattr(pt, name)(qs, ss, "local", sc, device="cuda")
            torch.cuda.synchronize()
            print(f"{name} local {sc} 10000 pairs, call {rep}: "
                  f"{time.perf_counter() - t0:.4f} s", flush=True)
    q4, s4 = map(list, zip(*[cs.related_pair(rng, 4096)
                             for _ in range(200)]))
    t0 = time.perf_counter()
    pt.align_scores_batch(q4, s4, "local", device="cuda")
    torch.cuda.synchronize()
    print(f"align_scores_batch local 200 pairs ~4096 bp: "
          f"{time.perf_counter() - t0:.4f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
