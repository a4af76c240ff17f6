#!/usr/bin/env python3
"""K10, the collective band kernel (``csrc/band.cu``, ``csrc/band_affine.cu``
with a halo), and K7's affine codes (``csrc/swarm.cu``) on one CUDA card.

    python3 tools/k10_probe.py [--quick] [--mesh-score]

Prints ptxas's registers and spills for K8 / K10 and K7; holds K10 and
K10 affine on 2 and 4 ranks of cuda:0 (and across every card where there
are several) to their plain versions, bit for bit, on two chained bands
in 3 modes, under Myers-Miller's start_gap and with an empty last rank,
and K7's affine codes at 4,096 problems of up to 256 x 256; then (unless
--quick) times one band of a 1 Mbp global linear score, 262,144 rows x
~1M columns, as K10 over 2 ranks of cuda:0, as K8 over the whole width,
and as K8 over one rank's stripe, in turns (K10, K8, stripe, stripe, K8,
K10), with medians; where there are several cards, also as K10 over
every card. With --mesh-score and several cards: the 4.6 Mbp global
linear score of chip_smoke.py over every card and over 2 ranks of
cuda:0, their walls, held equal.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (pairs, checks, timing helpers)


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_probe: no CUDA device", file=sys.stderr)
        return 2
    from anyseq_tpu_torch.core.types import LinearScoring, Mode, as_tensor
    from anyseq_tpu_torch.dist import collective
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build, band

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("band.cu", "band_affine.cu", "swarm.cu"):
            out = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, name + ".o"),
                 str(_build.CSRC / name)],
                capture_output=True, text=True, check=True).stderr
            print(name, "\n".join(x for x in out.splitlines()
                                  if "Used" in x or "spill" in x
                                  or "Function properties" in x))
    lib = _build.library()
    rng = np.random.default_rng(cs.SEED)
    errors = {}
    cs.phase2_collective(rng, errors)
    cs.phase2_swarm_affine_codes(rng, errors)
    print(f"k10_probe checks: max_abs_err {errors}", flush=True)
    if "--quick" in sys.argv:
        print("k10_probe ok")
        return 0

    sc = LinearScoring()
    qb, sb = cs.related_pair(rng, 1_000_000)
    h = band.M_BAND
    q, s = as_tensor(qb[:h], "cuda"), as_tensor(sb, "cuda")
    n = s.numel()
    Nl, _, _, _ = collective.geometry(h, n, 2)
    stripe = s[:Nl].contiguous()
    mode = Mode.GLOBAL
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    times = {"K10 2 ranks of cuda:0": [], "K8 whole width": [],
             "K8 one stripe": []}
    if len(cards) > 1:
        times[f"K10 over {len(cards)} cards"] = []

    def k10(devices):
        return collective.launch_pair(q, s, mode, sc,
                                      collective.ranks_of(devices))()

    def k8(subject):
        n_ = subject.numel()
        corner, col = linmem.left_col(mode, sc, 0, h, q.device)
        return band.launch(lib, q, subject, linmem.top_row(
            mode, sc, n_, q.device), corner, col, mode, sc)

    outs = {}
    order = ["K10 2 ranks of cuda:0", "K8 whole width", "K8 one stripe"]
    order += [x for x in times if x not in order]
    fns = {"K10 2 ranks of cuda:0": lambda: k10(["cuda:0"] * 2),
           "K8 whole width": lambda: k8(s),
           "K8 one stripe": lambda: k8(stripe),
           f"K10 over {len(cards)} cards": lambda: k10(cards)}
    for tag in order + order[::-1]:                  # in turns
        fn = fns[tag]
        torch.cuda.synchronize()
        outs[tag], ms = cs.timed(fn)
        times[tag].append(ms)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(f"one band {h}x{n if 'stripe' not in tag else Nl}: {tag} "
              f"ms={ms:.3f} (after it: {clocks})", flush=True)
    for tag in times:
        if tag.startswith("K10"):
            err = cs.max_abs_err(outs[tag], outs["K8 whole width"])
            cs.check(err == 0, f"{tag} == K8 over the whole width")
    for tag, ms in times.items():
        print(f"one band {tag}: median_ms={float(np.median(ms)):.3f} "
              f"runs={[round(x, 3) for x in ms]}", flush=True)
    if "--mesh-score" in sys.argv and len(cards) > 1:
        mesh_score(cards)
    print("k10_probe ok")
    return 0


def mesh_score(cards) -> None:
    """The 4.6 Mbp global linear score over every card and over 2 ranks
    of cuda:0: walls, equal scores."""
    import time

    from anyseq_tpu_torch.core.types import LinearScoring
    from anyseq_tpu_torch.dist.mesh import make_mesh
    from anyseq_tpu_torch.dist.sharded import score_pair_sharded
    from anyseq_tpu_torch.engine import linmem

    rng = np.random.default_rng(cs.SEED + 1)
    q, s = cs.related_pair(rng, cs.ECOLI_BP)
    scores = {}
    for name, devices in ((f"{len(cards)} cards", cards),
                          ("2 ranks of cuda:0", ["cuda:0"] * 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = score_pair_sharded(q, s, "global", LinearScoring(),
                                  make_mesh(devices=devices))
        scores[name] = int(linmem.extract_end(outs, len(q), len(s),
                                              "global")[0])
        wall = time.perf_counter() - t0
        print(f"mesh score {len(q)}x{len(s)} global over {name}: "
              f"score={scores[name]} wall_s={wall:.4f} "
              f"gcups={len(q) * len(s) / wall / 1e9:.2f}", flush=True)
    cs.check(len(set(scores.values())) == 1,
             f"4.6 Mbp mesh scores equal ({scores})")


if __name__ == "__main__":
    sys.exit(main())
