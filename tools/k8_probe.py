#!/usr/bin/env python3
"""What chip_smoke.py does not measure of K8 (the band kernels,
``csrc/band.cu`` and ``csrc/band_affine.cu``), on one CUDA card.

    python3 tools/k8_probe.py

Prints ptxas's registers and spills for K8 and for K1 / K2 and K5 / K5p,
whose strip sweep K8 shares (one source each); then times a 1 Mbp global linear score of three pairs
as one K1 sweep and as a chain of K8 bands (each band's device time
too), in turns (chain, K1, K1, chain) with the SM clock, power and
temperature after each, and holds the two equal.
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

import chip_smoke as cs  # noqa: E402  (pairs, checks, timing helpers)


def wall(fn):
    """fn() once and its wall in s, ending with the card idle."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device", file=sys.stderr)
        return 2
    from anyseq_tpu_torch.core.types import LinearScoring, Mode, as_tensor
    from anyseq_tpu_torch.kernels import _build, band, wavefront

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("band.cu", "band_affine.cu"):
            out = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, name + ".o"),
                 str(_build.CSRC / name)],
                capture_output=True, text=True, check=True).stderr
            print(name, "\n".join(x for x in out.splitlines()
                                  if "Used" in x or "spill" in x))
    lib = _build.library()
    rng = np.random.default_rng(cs.SEED)
    sc = LinearScoring()

    real_band = band.score_band
    for pair in range(3):
        qb, sb = cs.related_pair(rng, 1_000_000)
        q, s = as_tensor(qb, "cuda"), as_tensor(sb, "cuda")
        cells = q.numel() * s.numel()
        outs = {}
        for tag in ("chain", "K1", "K1", "chain"):     # in turns
            band_ms = []
            if tag == "K1":
                fn = lambda: wavefront.launch(lib, q, s, Mode.GLOBAL, sc,
                                              False)
            else:
                fn = lambda: band.score_pair_chained(q, s, Mode.GLOBAL, sc)

                def timed_band(*args, **kwargs):
                    out, ms = cs.timed(lambda: real_band(*args, **kwargs))
                    band_ms.append(round(ms, 3))
                    return out

                band.score_band = timed_band
            try:
                outs[tag], t = wall(fn)
            finally:
                band.score_band = real_band
            clocks = subprocess.run(
                ["nvidia-smi",
                 "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            what = ("one K1 sweep" if tag == "K1" else
                    f"chain of {len(band_ms)} K8 bands (device ms each "
                    f"{band_ms})")
            print(f"1 Mbp global pair {pair} {q.numel()}x{s.numel()}: {what} "
                  f"wall_s={t:.4f} gcups={cells / t / 1e9:.2f} (after it: "
                  f"{clocks})", flush=True)
        err = cs.max_abs_err(outs["K1"], outs["chain"])
        cs.check(err == 0, "1 Mbp global: chain == one K1 sweep")
        print(f"1 Mbp global pair {pair}: chain == one K1 sweep", flush=True)
        del outs
    print("k8_probe ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
