#!/usr/bin/env python3
"""Where the time of anyseq_tpu_torch's batch calls goes, on one CUDA card.

    python3 tools/profile_torch.py

For each batch call of ``chip_smoke.py``'s batch path (the same seeded
pairs): one cold call, three warm walls (host clock around a call that
ends in ``torch.cuda.synchronize()``), then one warm call under
``torch.profiler``. Prints per call the walls, the device busy time (the
union of the profiled kernel and copy intervals), the idle share
(1 - busy / fastest warm wall), and the device time by kernel name;
then the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the seeded pairs and scorings)


def busy_ms(events) -> float:
    """Union of the device intervals of the profiled events, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def profile(fn):
    """(device busy ms, {name: device ms}) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    return busy_ms(device), by_name


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.kernels import _build

    _build.build()
    rng = np.random.default_rng(chip_smoke.SEED)
    sets = {256: [chip_smoke.related_pair(rng, 256) for _ in range(10_000)],
            4096: [chip_smoke.related_pair(rng, 4096) for _ in range(200)]}
    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*chip_smoke.AFFINE)
    calls = (
        ("align_scores_batch", 256, 10_000, "local", sc),
        ("align_scores_batch", 256, 10_000, "local", asc),
        ("align_batch", 256, 10_000, "local", sc),
        ("align_scores_batch", 256, 1000, "global", sc),
        ("align_batch", 256, 1000, "global", sc),
        ("align_scores_batch", 256, 1000, "semiglobal", sc),
        ("align_batch", 256, 1000, "semiglobal", sc),
        ("align_scores_batch", 4096, 200, "local", sc),
    )
    for name, n, count, mode, scoring in calls:
        qs, ss = map(list, zip(*sets[n][:count]))

        def call():
            return getattr(pt, name)(qs, ss, mode, scoring, device="cuda")

        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy, by_name = profile(call)
        fastest = min(walls[1:]) * 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"{name} {mode} {type(scoring).__name__} {count} pairs ~{n} "
              f"bp: cold {walls[0] * 1e3:.3f} ms, warm "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls[1:])} ms; device "
              f"busy {busy:.3f} ms, idle {1 - busy / fastest:.3f}; "
              + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
