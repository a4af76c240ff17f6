#!/usr/bin/env python3
"""Drive anyseq_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit code):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of the kernels from ``anyseq_tpu_torch/kernels/csrc/``.
2. Each kernel against its plain torch version on the card, on the same
   tensors, bit for bit (integer DP: the tolerance is zero), with both
   times.
3. The main path through the public API with ``device="cuda"``:
   ``align_score`` 1k global, ``align_full_tb`` 10k local, ``align_score``
   100k local and ``align`` 100k semiglobal (which ``traceback="auto"``
   sends to Hirschberg), each with its wall time, GCUPS and kernel
   launches; every kernel must have launched. The 100k alignment is
   rescored from its strings and must equal its score and ``align_score``.
   Small inputs (the golden corpus and a random pair) must give the same
   results on the card as the plain versions on the CPU.
4. Each kernel against its plain version again, on the very inputs the
   main path gave it in phase 3 (kept as they passed), bit for bit.
5. A JSON line of the kernels, the card's line, and the final JSON line.

Exits with code 2 and prints no result without a CUDA device, or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2024
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "wavefront_score": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336"),
    "wavefront_preds": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336"),
    "walk": ("anyseq_tpu_torch/kernels/csrc/walk.cu",
             "anyseq_tpu/engine/device_tb.py:405"),
    "lastcols": ("anyseq_tpu_torch/kernels/csrc/lastcols.cu",
                 "anyseq_tpu/kernels/band.py:1677"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def related_pair(rng, n: int, sub_rate=0.1, indel_rate=0.05):
    """A random DNA sequence of length n and a mutated copy (substitutions,
    insertions and deletions), as bytes."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    q = alphabet[rng.integers(0, 4, n)]
    s = q.copy()
    sub = rng.random(n) < sub_rate
    s[sub] = alphabet[rng.integers(0, 4, int(sub.sum()))]
    r = rng.random(n)
    dele = r < indel_rate / 2
    ins = (r >= indel_rate / 2) & (r < indel_rate)
    both = np.stack([np.where(ins, alphabet[rng.integers(0, 4, n)], 0),
                     np.where(dele, 0, s)], 1).ravel()
    return q.tobytes(), both[both != 0].tobytes()


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """fn() once, and its device time in ms. No warm-up: the plain
    versions run for seconds to a minute at the main path's shapes."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    """Largest difference between two outputs (tensors, or dicts or tuples
    of them); a difference in keys or shapes fails the run."""
    if isinstance(a, dict):
        check(a.keys() == b.keys(), f"output keys {a.keys()} == {b.keys()}")
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    check(a.shape == b.shape, f"output shape {a.shape} == {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare(label, kernel, plain, reps=5):
    """The kernel's output against the plain version's, bit for bit, and
    both times. Returns (max_abs_err, kernel_ms, plain_ms)."""
    a = kernel()
    b, plain_ms = timed(plain)
    err = max_abs_err(a, b)
    check(err == 0, f"{label}: kernel == plain (max_abs_err {err})")
    ms = cuda_ms(kernel, reps)
    print(f"{label} equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.1f}",
          flush=True)
    return err, ms, plain_ms


def rescore(aln, sc) -> int:
    total = 0
    for cq, cs in zip(*aln.compact()):
        if cq == "_" or cs == "_":
            total += sc.gap
        else:
            total += sc.match if cq == cs else sc.mismatch
    return total


def phase2(rng, errors):
    """Each kernel's wrapper on CUDA tensors against its plain version."""
    from anyseq_tpu_torch.core.types import LinearScoring, Mode
    from anyseq_tpu_torch.engine import batch, linmem
    from anyseq_tpu_torch.kernels import lastcols, walk, wavefront

    sc = LinearScoring()
    dev = torch.device("cuda")

    def dev_u8(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    def record(name, err):
        errors[name] = max(errors.get(name, 0), err)

    # K1: 3 modes at a ragged 3000 x 5000
    qb, sb = related_pair(rng, 3000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 5000 - len(sb))[0])
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        err, _, _ = compare(
            f"phase2 K1 wavefront_score {mode.value} {q.numel()}x{s.numel()}",
            lambda: wavefront.score(q, s, mode, sc),
            lambda: wavefront.plain(q, s, mode, sc))
        record("wavefront_score", err)

    # K2 + K3: full traceback, 3 modes at about 2000 x 3000
    qb, sb = related_pair(rng, 2000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 3000 - len(sb))[0])
    m, n = q.numel(), s.numel()
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        err, _, _ = compare(
            f"phase2 K2 wavefront_preds {mode.value} {m}x{n}",
            lambda: wavefront.score(q, s, mode, sc, emit_preds=True),
            lambda: wavefront.plain_preds(q, s, mode, sc))
        record("wavefront_preds", err)
        outs = wavefront.score(q, s, mode, sc, emit_preds=True)
        end = linmem.extract_end(outs, m, n, mode)[None, 1:]
        args = (outs["preds"][None], q[None], s[None], end, mode)
        err, _, _ = compare(f"phase2 K3 walk {mode.value} 1 problem {m}x{n}",
                            lambda: walk.walk(*args),
                            lambda: walk.plain(*args))
        record("walk", err)

    # K4: a ragged batch of 64 halves
    B, M, N = 64, 1500, 3000
    q3 = torch.from_numpy(rng.integers(65, 69, (B, M), dtype=np.uint8)).to(dev)
    s3 = torch.from_numpy(rng.integers(65, 69, (B, N), dtype=np.uint8)).to(dev)
    ms_ = torch.from_numpy(rng.integers(100, M + 1, B)).to(dev)
    ns_ = torch.from_numpy(rng.integers(100, N + 1, B)).to(dev)
    err, _, _ = compare(f"phase2 K4 lastcols {B} halves up to {M}x{N}",
                        lambda: lastcols.last_cols(q3, s3, ms_, ns_, sc),
                        lambda: lastcols.plain(q3, s3, ms_, ns_, sc))
    record("lastcols", err)

    # K3 batched: 64 terminal stripes
    B, M, N = 64, 256, 256
    q3 = torch.from_numpy(rng.integers(65, 69, (B, M), dtype=np.uint8)).to(dev)
    s3 = torch.from_numpy(rng.integers(65, 69, (B, N), dtype=np.uint8)).to(dev)
    ms_ = torch.from_numpy(rng.integers(1, M + 1, B)).to(dev)
    ns_ = torch.from_numpy(rng.integers(1, N + 1, B)).to(dev)
    words, _ = batch.preds_batch(q3, s3, ms_, ns_, sc)
    ends = (torch.stack([ms_, ns_], 1) - 1).to(torch.int32)
    args = (words, q3, s3, ends, Mode.GLOBAL)
    err, _, _ = compare(f"phase2 K3 walk {B} stripes up to {M}x{N}",
                        lambda: walk.walk(*args), lambda: walk.plain(*args))
    record("walk", err)


@contextlib.contextmanager
def kept_launches(kept: list, call: list):
    """Keep (call[0], kernel module, arguments) of every kernel launch made
    inside the block; `call[0]` names the public call being driven."""
    from anyseq_tpu_torch.kernels import lastcols, walk, wavefront

    real = {mod: mod.launch for mod in (wavefront, walk, lastcols)}

    def keeping(mod):
        def launch(*args):
            kept.append((call[0], mod, args))
            return real[mod](*args)
        return launch

    for mod in real:
        mod.launch = keeping(mod)
    try:
        yield
    finally:
        for mod, fn in real.items():
            mod.launch = fn


def phase3(rng, kept):
    """The main path through the public API; returns the launch counts."""
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.kernels import _build

    sc = pt.LinearScoring()
    pairs = {n: related_pair(rng, n) for n in (1000, 10_000, 100_000)}
    calls = (
        ("align_score", 1000, "global",
         lambda q, s: pt.align_score(q, s, "global", device="cuda")),
        ("align_full_tb", 10_000, "local",
         lambda q, s: pt.align_full_tb(q, s, "local", device="cuda")),
        ("align_score", 100_000, "local",
         lambda q, s: pt.align_score(q, s, "local", device="cuda")),
        ("align", 100_000, "semiglobal",
         lambda q, s: pt.align(q, s, "semiglobal", device="cuda")),
    )
    torch.cuda.synchronize()
    current = [None]
    results = {}
    with kept_launches(kept, current):
        for k in _build.launches:
            _build.launches[k] = 0
        for name, n, mode, fn in calls:
            q, s = pairs[n]
            current[0] = (name, n, mode)
            before = dict(_build.launches)
            t0 = time.perf_counter()
            out = fn(q, s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cells = len(q) * len(s)
            delta = {k: v - before[k] for k, v in _build.launches.items()}
            score = out if isinstance(out, int) else out.score
            print(f"phase3 {name} {mode} {len(q)}x{len(s)} score={score} "
                  f"wall_s={wall:.4f} gcups={cells / wall / 1e9:.2f} "
                  f"launches={json.dumps(delta)}", flush=True)
            results[(name, n, mode)] = out
        counts = dict(_build.launches)
    for k, v in counts.items():
        check(v > 0, f"kernel {k} launched on the main path ({v})")

    q, s = pairs[100_000]
    aln = results[("align", 100_000, "semiglobal")]
    again = pt.align_score(q, s, "semiglobal", device="cuda")
    check(rescore(aln, sc) == aln.score == again,
          f"100k semiglobal rescore {rescore(aln, sc)} == score {aln.score}"
          f" == align_score {again}")
    print(f"phase3 100k semiglobal rescored={aln.score} "
          f"align_score={again} equal=True", flush=True)
    return counts


def phase3_small(rng):
    """The public API on small inputs: card == plain versions on the CPU,
    and the golden corpus's scores and full-traceback strings."""
    import dataclasses

    import anyseq_tpu_torch as pt

    q, s = related_pair(rng, 700)
    for mode in ("global", "semiglobal", "local"):
        for fn in (pt.align_score, pt.align_full_tb,
                   lambda *a, **k: pt.align(*a, traceback="hirschberg", **k)):
            a = fn(q, s, mode, device="cuda")
            b = fn(q, s, mode, device="cpu")
            if not isinstance(a, int):
                a, b = dataclasses.astuple(a), dataclasses.astuple(b)
            check(a == b, f"small {mode}: card == CPU")
    with open(os.path.join(ROOT, "tests", "golden", "golden.json")) as f:
        golden = json.load(f)
    checked = 0
    for cls in golden["classes"]:
        if cls["maxlen"] > 1000:
            continue
        with open(os.path.join(ROOT, "tests", "golden", cls["fasta"])) as f:
            seqs, cur = [], []
            for line in f:
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur).encode())
                    cur = []
                else:
                    cur.append(line.strip())
            seqs.append("".join(cur).encode())
        for rec in cls["pairs"]:
            q, s = seqs[2 * rec["k"]], seqs[2 * rec["k"] + 1]
            for mode, want in rec["scores"].items():
                check(pt.align_score(q, s, mode, device="cuda") == want,
                      f"golden {cls['fasta']} {rec['k']} {mode} score")
                checked += 1
            for mode, want in (rec["alignments"] or {}).items():
                got = pt.align_full_tb(q, s, mode, device="cuda").compact()
                check(got == (want["q"], want["s"]),
                      f"golden {cls['fasta']} {rec['k']} {mode} strings")
                checked += 1
    print(f"phase3 small inputs: card == CPU plain, {checked} golden checks "
          f"equal", flush=True)


def phase4(kept, timings, errors):
    """Each kernel against its plain version on inputs the main path gave
    it in phase 3. The times reported in the JSON line are these: K1 at
    the 100k local score, K2 and K3 at the 10k full traceback, K4 at the
    first batched level of the 100k construction."""
    from anyseq_tpu_torch.kernels import lastcols, walk, wavefront

    def kept_of(call, mod):
        return [args for c, md, args in kept if c == call and md is mod]

    def shape(mod, args):
        if mod is wavefront:
            return f"{args[1].numel()}x{args[2].numel()}"
        if mod is walk:
            words, q, s = args[1:4]
            return f"B={words.shape[0]} {q.shape[1]}x{s.shape[1]}"
        q, s, ms, ns = args[1:5]
        return f"B={q.shape[0]} up to {int(ms.max())}x{int(ns.max())}"

    def plain(mod, args):
        if mod is wavefront:
            _, q, s, mode, sc, emit_preds = args
            fn = wavefront.plain_preds if emit_preds else wavefront.plain
            return fn(q, s, mode, sc)
        return mod.plain(*args[1:])

    def run(name, tag, call, mod, args, report=False):
        label = f"phase4 {tag} {name} {' '.join(map(str, call))} " \
                f"{shape(mod, args)}"
        err, ms, plain_ms = compare(label, lambda: mod.launch(*args),
                                    lambda: plain(mod, args), reps=3)
        errors[name] = max(errors.get(name, 0), err)
        if report:
            timings[name] = (ms, plain_ms)

    score_1k = ("align_score", 1000, "global")
    fulltb = ("align_full_tb", 10_000, "local")
    score_100k = ("align_score", 100_000, "local")
    hb = ("align", 100_000, "semiglobal")
    k1_hb = min(kept_of(hb, wavefront),
                key=lambda args: args[1].numel() * args[2].numel())
    k3_hb = max(kept_of(hb, walk), key=lambda args: args[1].shape[0])
    k4_hb = kept_of(hb, lastcols)
    run("wavefront_score", "K1", score_1k, wavefront,
        kept_of(score_1k, wavefront)[0])
    run("wavefront_score", "K1", score_100k, wavefront,
        kept_of(score_100k, wavefront)[0], report=True)
    run("wavefront_score", "K1", hb, wavefront, k1_hb)
    run("wavefront_preds", "K2", fulltb, wavefront,
        kept_of(fulltb, wavefront)[0], report=True)
    run("walk", "K3", fulltb, walk, kept_of(fulltb, walk)[0], report=True)
    run("walk", "K3", hb, walk, k3_hb)
    run("lastcols", "K4", hb, lastcols, k4_hb[0], report=True)
    run("lastcols", "K4", hb, lastcols, k4_hb[-1])


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "anyseq_tpu_torch", "kernels",
                                      "csrc")):
        print("chip_smoke: no anyseq_tpu_torch/ beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    print(f"phase1 card: {smi}", flush=True)

    from anyseq_tpu_torch.kernels import _build

    build = _build.build()
    print(f"phase1 build: {build.path.name} in {build.seconds:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    rng = np.random.default_rng(SEED)
    timings, errors, kept = {}, {}, []
    phase2(rng, errors)
    counts = phase3(rng, kept)
    phase3_small(rng)
    phase4(kept, timings, errors)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errors[name],
         "ms": round(timings[name][0], 4),
         "plain_ms": round(timings[name][1], 2)}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
