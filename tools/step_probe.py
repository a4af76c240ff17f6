#!/usr/bin/env python3
"""What one step of the warp strip cores waits on, on one CUDA card.

    python3 tools/step_probe.py

Builds a small probe kernel with nvcc and runs it as one warp on an idle
card: the cycles (clock64) an instruction of a dependent chain takes, for
the max-plus of the cores' chain (``__viaddmax_s32``, VIADDMNMX), the
same written as an add and a max in separate PTX instructions, a
three-way max (``__vimax3_s32``), a plain add, the hand-off between
lanes (``__shfl_up_sync``), a shared-memory load, and a device-memory
load (``ld.global.cg``, past L1) that hits L2 (a pointer chase over 4 MB)
and one that misses it (over 1 Mi lines of 128 bytes spread across
2 GiB, 512 Ki loads a run from a new start each run) -- the steps of the
traceback walks K3 and K6 with their codes in shared memory, and as
they were before, in device memory; then the cycles an instruction
issues at when eight chains run side by side (throughput), for the
max-plus, the add and the select. Prints one line a measurement, and
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>

#define CHAIN(OP)                                                   \
  for (int i = 0; i < iters; ++i) {                                 \
    _Pragma("unroll") for (int u = 0; u < 16; ++u) { OP; }          \
  }

// kind: 0 VIADDMNMX chain, 1 add then max (two PTX instructions), 2 vimax3
// chain, 3 add chain, 4 shfl.up chain, 5 shared load chain, 6 and 7 a
// global load chain (ld.global.cg) over `chain` from index c; 10-12: eight
// independent chains of VIADDMNMX, add, select (throughput)
extern "C" __global__ void probe(int* out, long long* cycles, int b, int c,
                                 int iters, int kind, const int* chain) {
  __shared__ int ring[64];
  const int lane = threadIdx.x & 31;
  ring[lane] = (lane + 1) & 31;
  ring[lane + 32] = lane;
  __syncwarp();
  int x = lane + b, y = c;
  int v[8];
  for (int k = 0; k < 8; ++k) v[k] = x + k;
  const long long t0 = clock64();
  switch (kind) {
    case 0: CHAIN(x = __viaddmax_s32(x, b, y)); break;
    case 1:
      CHAIN(asm volatile("add.s32 %0, %0, %1;" : "+r"(x) : "r"(b));
            asm volatile("max.s32 %0, %0, %1;" : "+r"(x) : "r"(y)));
      break;
    case 2: CHAIN(x = __vimax3_s32(x, b, y)); break;
    case 3: CHAIN(asm volatile("add.s32 %0, %0, %1;" : "+r"(x) : "r"(b)));
      break;
    case 4: CHAIN(x = __shfl_up_sync(0xffffffffu, x, 1) + b); break;
    case 5: CHAIN(x = ring[x & 63]); break;
    case 6:
    case 7:
      x = c;
      CHAIN(x = __ldcg(chain + x));
      break;
    case 10:
      CHAIN(_Pragma("unroll") for (int k = 0; k < 8; ++k)
                v[k] = __viaddmax_s32(v[k], b, y));
      break;
    case 11:
      CHAIN(_Pragma("unroll") for (int k = 0; k < 8; ++k)
                asm volatile("add.s32 %0, %0, %1;" : "+r"(v[k]) : "r"(b)));
      break;
    case 12:
      CHAIN(_Pragma("unroll") for (int k = 0; k < 8; ++k)
                v[k] = v[k] == y ? b : v[(k + 1) & 7]);
      break;
  }
  const long long t1 = clock64();
  for (int k = 0; k < 8; ++k) x += v[k];
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

extern "C" int run(int* out, long long* cycles, int b, int c, int iters,
                   int kind, int warps, const int* chain) {
  probe<<<1, 32 * warps>>>(out, cycles, b, c, iters, kind, chain);
  return (int)cudaDeviceSynchronize();
}
"""

# (kind, name, operations a pass of the 16-deep unrolled body)
KINDS = ((0, "VIADDMNMX dependent", 16), (1, "add + max dependent", 16),
         (2, "VIMNMX3 dependent", 16), (3, "add dependent", 16),
         (4, "shfl.up dependent", 16), (5, "shared load dependent", 16),
         (6, "global load dependent, L2 hit", 16),
         (7, "global load dependent, L2 miss", 16),
         (10, "VIADDMNMX, 8 chains", 128), (11, "add, 8 chains", 128),
         (12, "select, 8 chains", 128))


# (ints between the chain's lines, lines) of the global load chains: 4 MB
# stays in L2 (50 MB); 1 Mi lines of 128 bytes (128 MB) over 2 GiB do not
CHAINS = {6: (32, 1 << 15), 7: (512, 1 << 20)}


def chain_of(kind: int):
    """A random cycle through CHAINS[kind]'s lines: entry line k holds the
    index of the next line's entry."""
    import torch

    stride, lines = CHAINS[kind]
    g = torch.Generator(device="cuda").manual_seed(kind)
    order = torch.randperm(lines, device="cuda", generator=g) * stride
    chain = torch.zeros(stride * lines, dtype=torch.int32, device="cuda")
    chain[order] = order.roll(-1).to(torch.int32)
    return chain


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from anyseq_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        lib = os.path.join(tmp, "probe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        lib, src], check=True)
        probe = ctypes.CDLL(lib)
        probe.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        out = torch.zeros(32, dtype=torch.int32, device="cuda")
        cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
        iters = 4096
        for kind, name, ops in KINDS:
            chain = chain_of(kind) if kind in CHAINS else None
            # the L2-miss chain: 512 Ki loads a run (more lines than L2
            # holds), from a new line each run
            n = 1 << 15 if kind == 7 else iters
            for warps in (1, 4) if kind >= 10 else (1,):
                best = None
                for run in range(3):
                    start = int(chain[CHAINS[kind][0] * 997 * run]) \
                        if chain is not None else 7
                    err = probe.run(out.data_ptr(), cycles.data_ptr(), -1,
                                    start, n, kind, warps,
                                    chain.data_ptr() if chain is not None
                                    else None)
                    if err:
                        raise RuntimeError(f"probe {name}: CUDA error {err}")
                    c = int(cycles.item())
                    best = c if best is None else min(best, c)
                print(f"step_probe {name} ({warps} warp{'s' * (warps > 1)} "
                      f"on one SM): {best / (n * ops):.2f} cycles an "
                      f"instruction", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
