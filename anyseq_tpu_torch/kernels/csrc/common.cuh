// Helpers shared by the anyseq_tpu_torch kernels.
//
// Built by nvcc for sm_90a (see kernels/_build.py). With ANYSEQ_HOST_EMU
// defined, the same sources compile as plain C++ against host_emu.h, which
// runs each CTA's threads as host threads; the tests use that build to
// check the kernels' index arithmetic on a machine without a GPU.
#pragma once

#include <stdint.h>

#ifdef ANYSEQ_HOST_EMU
#include "host_emu.h"
#else
#include <cuda_runtime.h>
#define ANYSEQ_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

namespace anyseq {

constexpr int PRED_NONE = 0;
constexpr int PRED_GAP_Q = 1;
constexpr int PRED_GAP_S = 2;
constexpr int PRED_NO_GAP = 3;

constexpr int MODE_GLOBAL = 0;
constexpr int MODE_SEMIGLOBAL = 1;
constexpr int MODE_LOCAL = 2;

constexpr int SCORE_MIN = -2147483647;
constexpr char GAP_SYM = '_';

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Hand-off between CTAs. The producer writes its values, then raises a
// progress flag; __threadfence() orders the two for every other CTA of
// the card. `sys`: producer and consumer run on different cards (the
// collective sweep's halo, read through peer access), and the fences are
// system-wide.
__device__ __forceinline__ void publish(int* flag, int value, bool sys = false) {
  if (sys)
    __threadfence_system();
  else
    __threadfence();
  *(volatile int*)flag = value;
}

// The consumer spins until the flag reaches `value`; its later reads of
// the producer's values must bypass L1 (load_cg), which is not coherent,
// or (sys) every cache of the card (load_sys). A producer on the card
// never lags by more than a band's sweep (seconds at genome length), so
// a wait of 2^34 cycles (~9 s) means a broken schedule: trap, and the
// launch fails instead of hanging the card.
__device__ __forceinline__ void wait_for(const int* flag, int value,
                                         bool sys = false) {
#ifdef ANYSEQ_HOST_EMU
  (void)sys;
  emu_check_published(*(const volatile int*)flag, value);
#else
  const long long start = clock64();
  while (*(const volatile int*)flag < value) {
    __nanosleep(32);
    if (clock64() - start > (1ll << 34)) __trap();
  }
  if (sys)
    __threadfence_system();
  else
    __threadfence();
#endif
}

__device__ __forceinline__ int load_cg(const int* p) { return __ldcg(p); }
__device__ __forceinline__ int load_sys(const int* p) { return *(const volatile int*)p; }

}  // namespace anyseq
