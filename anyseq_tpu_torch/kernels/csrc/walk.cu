// K3: the linear traceback walk over packed 2-bit predecessor codes,
// batched: one warp a walk (walk_core.cuh).
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/engine/device_tb.py
// _walk_pallas (_make_walk_kernel), which walks the full-matrix traceback
// on the TPU's scalar core; here the same kernel also walks the
// Hirschberg terminal stripes, which the JAX package walks with the XLA
// scan engine/batch.py walk_batch_ends (the plain version of this kernel).
//
// Contract: problem b walks from ends[b] = (i, j) until a PRED_NONE code,
// writing the pair of cell (i, j) at position i + j + 1 of its rows of
// out_q / out_s (prefilled with ' ' by the caller; only live steps are
// written) and its start cell (i + 1, j + 1) to starts[b]. Halo cells:
// with global_halo, i < 0 gives PRED_GAP_Q, j < 0 PRED_GAP_S and both
// PRED_NONE; otherwise PRED_NONE. An end of (-1, -1) is a dead walk.
//
// What bounds it on an H100: the chain. Each step's address depends on
// the code the step before read, so a walk takes at least (its steps) x
// (the card's shortest dependent load, a shared load of ~34 cycles).
// Design (walk_core.cuh): one warp a walk steps over a window of 96 rows
// of codes staged in shared memory, each byte holding its move's offset
// in the window, so a step is a shared load and a subtraction; 16 steps
// go between tests, the next window's loads are issued 32 rows or
// columns ahead and unpacked in a later block's idle issue slots, and the
// lanes write the pairs 64 steps at a time from registers. The batched
// stripes and chunks of a construction or a batch walk a warp each, side
// by side.
#include "walk_core.cuh"

using namespace anyseq;

__global__ void __launch_bounds__(32)
    walk_kernel(const uint32_t* preds, long long prob_words, int row_words,
                const uint8_t* q, int q_stride, const uint8_t* s,
                int s_stride, const int* ends, bool global_halo,
                uint8_t* out_q, uint8_t* out_s, int out_stride,
                int* starts) {
  __shared__ walk_core::Smem smem;
  const int b = (int)blockIdx.x;
  walk_core::walk<false>(
      smem, preds + (size_t)b * prob_words, row_words,
      q + (size_t)b * q_stride, s + (size_t)b * s_stride, ends[2 * b],
      ends[2 * b + 1], 0, global_halo, out_q + (size_t)b * out_stride,
      out_s + (size_t)b * out_stride, starts + 2 * b);
}

extern "C" int anyseq_walk(const void* preds, long long prob_words,
                           int row_words, const void* q, int q_stride,
                           const void* s, int s_stride, const void* ends,
                           int B, int global_halo, void* out_q, void* out_s,
                           int out_stride, void* starts, void* stream) {
  ANYSEQ_LAUNCH(walk_kernel, B, 32, stream,
                (const uint32_t*)preds, prob_words, row_words,
                (const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                (const int*)ends, global_halo != 0, (uint8_t*)out_q,
                (uint8_t*)out_s, out_stride, (int*)starts);
  return (int)cudaGetLastError();
}
