// K3: the linear traceback walk over packed 2-bit predecessor codes,
// batched: one thread per problem.
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
// What bounds it on an H100: each step's address depends on the previous
// step's code, so a walk is a serial chain of dependent loads, about
// (m + n) load latencies long (L2 or device memory); no parallelism
// exists inside one walk. Design: one thread per walk and nothing else,
// so the batched stripes of a Hirschberg construction walk side by side;
// the codes are packed 16 to a word, so a walk that runs along a row
// reuses the word it just loaded from L1.
#include "common.cuh"

using namespace anyseq;

__global__ void walk_kernel(const uint32_t* preds, long long prob_words,
                            int row_words, const uint8_t* q, int q_stride,
                            const uint8_t* s, int s_stride, const int* ends,
                            int B, bool global_halo, uint8_t* out_q,
                            uint8_t* out_s, int out_stride, int* starts) {
  const int b = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const uint32_t* P = preds + (size_t)b * prob_words;
  const uint8_t* Q = q + (size_t)b * q_stride;
  const uint8_t* S = s + (size_t)b * s_stride;
  uint8_t* OQ = out_q + (size_t)b * out_stride;
  uint8_t* OS = out_s + (size_t)b * out_stride;
  int i = ends[2 * b];
  int j = ends[2 * b + 1];
  for (;;) {
    int code;
    if (i < 0 || j < 0) {
      code = !global_halo || (i < 0 && j < 0) ? PRED_NONE
             : i < 0                          ? PRED_GAP_Q
                                              : PRED_GAP_S;
    } else {
      code = (P[(size_t)i * row_words + (j >> 4)] >> (2 * (j & 15))) & 3;
    }
    if (code == PRED_NONE) break;
    const bool tq = code == PRED_NO_GAP || code == PRED_GAP_S;
    const bool ts = code == PRED_NO_GAP || code == PRED_GAP_Q;
    const int pos = i + j + 1;
    OQ[pos] = tq ? Q[i] : (uint8_t)GAP_SYM;
    OS[pos] = ts ? S[j] : (uint8_t)GAP_SYM;
    i -= tq;
    j -= ts;
  }
  starts[2 * b] = i + 1;
  starts[2 * b + 1] = j + 1;
}

extern "C" int anyseq_walk(const void* preds, long long prob_words,
                           int row_words, const void* q, int q_stride,
                           const void* s, int s_stride, const void* ends,
                           int B, int global_halo, void* out_q, void* out_s,
                           int out_stride, void* starts, void* stream) {
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  ANYSEQ_LAUNCH(walk_kernel, grid, threads, stream, (const uint32_t*)preds,
                prob_words, row_words, (const uint8_t*)q, q_stride,
                (const uint8_t*)s, s_stride, (const int*)ends, B,
                global_halo != 0, (uint8_t*)out_q, (uint8_t*)out_s,
                out_stride, (int*)starts);
  return (int)cudaGetLastError();
}
