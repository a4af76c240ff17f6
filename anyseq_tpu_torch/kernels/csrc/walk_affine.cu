// K6: the affine (Gotoh) 3-state traceback walk over packed 4-bit
// predecessor codes, batched: one thread per problem.
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/engine/device_tb.py
// _walk_affine_pallas (_make_walk_kernel_affine), which walks the affine
// full-matrix traceback on the TPU's scalar core; here the same kernel
// also walks the Myers-Miller terminal stripes, which the JAX package
// walks with the XLA scan engine/batch.py walk_batch_affine (the plain
// version of this kernel is its port).
//
// Contract: problem b walks from ends[b] = (i, j), in state E if
// egaps[b] (the path leaves the stripe inside a horizontal gap run) and
// in state H otherwise, writing the pair of cell (i, j) at position
// i + j + 1 of its rows of out_q / out_s (prefilled with ' ' by the
// caller; only live steps are written), and its start cell (i + 1, j + 1)
// to starts[b]. In state H the cell's PH picks the move (NO_GAP: diagonal;
// GAP_Q / GAP_S: the E / F step at the same cell; NONE: stop); an E or F
// step stays in its state while the cell's PE / PF bit says the run
// extends. Halo cells, with global_halo: i < 0 gives PH = GAP_Q, PE =
// (sgaps[b] or j >= 1), PF = 0; j < 0 gives PH = GAP_S, PE = 0, PF =
// (i >= 1); both negative stops. Without global_halo a halo cell stops.
//
// What bounds it on an H100: as K3, a serial chain of dependent loads,
// about (m + n) load latencies; one thread per walk, so the batched
// stripes of a construction walk side by side, and a walk along a row
// reuses the word it just loaded (8 codes a word).
#include "common.cuh"

using namespace anyseq;

__global__ void walk_affine_kernel(const uint32_t* preds, long long prob_words,
                                   int row_words, const uint8_t* q,
                                   int q_stride, const uint8_t* s, int s_stride,
                                   const int* ends, const uint8_t* sgaps,
                                   const uint8_t* egaps, int B, bool global_halo,
                                   uint8_t* out_q, uint8_t* out_s,
                                   int out_stride, int* starts) {
  const int b = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const uint32_t* P = preds + (size_t)b * prob_words;
  const uint8_t* Q = q + (size_t)b * q_stride;
  const uint8_t* S = s + (size_t)b * s_stride;
  uint8_t* OQ = out_q + (size_t)b * out_stride;
  uint8_t* OS = out_s + (size_t)b * out_stride;
  const bool sgap = sgaps[b] != 0;
  int i = ends[2 * b];
  int j = ends[2 * b + 1];
  int state = egaps[b] ? PRED_GAP_Q : PRED_NONE;  // NONE stands for H
  for (;;) {
    int ph, pe, pf;
    if (i < 0 || j < 0) {
      if (!global_halo || (i < 0 && j < 0)) break;
      ph = i < 0 ? PRED_GAP_Q : PRED_GAP_S;
      pe = i < 0 && (sgap || j >= 1);
      pf = j < 0 && i >= 1;
    } else {
      const uint32_t c = (P[(size_t)i * row_words + (j >> 3)] >> (4 * (j & 7))) & 15;
      ph = c & 3;
      pe = (c >> 2) & 1;
      pf = c >> 3;
    }
    const int eff = state == PRED_NONE ? ph : state;
    if (eff == PRED_NONE) break;
    const bool tq = eff == PRED_NO_GAP || eff == PRED_GAP_S;
    const bool ts = eff == PRED_NO_GAP || eff == PRED_GAP_Q;
    const int pos = i + j + 1;
    OQ[pos] = tq ? Q[imax(i, 0)] : (uint8_t)GAP_SYM;
    OS[pos] = ts ? S[imax(j, 0)] : (uint8_t)GAP_SYM;
    state = eff == PRED_GAP_Q && pe   ? PRED_GAP_Q
            : eff == PRED_GAP_S && pf ? PRED_GAP_S
                                      : PRED_NONE;
    i -= tq;
    j -= ts;
  }
  starts[2 * b] = i + 1;
  starts[2 * b + 1] = j + 1;
}

// sgaps, egaps: B bytes each, 0 or 1.
extern "C" int anyseq_walk_affine(const void* preds, long long prob_words,
                                  int row_words, const void* q, int q_stride,
                                  const void* s, int s_stride, const void* ends,
                                  const void* sgaps, const void* egaps, int B,
                                  int global_halo, void* out_q, void* out_s,
                                  int out_stride, void* starts, void* stream) {
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  ANYSEQ_LAUNCH(walk_affine_kernel, grid, threads, stream,
                (const uint32_t*)preds, prob_words, row_words,
                (const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                (const int*)ends, (const uint8_t*)sgaps, (const uint8_t*)egaps,
                B, global_halo != 0, (uint8_t*)out_q, (uint8_t*)out_s,
                out_stride, (int*)starts);
  return (int)cudaGetLastError();
}
