// K6: the affine (Gotoh) 3-state traceback walk over packed 4-bit
// predecessor codes, batched: one warp a walk (walk_core.cuh).
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
// (the start-gap flag or j >= 1), PF = 0; j < 0 gives PH = GAP_S, PE =
// 0, PF = (i >= 1); both negative stops. Without global_halo a halo cell
// stops. The start-gap flag changes no output (on row -1 E and H both
// move left), so the kernel does not take it.
//
// What bounds it on an H100: as K3, the chain of dependent loads, one a
// step. Design: K3's (walk_core.cuh) over 4-bit codes, one a byte in the
// window with a mark (0x30) that zero bytes lack; the state rides beside
// the window address: its move (or PH in H) masked by the mark, the
// offset from the move, four operations on the chain where K3 has one;
// the run goes on while PE / PF says so, off the chain.
#include "walk_core.cuh"

using namespace anyseq;

__global__ void __launch_bounds__(32)
    walk_affine_kernel(const uint32_t* preds, long long prob_words,
                       int row_words, const uint8_t* q, int q_stride,
                       const uint8_t* s, int s_stride, const int* ends,
                       const uint8_t* egaps, bool global_halo,
                       uint8_t* out_q, uint8_t* out_s, int out_stride,
                       int* starts) {
  __shared__ walk_core::Smem smem;
  const int b = (int)blockIdx.x;
  walk_core::walk<true>(
      smem, preds + (size_t)b * prob_words, row_words,
      q + (size_t)b * q_stride, s + (size_t)b * s_stride, ends[2 * b],
      ends[2 * b + 1], egaps[b] ? walk_core::STATE_E : 0u, global_halo,
      out_q + (size_t)b * out_stride, out_s + (size_t)b * out_stride,
      starts + 2 * b);
}

// egaps: B bytes, 0 or 1.
extern "C" int anyseq_walk_affine(const void* preds, long long prob_words,
                                  int row_words, const void* q, int q_stride,
                                  const void* s, int s_stride, const void* ends,
                                  const void* egaps, int B, int global_halo,
                                  void* out_q, void* out_s, int out_stride,
                                  void* starts, void* stream) {
  ANYSEQ_LAUNCH(walk_affine_kernel, B, 32, stream,
                (const uint32_t*)preds, prob_words, row_words,
                (const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                (const int*)ends, (const uint8_t*)egaps, global_halo != 0,
                (uint8_t*)out_q, (uint8_t*)out_s, out_stride, (int*)starts);
  return (int)cudaGetLastError();
}
