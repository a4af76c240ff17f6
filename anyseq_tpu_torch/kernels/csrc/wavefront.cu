// K2: the single-pair linear-gap DP sweep emitting packed 2-bit
// predecessor codes, for the full traceback. (K1, the same sweep score
// only, runs on the warp strip core: band.cu anyseq_sweep.)
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/kernels/band.py
// _score_padded (closed-form _make_kernel body) as reached from
// device_tb._fulltb_fused (emit_preds=True).
//
// Contract (that of engine/linmem.py score_rows_with_preds, its plain
// version): last_row = H[m-1][0..n), last_col = H[0..m)[n-1], per strip
// the first maximum (score, i, j) in row-major order, which the wrapper
// reduces across strips in that same order, and word (i, j/16) of `preds`
// holding the codes of cells (i, j..j+15), two bits each, recovered by the
// comparisons of the plain version in its order (diag, then left, then up).
//
// What bounds it on an H100: the DP is a chain of dependent integer
// max/add operations, one anti-diagonal after another, and the codes,
// m*n/4 bytes written once; the O(m) boundary columns are small. So the
// bound is latency and parallelism: a single CTA leaves 131 of 132 SMs
// idle.
//
// Design: the subject is cut into 1024-column strips (sweep.cuh). Each CTA
// sweeps one strip top to bottom along anti-diagonals, 16 columns per
// thread in registers, and publishes its right boundary column to global
// memory every 64 rows; the CTA of the next strip starts as soon as the
// first rows arrive, so all strips run at once, each a few hundred steps
// behind its left neighbour. A CTA claims strips in increasing order
// from a ticket counter, and the grid never exceeds the CTAs that fit on
// the card at once, so every producer a CTA waits on is running.
#include "sweep.cuh"

using namespace anyseq;

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    wavefront_kernel(const uint8_t* q, int m, const uint8_t* s, int n,
                     Scoring sc, bool global_init, int strips, int* ticket,
                     int* bcols, int* flags, int* last_row, int* last_col,
                     int* bests, uint32_t* preds, int pred_stride) {
  __shared__ SweepShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= strips) return;
    Strip S;
    S.q = q;
    S.m = m;
    S.s = s;
    S.n = n;
    S.col0 = k * STRIP;
    S.global_init = global_init;
    S.left = k > 0 ? bcols + (size_t)(k - 1) * m : nullptr;
    S.left_flag = k > 0 ? flags + (k - 1) : nullptr;
    S.right = k + 1 < strips ? bcols + (size_t)k * m : nullptr;
    S.right_flag = flags + k;
    S.last_col = last_col;
    S.last_row = last_row;
    S.preds = preds;
    S.pred_stride = pred_stride;
    S.best = bests + 3 * k;
    sweep_strip<LOCAL>(S, sc, sh);
  }
}

template <bool LOCAL>
static int launch(const uint8_t* q, int m, const uint8_t* s, int n,
                  Scoring sc, bool global_init, int* ticket, int* bcols,
                  int* flags, int* last_row, int* last_col, int* bests,
                  uint32_t* preds, int pred_stride, void* stream) {
  auto kernel = wavefront_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  const int grid =
      imin(strips, resident_ctas((const void*)kernel, SWEEP_THREADS));
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, m, s, n, sc,
                global_init, strips, ticket, bcols, flags, last_row, last_col,
                bests, preds, pred_stride);
  return (int)cudaGetLastError();
}

// Scratch the caller allocates: ticket (1 int, zeroed), flags (strips
// ints, zeroed), bcols ((strips - 1) * m ints); outputs last_row (n),
// last_col (m), bests (3 * strips) and preds (m * pred_stride words,
// pred_stride = ceil(n / 16)).
extern "C" int anyseq_wavefront(const void* q, int m, const void* s, int n,
                                int match, int mismatch, int gap, int mode,
                                void* ticket, void* bcols, void* flags,
                                void* last_row, void* last_col, void* bests,
                                void* preds, int pred_stride, void* stream) {
  const Scoring sc{match, mismatch, gap};
  const bool global_init = mode == MODE_GLOBAL;
  auto* q8 = (const uint8_t*)q;
  auto* s8 = (const uint8_t*)s;
  auto* tk = (int*)ticket;
  auto* bc = (int*)bcols;
  auto* fl = (int*)flags;
  auto* lr = (int*)last_row;
  auto* lcol = (int*)last_col;
  auto* bs = (int*)bests;
  auto* pr = (uint32_t*)preds;
  if (mode == MODE_LOCAL)
    return launch<true>(q8, m, s8, n, sc, global_init, tk, bc, fl, lr, lcol,
                        bs, pr, pred_stride, stream);
  return launch<false>(q8, m, s8, n, sc, global_init, tk, bc, fl, lr, lcol,
                       bs, pr, pred_stride, stream);
}
