// K5p: the single-pair affine-gap (Gotoh) DP sweep emitting packed 4-bit
// predecessor codes, for the full traceback. (K5, the same sweep score
// only, with the Myers-Miller start_gap boundary and the E last column,
// runs on the warp strip core: band_affine.cu anyseq_sweep_affine.)
//
// Replaces the affine variant of the JAX package's Pallas kernel
// anyseq_tpu/kernels/band.py _score_padded (the Gotoh H/E/F body with
// last_col_e and 4-bit preds) as reached from device_tb._fulltb_fused
// (emit_preds=True).
//
// Contract (that of engine/affine.py score_rows_affine_with_preds, its
// plain version): last_row = H[m-1][0..n), last_col = H[0..m)[n-1],
// last_col_e = E[0..m)[n-1], per strip the first maximum (score, i, j) in
// row-major order, which the wrapper reduces across strips in that same
// order, and word (i, j/8) of `preds` holding the codes of cells
// (i, j..j+7), four bits each: PH (diag > E > F, by the plain version's
// comparisons) in bits 0-1, PE-extends in bit 2, PF-extends in bit 3.
//
// What bounds it on an H100: as K2, the dependent integer max/add chain
// along anti-diagonals, now about six operations a cell instead of three,
// and latency, not memory (m*n/2 bytes of codes written once).
//
// Design: K2's (wavefront.cu, sweep.cuh). 1024-column strips claimed from
// a ticket counter, 64 threads x 16 columns in registers (H and F), one
// anti-diagonal step per barrier; the hand-off between threads and the
// strip boundary carry H and E, published every 64 rows through a flag.
#include "sweep_affine.cuh"

using namespace anyseq;

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    wavefront_affine_kernel(const uint8_t* q, int m, const uint8_t* s, int n,
                            AffineScoring sc, bool global_init, int strips,
                            int* ticket, int* bcols, int* bcols_e, int* flags,
                            int* last_row, int* last_col, int* last_col_e,
                            int* bests, uint32_t* preds, int pred_stride) {
  __shared__ SweepAffineShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= strips) return;
    StripAffine S;
    S.q = q;
    S.m = m;
    S.s = s;
    S.n = n;
    S.col0 = k * STRIP;
    S.global_init = global_init;
    S.start_gap = false;
    S.left_h = k > 0 ? bcols + (size_t)(k - 1) * m : nullptr;
    S.left_e = k > 0 ? bcols_e + (size_t)(k - 1) * m : nullptr;
    S.left_flag = k > 0 ? flags + (k - 1) : nullptr;
    S.right_h = k + 1 < strips ? bcols + (size_t)k * m : nullptr;
    S.right_e = k + 1 < strips ? bcols_e + (size_t)k * m : nullptr;
    S.right_flag = flags + k;
    S.last_col = last_col;
    S.last_col_e = last_col_e;
    S.last_row = last_row;
    S.preds = preds;
    S.pred_stride = pred_stride;
    S.best = bests + 3 * k;
    sweep_strip_affine<LOCAL>(S, sc, sh);
  }
}

template <bool LOCAL>
static int launch(const uint8_t* q, int m, const uint8_t* s, int n,
                  AffineScoring sc, bool global_init, int* ticket, int* bcols,
                  int* bcols_e, int* flags, int* last_row, int* last_col,
                  int* last_col_e, int* bests, uint32_t* preds,
                  int pred_stride, void* stream) {
  auto kernel = wavefront_affine_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  const int grid =
      imin(strips, resident_ctas((const void*)kernel, SWEEP_THREADS));
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, m, s, n, sc,
                global_init, strips, ticket, bcols, bcols_e, flags, last_row,
                last_col, last_col_e, bests, preds, pred_stride);
  return (int)cudaGetLastError();
}

// Scratch the caller allocates: ticket (1 int, zeroed), flags (strips
// ints, zeroed), bcols and bcols_e ((strips - 1) * m ints each); outputs
// last_row (n), last_col (m), last_col_e (m), bests (3 * strips) and preds
// (m * pred_stride words, pred_stride = ceil(n / 8)).
extern "C" int anyseq_wavefront_affine(
    const void* q, int m, const void* s, int n, int match, int mismatch,
    int gap_open, int gap_extend, int mode, void* ticket, void* bcols,
    void* bcols_e, void* flags, void* last_row, void* last_col,
    void* last_col_e, void* bests, void* preds, int pred_stride,
    void* stream) {
  const AffineScoring sc{match, mismatch, gap_open, gap_extend};
  const bool global_init = mode == MODE_GLOBAL;
  auto* q8 = (const uint8_t*)q;
  auto* s8 = (const uint8_t*)s;
  auto* tk = (int*)ticket;
  auto* bc = (int*)bcols;
  auto* be = (int*)bcols_e;
  auto* fl = (int*)flags;
  auto* lr = (int*)last_row;
  auto* lcol = (int*)last_col;
  auto* lce = (int*)last_col_e;
  auto* bs = (int*)bests;
  auto* pr = (uint32_t*)preds;
  if (mode == MODE_LOCAL)
    return launch<true>(q8, m, s8, n, sc, global_init, tk, bc, be, fl, lr,
                        lcol, lce, bs, pr, pred_stride, stream);
  return launch<false>(q8, m, s8, n, sc, global_init, tk, bc, be, fl, lr,
                       lcol, lce, bs, pr, pred_stride, stream);
}
