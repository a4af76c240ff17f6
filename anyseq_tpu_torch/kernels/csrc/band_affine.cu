// K8 affine: one band of rows of the single-pair affine-gap (Gotoh) DP
// from an explicit boundary -- the affine unit of the chained sweep, which
// scores genome-length queries and Myers-Miller halves of any height in
// bounded memory.
//
// Replaces the affine variant of the JAX package's Pallas kernel
// anyseq_tpu/kernels/band.py _score_band_padded (boundary mode with rowf2
// and cole2, band.py:1443) as reached from score_pair_chained.
//
// Contract (that of engine/affine.py score_band_affine, its plain
// version): rows [i0, i0 + h) relaxed from the top rows H and F of row
// i0 - 1, the corner H[i0-1][-1] and the left columns H and E of column
// -1; out come the bottom rows H and F of row i0 + h - 1 (into buffers
// apart from the top rows), the last columns H and E of column n - 1 and
// per strip the first maximum (score, i, j), i from the top of the band.
// A Myers-Miller start_gap band is a matter of the inputs alone.
//
// What bounds it on an H100: as K5, the dependent int32 chain of the
// Gotoh recurrence (11 operations a cell), and latency; memory traffic is
// O(n + h). The scratch boundary columns (H and E) hold 2 * (strips - 1)
// * h ints, the bound on memory that lets a chain of bands run any height.
//
// Design: K5's (sweep_affine.cuh), with the explicit boundary of band.cu;
// `max_grid` caps the CTAs (0: as many as fit on the card).
#include "sweep_affine.cuh"

using namespace anyseq;

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    band_affine_kernel(const uint8_t* q, int h, const uint8_t* s, int n,
                       AffineScoring sc, const int* row_in,
                       const int* rowf_in, int corner, const int* col_in,
                       const int* cole_in, int strips, int* ticket, int* bcols,
                       int* bcols_e, int* flags, int* row_out, int* rowf_out,
                       int* last_col, int* last_col_e, int* bests) {
  __shared__ SweepAffineShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= strips) return;
    StripAffine S;
    S.q = q;
    S.m = h;
    S.s = s;
    S.n = n;
    S.col0 = k * STRIP;
    S.global_init = false;
    S.start_gap = false;
    S.top = row_in;
    S.top_f = rowf_in;
    S.corner = corner;
    S.left_in = col_in;
    S.left_in_e = cole_in;
    S.left_h = k > 0 ? bcols + (size_t)(k - 1) * h : nullptr;
    S.left_e = k > 0 ? bcols_e + (size_t)(k - 1) * h : nullptr;
    S.left_flag = k > 0 ? flags + (k - 1) : nullptr;
    S.right_h = k + 1 < strips ? bcols + (size_t)k * h : nullptr;
    S.right_e = k + 1 < strips ? bcols_e + (size_t)k * h : nullptr;
    S.right_flag = flags + k;
    S.last_col = last_col;
    S.last_col_e = last_col_e;
    S.last_row = row_out;
    S.last_row_f = rowf_out;
    S.preds = nullptr;
    S.pred_stride = 0;
    S.best = bests + 3 * k;
    sweep_strip_affine<LOCAL, false, true>(S, sc, sh);
  }
}

template <bool LOCAL>
static int launch(const uint8_t* q, int h, const uint8_t* s, int n,
                  AffineScoring sc, const int* row_in, const int* rowf_in,
                  int corner, const int* col_in, const int* cole_in,
                  int max_grid, int* ticket, int* bcols, int* bcols_e,
                  int* flags, int* row_out, int* rowf_out, int* last_col,
                  int* last_col_e, int* bests, void* stream) {
  auto kernel = band_affine_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  int grid = imin(strips, resident_ctas((const void*)kernel, SWEEP_THREADS));
  if (max_grid > 0) grid = imin(grid, max_grid);
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, h, s, n, sc, row_in,
                rowf_in, corner, col_in, cole_in, strips, ticket, bcols,
                bcols_e, flags, row_out, rowf_out, last_col, last_col_e,
                bests);
  return (int)cudaGetLastError();
}

// Inputs: q (h bytes), s (n bytes), row_in and rowf_in (n ints each),
// col_in and cole_in (h ints each). Scratch the caller allocates: ticket
// (1 int, zeroed), flags (strips ints, zeroed), bcols and bcols_e
// ((strips - 1) * h ints each); outputs row_out and rowf_out (n ints each,
// not the inputs), last_col and last_col_e (h each), bests (3 * strips).
extern "C" int anyseq_band_affine(
    const void* q, int h, const void* s, int n, int match, int mismatch,
    int gap_open, int gap_extend, int mode, const void* row_in,
    const void* rowf_in, int corner, const void* col_in, const void* cole_in,
    int max_grid, void* ticket, void* bcols, void* bcols_e, void* flags,
    void* row_out, void* rowf_out, void* last_col, void* last_col_e,
    void* bests, void* stream) {
  const AffineScoring sc{match, mismatch, gap_open, gap_extend};
  auto* q8 = (const uint8_t*)q;
  auto* s8 = (const uint8_t*)s;
  auto* ri = (const int*)row_in;
  auto* rfi = (const int*)rowf_in;
  auto* ci = (const int*)col_in;
  auto* cei = (const int*)cole_in;
  auto* tk = (int*)ticket;
  auto* bc = (int*)bcols;
  auto* be = (int*)bcols_e;
  auto* fl = (int*)flags;
  auto* ro = (int*)row_out;
  auto* rfo = (int*)rowf_out;
  auto* lc = (int*)last_col;
  auto* lce = (int*)last_col_e;
  auto* bs = (int*)bests;
  if (mode == MODE_LOCAL)
    return launch<true>(q8, h, s8, n, sc, ri, rfi, corner, ci, cei, max_grid,
                        tk, bc, be, fl, ro, rfo, lc, lce, bs, stream);
  return launch<false>(q8, h, s8, n, sc, ri, rfi, corner, ci, cei, max_grid,
                       tk, bc, be, fl, ro, rfo, lc, lce, bs, stream);
}
