// K8: one band of rows of the single-pair linear-gap DP from an explicit
// boundary -- the unit of the chained sweep that scores queries of any
// length in bounded memory, and of the resumable scorer.
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/kernels/band.py
// _score_band_padded (boundary mode of _make_kernel, band.py:1443) as
// reached from score_pair_chained.
//
// Contract (that of engine/linmem.py score_band, its plain version): rows
// [i0, i0 + h) relaxed from the top row H[i0-1][0..n), the corner
// H[i0-1][-1] and the left column H[i0..i0+h)[-1]; out come the bottom row
// H[i0+h-1][0..n) (into a buffer apart from the top row), the last column
// H[i0..i0+h)[n-1] and per strip the first maximum (score, i, j), i from
// the top of the band, which the wrapper reduces in row-major order.
//
// What bounds it on an H100: as K1, the dependent int32 max/add chain
// along anti-diagonals (6 operations a cell), and latency; the band's
// memory traffic is its two rows and its columns, O(n + h). The scratch
// boundary columns between strips hold (strips - 1) * h ints, which is
// why a chain of bands keeps a genome-length query in bounded memory
// where one K1 sweep needs (strips - 1) * m.
//
// Design: K1's (sweep.cuh): 1024-column strips claimed in order from a
// ticket counter, 64 threads x 16 columns in registers, boundary columns
// published every 64 rows. A strip's first row waits for its left
// neighbour's first 64 rows, so a band pays a fill of about 64 * strips
// steps before every strip runs. `max_grid` caps the CTAs (0: as many as
// fit on the card), so the tests can run fewer CTAs than strips.
#include "sweep.cuh"

using namespace anyseq;

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    band_kernel(const uint8_t* q, int h, const uint8_t* s, int n, Scoring sc,
                const int* row_in, int corner, const int* col_in, int strips,
                int* ticket, int* bcols, int* flags, int* row_out,
                int* last_col, int* bests) {
  __shared__ SweepShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= strips) return;
    Strip S;
    S.q = q;
    S.m = h;
    S.s = s;
    S.n = n;
    S.col0 = k * STRIP;
    S.global_init = false;
    S.top = row_in;
    S.corner = corner;
    S.left_in = col_in;
    S.left = k > 0 ? bcols + (size_t)(k - 1) * h : nullptr;
    S.left_flag = k > 0 ? flags + (k - 1) : nullptr;
    S.right = k + 1 < strips ? bcols + (size_t)k * h : nullptr;
    S.right_flag = flags + k;
    S.last_col = last_col;
    S.last_row = row_out;
    S.preds = nullptr;
    S.pred_stride = 0;
    S.best = bests + 3 * k;
    sweep_strip<LOCAL, false, true>(S, sc, sh);
  }
}

template <bool LOCAL>
static int launch(const uint8_t* q, int h, const uint8_t* s, int n,
                  Scoring sc, const int* row_in, int corner, const int* col_in,
                  int max_grid, int* ticket, int* bcols, int* flags,
                  int* row_out, int* last_col, int* bests, void* stream) {
  auto kernel = band_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  int grid = imin(strips, resident_ctas((const void*)kernel, SWEEP_THREADS));
  if (max_grid > 0) grid = imin(grid, max_grid);
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, h, s, n, sc, row_in,
                corner, col_in, strips, ticket, bcols, flags, row_out,
                last_col, bests);
  return (int)cudaGetLastError();
}

// Inputs: q (h bytes), s (n bytes), row_in (n ints), col_in (h ints).
// Scratch the caller allocates: ticket (1 int, zeroed), flags (strips
// ints, zeroed), bcols ((strips - 1) * h ints); outputs row_out (n ints,
// not row_in), last_col (h), bests (3 * strips).
extern "C" int anyseq_band(const void* q, int h, const void* s, int n,
                           int match, int mismatch, int gap, int mode,
                           const void* row_in, int corner, const void* col_in,
                           int max_grid, void* ticket, void* bcols,
                           void* flags, void* row_out, void* last_col,
                           void* bests, void* stream) {
  const Scoring sc{match, mismatch, gap};
  auto* q8 = (const uint8_t*)q;
  auto* s8 = (const uint8_t*)s;
  auto* ri = (const int*)row_in;
  auto* ci = (const int*)col_in;
  auto* tk = (int*)ticket;
  auto* bc = (int*)bcols;
  auto* fl = (int*)flags;
  auto* ro = (int*)row_out;
  auto* lc = (int*)last_col;
  auto* bs = (int*)bests;
  if (mode == MODE_LOCAL)
    return launch<true>(q8, h, s8, n, sc, ri, corner, ci, max_grid, tk, bc,
                        fl, ro, lc, bs, stream);
  return launch<false>(q8, h, s8, n, sc, ri, corner, ci, max_grid, tk, bc,
                       fl, ro, lc, bs, stream);
}
