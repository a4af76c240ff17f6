// K8 affine: one band of rows of the single-pair affine-gap (Gotoh) DP
// from an explicit boundary -- the affine unit of the chained sweep, which
// scores genome-length queries and Myers-Miller halves of any height in
// bounded memory. K10 affine: the same band over one rank's stripe of
// columns, with the H and E boundary columns handed across ranks as in
// band.cu. K5 (anyseq_sweep_affine): a whole single-pair affine score
// sweep (with the Myers-Miller start_gap boundary and the E last column)
// as one band of this kernel from the sweep's closed-form boundary, at
// the width K1's rule chooses -- the port of _score_padded's affine score
// sweep, which the first design swept on sweep_affine.cuh's CTA strips
// (wavefront_affine.cu keeps them for K5p, the sweep with codes).
//
// Replaces the affine variant of the JAX package's Pallas kernel
// anyseq_tpu/kernels/band.py _score_band_padded (boundary mode with rowf2
// and cole2, band.py:1443) as reached from score_pair_chained (K8), and
// its collective mode (K10), where the E-column halo rides a second remote
// DMA channel and each chip keeps its own F row
// (anyseq_tpu/dist/collective.py:22-24, 246-295).
//
// Contract (that of engine/affine.py score_band_affine, its plain
// version): rows [i0, i0 + h) relaxed from the top rows H and F of row
// i0 - 1, the corner H[i0-1][-1] and the left columns H and E of column
// -1; out come the bottom rows H and F of row i0 + h - 1 (into buffers
// apart from the top rows), the last columns H and E of column n - 1 and
// per strip the first maximum (score, i, j), i from the top of the band.
// A Myers-Miller start_gap band is a matter of the inputs alone. K10
// (kernels/band.py plain_collective_affine): the left H and E columns
// come from the halo (halo_in, halo_in_e), the corner from corner_ptr
// where given, and the last H and E columns also go to the right rank's
// halo, as in band.cu.
//
// What bounds it on an H100: the dependent int32 chain of E along each
// row (one max-plus a column on it) and the integer pipe that runs the
// rest of the cell (7 instructions a cell, a max-plus counted as one, and
// 0.5 more for LOCAL's best: the count PERF.md's bound takes; 11
// operations in the plain recurrence); memory traffic is O(n + h).
// The scratch boundary columns (H and E) hold 2 * (strips - 1) * h ints,
// the bound on memory that lets a chain of bands run any height.
//
// The first design ran K5's strip core (sweep_affine.cuh: 64 threads x 16
// columns a CTA, a CTA barrier and a shared-memory hand-off of three
// values a step, a compare and three selects a cell for the best,
// publish every 64 rows, every resident CTA launched), and the H form of
// E, which puts three dependent operations a column on the row chain: a
// 262,144 x 1,000,065 local band took 606.8 ms on an H100 80GB HBM3 at
// 700 W, 28.4% of its bound (PERF.md). This one runs K8's warp strip
// design (band.cu, band_sweep.cuh) on the affine core of
// band_sweep_affine.cuh, whose row chain is E's T form alone, with 16
// columns a lane (512-column strips), and chooses its grid by K8's rule
// (band_sweep.cuh grid_of) from its own CTAs an SM: that band takes
// 290-305 ms (PERF.md).
//
// K10 affine is K8 affine with the halo pointers set, as in band.cu: its
// ranks run concurrently, `share` ranks on one card split its warps, and
// ranks on other cards hand the H and E columns through peer access with
// system-scope fences and uncached reads. The corner of band b > 0 is the
// halo's row i0 - 1.
#include "band_sweep_affine.cuh"

using namespace anyseq;
using band_affine_core::BandAffine;
using band_affine_core::HaloAffine;

namespace {

using band_affine_core::BandGeom;
using band_core::Form;
using band_affine_core::LANES;
using band_affine_core::WARPS;
// K5's narrow strips: two rows a lane a step (one ran 10-13% slower at 8
// and 4 columns a lane, PERF.md).
template <int LANE_COLS>
using SweepGeom = band_core::Geom<LANE_COLS, 2>;

template <bool LOCAL, class G, bool CLOSED>
__global__ void __launch_bounds__(LANES * WARPS)
    band_affine_kernel(BandAffine B) {
  __shared__ band_affine_core::WarpSharedAffine<G> sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= B.workers) return;
  for (;;) {
    const int k = band_affine_core::claim(B.ticket);
    if (k >= B.strips) return;
    if (k + 1 < B.strips)
      band_affine_core::sweep<LOCAL, false, G, CLOSED>(B, k, sh[warp]);
    else
      band_affine_core::sweep<LOCAL, true, G, CLOSED>(B, k, sh[warp]);
  }
}

template <class G>
int strips_of(int n) { return (n + G::STRIP - 1) / G::STRIP; }

// CLOSED: K5 (the closed-form boundary of a whole sweep); else K8 affine /
// K10 affine.
template <bool LOCAL, class G, bool CLOSED>
int grid_of(int h, int n, int share, int max_grid) {
  return band_core::grid_of(
      (const void*)band_affine_kernel<LOCAL, G, CLOSED>,
      (h + G::ROWS - 1) / G::ROWS, strips_of<G>(n), share, max_grid, G::LAG);
}

template <bool LOCAL, class G, bool CLOSED>
int launch(BandAffine B, int share, int max_grid, void* stream) {
  B.strips = strips_of<G>(B.n);
  B.workers = grid_of<LOCAL, G, CLOSED>(B.h, B.n, share, max_grid);
  auto kernel = band_affine_kernel<LOCAL, G, CLOSED>;
  ANYSEQ_LAUNCH(kernel, (B.workers + WARPS - 1) / WARPS, LANES * WARPS,
                stream, B);
  return (int)cudaGetLastError();
}

// f(Form<...>{}) for one of K5's widths (= kernels/band.py AFFINE_WIDTHS),
// or `bad` for another: 16 columns a lane is K8 affine's own kernel (one
// row a step) on the sweep's boundary tensors (two rows a step ran no
// faster there, and the closed form 10% slower, PERF.md); 8 and 4 the
// closed form, two rows a lane a step.
template <class F>
int with_width(int lane_cols, int bad, F f) {
  switch (lane_cols) {
    case 16: return f(Form<BandGeom, false>{});
    case 8: return f(Form<SweepGeom<8>, true>{});
    case 4: return f(Form<SweepGeom<4>, true>{});
    default: return bad;
  }
}

template <bool LOCAL, class Fm>
band_core::Width width(Fm) {
  using G = typename Fm::G;
  return {G::LANE_COLS,
          (const void*)band_affine_kernel<LOCAL, G, Fm::CLOSED>, G::ROWS,
          G::LAG};
}

// K5's width rule (band_sweep.cuh width_of, K1's) over its widths.
template <bool LOCAL>
int sweep_width(int h, int n) {
  band_core::Width widths[3];
  for (int w = 0; w < 3; ++w)
    with_width(16 >> w, 0, [&](auto fm) {
      widths[w] = width<LOCAL>(fm);
      return 0;
    });
  return band_core::width_of(widths, 3, h, n);
}

}  // namespace

// Inputs: q (h bytes), s (n bytes), row_in and rowf_in (n ints each),
// col_in and cole_in (h ints each; null when halo_in is given), corner
// (used where corner_ptr is null). K10: halo_in / halo_in_e and halo_out /
// halo_out_e (h ints each) with one flag each, or null. Scratch the caller
// allocates: ticket (1 int, zeroed), flags (strips ints, zeroed), bcols
// and bcols_e ((strips - 1) * h ints each); outputs row_out and rowf_out
// (n ints each, not the inputs), last_col and last_col_e (h each), bests
// (3 * strips). `share`: launches that must be resident together (1 for
// K8 affine); `max_grid` > 0 caps the warps.
extern "C" int anyseq_band_affine(
    const void* q, int h, const void* s, int n, int match, int mismatch,
    int gap_open, int gap_extend, int mode, const void* row_in,
    const void* rowf_in, int corner, const void* corner_ptr,
    const void* col_in, const void* cole_in, const void* halo_in,
    const void* halo_in_e, const void* halo_in_flag, void* halo_out,
    void* halo_out_e, void* halo_out_flag, int sys_in, int sys_out, int share,
    int max_grid, void* ticket, void* bcols, void* bcols_e, void* flags,
    void* row_out, void* rowf_out, void* last_col, void* last_col_e,
    void* bests, void* stream) {
  const HaloAffine halo{(const int*)halo_in,      (const int*)halo_in_e,
                        (const int*)halo_in_flag, (int*)halo_out,
                        (int*)halo_out_e,         (int*)halo_out_flag,
                        (const int*)corner_ptr,   sys_in != 0,
                        sys_out != 0};
  const BandAffine B{(const uint8_t*)q,  h,
                     (const uint8_t*)s,  n,
                     match,              mismatch,
                     gap_open,           gap_extend,
                     (const int*)row_in, (const int*)rowf_in,
                     corner,             (const int*)col_in,
                     (const int*)cole_in, 0,
                     0,                  0,
                     0,                  halo,
                     0,                  0,
                     (int*)ticket,       (int*)bcols,
                     (int*)bcols_e,      (int*)flags,
                     (int*)row_out,      (int*)rowf_out,
                     (int*)last_col,     (int*)last_col_e,
                     (int*)bests};
  return mode == MODE_LOCAL
             ? launch<true, BandGeom, false>(B, share, max_grid, stream)
             : launch<false, BandGeom, false>(B, share, max_grid, stream);
}

// The warps anyseq_band_affine launches for a band of h rows and n
// columns in `mode` with these `share` and `max_grid`, on the current
// card.
extern "C" int anyseq_band_affine_grid(int h, int n, int mode, int share,
                                       int max_grid) {
  return mode == MODE_LOCAL
             ? grid_of<true, BandGeom, false>(h, n, share, max_grid)
             : grid_of<false, BandGeom, false>(h, n, share, max_grid);
}

// Columns a strip (kernels/band.py AFFINE_STRIP, which sizes the scratch
// and is checked against this when the library loads).
extern "C" int anyseq_band_affine_strip() { return BandGeom::STRIP; }

// K5: the single-pair affine score sweep of an h-row query against an
// n-column subject in `mode`, run as one band from the sweep's
// closed-form boundary (engine/affine.py top_row_affine and
// left_col_affine at row 0, the Myers-Miller one under `start_gap`) at
// `lane_cols` columns a lane, one of K5's widths
// (anyseq_sweep_affine_width's choice, or one a caller forces): at 16,
// K8 affine's kernel reads that boundary from row_in and rowf_in (n ints
// each), col_in and cole_in (h ints each); narrower, the kernel computes
// it (those unread). Scratch and outputs as anyseq_band_affine's, with
// strips of 32 * lane_cols columns; `max_grid` > 0 caps the warps.
// Another width, or no boundary tensors at 16: cudaErrorInvalidValue.
extern "C" int anyseq_sweep_affine(
    const void* q, int h, const void* s, int n, int match, int mismatch,
    int gap_open, int gap_extend, int mode, int start_gap, int lane_cols,
    const void* row_in, const void* rowf_in, const void* col_in,
    const void* cole_in, int max_grid, void* ticket, void* bcols,
    void* bcols_e, void* flags, void* row_out, void* rowf_out,
    void* last_col, void* last_col_e, void* bests, void* stream) {
  const bool global = mode == MODE_GLOBAL, sg = global && start_gap != 0;
  const int neg = band_affine_core::NEG;
  const BandAffine B{(const uint8_t*)q,  h,
                     (const uint8_t*)s,  n,
                     match,              mismatch,
                     gap_open,           gap_extend,
                     (const int*)row_in, (const int*)rowf_in,
                     sg ? neg : 0,       (const int*)col_in,
                     (const int*)cole_in, global && !sg ? gap_open : 0,
                     global ? gap_extend : 0,
                     global ? (sg ? neg : gap_open) : 0,
                     global && !sg ? gap_extend : 0,
                     HaloAffine{},
                     0,                  0,
                     (int*)ticket,       (int*)bcols,
                     (int*)bcols_e,      (int*)flags,
                     (int*)row_out,      (int*)rowf_out,
                     (int*)last_col,     (int*)last_col_e,
                     (int*)bests};
  const int bad = (int)cudaErrorInvalidValue;
  return with_width(lane_cols, bad, [&](auto fm) {
    using Fm = decltype(fm);
    using G = typename Fm::G;
    if (!Fm::CLOSED && !(row_in && rowf_in && col_in && cole_in)) return bad;
    return mode == MODE_LOCAL
               ? launch<true, G, Fm::CLOSED>(B, 1, max_grid, stream)
               : launch<false, G, Fm::CLOSED>(B, 1, max_grid, stream);
  });
}

// The columns a lane K5 sweeps an h x n pair at in `mode` on the current
// card (band_sweep.cuh width_of).
extern "C" int anyseq_sweep_affine_width(int h, int n, int mode) {
  return mode == MODE_LOCAL ? sweep_width<true>(h, n)
                            : sweep_width<false>(h, n);
}

// The warps anyseq_sweep_affine launches for an h x n pair in `mode` at
// `lane_cols` columns a lane (-1 for a width K5 does not have).
extern "C" int anyseq_sweep_affine_grid(int h, int n, int mode,
                                        int lane_cols) {
  return with_width(lane_cols, -1, [&](auto fm) {
    using Fm = decltype(fm);
    using G = typename Fm::G;
    return mode == MODE_LOCAL ? grid_of<true, G, Fm::CLOSED>(h, n, 1, 0)
                              : grid_of<false, G, Fm::CLOSED>(h, n, 1, 0);
  });
}
