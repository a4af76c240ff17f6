// K8 affine: one band of rows of the single-pair affine-gap (Gotoh) DP
// from an explicit boundary -- the affine unit of the chained sweep, which
// scores genome-length queries and Myers-Miller halves of any height in
// bounded memory. K10 affine: the same band over one rank's stripe of
// columns, with the H and E boundary columns handed across ranks as in
// band.cu. K5 and K5p (anyseq_sweep_affine): a whole single-pair affine
// sweep (K5 score only, with the Myers-Miller start_gap boundary; both
// with the E last column) as one band of this kernel from the sweep's
// closed-form boundary, at the width K1's rule chooses; K5p also writes
// each cell's 4-bit code (the cores' OUT_CODES mode) -- the port of
// _score_padded's affine sweep, score only and with emit_preds, which the
// first design swept on 1024-column CTA strips.
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
// The first design ran a CTA strip core (64 threads x 16 columns a CTA,
// a CTA barrier and a shared-memory hand-off of three values a step, a
// compare and three selects a cell for the best, publish every 64 rows,
// every resident CTA launched), and the H form of
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

// The CTAs an SM that ptxas must leave registers for (__launch_bounds__'s
// second argument; 0: its own choice). Left to itself, ptxas held K5p's
// kernels at 16 columns a lane (one row a step, 64-bit code segments) to
// 96 registers and spilled 12 bytes, LOCAL or not; they ask for three, as
// K7's affine codes kernels do (swarm.cu MIN_CTAS).
template <class G, int CB>
constexpr int MIN_CTAS = CB != 0 && G::LANE_COLS == 16 ? 3 : 0;

// CB: the bits of a cell's code (4: K5p, OUT_CODES), or 0 (K5, K8
// affine, K10 affine).
template <bool LOCAL, class G, bool CLOSED, int CB = 0>
__global__ void __launch_bounds__(LANES * WARPS, MIN_CTAS<G, CB>)
    band_affine_kernel(BandAffine B) {
  constexpr int OUT = band_core::OUT_ALL | (CB ? band_core::OUT_CODES : 0);
  __shared__ band_affine_core::WarpSharedAffine<G, CB> sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= B.workers) return;
  for (;;) {
    const int k = band_affine_core::claim(B.ticket);
    if (k >= B.strips) return;
    if (k + 1 < B.strips)
      band_affine_core::sweep<LOCAL, false, G, CLOSED, OUT>(B, k, sh[warp]);
    else
      band_affine_core::sweep<LOCAL, true, G, CLOSED, OUT>(B, k, sh[warp]);
  }
}

template <class G>
int strips_of(int n) { return (n + G::STRIP - 1) / G::STRIP; }

// CLOSED: K5 / K5p (the closed-form boundary of a whole sweep); else K8
// affine / K10 affine.
template <bool LOCAL, class G, bool CLOSED, int CB = 0>
int grid_of(int h, int n, int share, int max_grid) {
  return band_core::grid_of(
      (const void*)band_affine_kernel<LOCAL, G, CLOSED, CB>,
      (h + G::ROWS - 1) / G::ROWS, strips_of<G>(n), share, max_grid, G::LAG);
}

template <bool LOCAL, class G, bool CLOSED, int CB = 0>
int launch(BandAffine B, int share, int max_grid, void* stream) {
  B.strips = strips_of<G>(B.n);
  B.workers = grid_of<LOCAL, G, CLOSED, CB>(B.h, B.n, share, max_grid);
  auto kernel = band_affine_kernel<LOCAL, G, CLOSED, CB>;
  ANYSEQ_LAUNCH(kernel, (B.workers + WARPS - 1) / WARPS, LANES * WARPS,
                stream, B);
  return (int)cudaGetLastError();
}

// f(Form<...>{}) for one of K5's widths (= kernels/band.py AFFINE_WIDTHS)
// or, with codes, of K5p's (the same widths), or `bad` for another. K5:
// 16 columns a lane is K8 affine's own kernel (one row a step) on the
// sweep's boundary tensors (two rows a step ran no faster there, and the
// closed form 10% slower, PERF.md); 8 and 4 the closed form, two rows a
// lane a step. K5p: the closed form with 4-bit codes at 16 (one row a
// step, 64-bit segments), 8 and 4 (two rows, 32- and 16-bit segments),
// K7's affine codes kernels.
template <bool CODES, class F>
int with_width(int lane_cols, int bad, F f) {
  constexpr int CB = CODES ? 4 : 0;
  switch (lane_cols) {
    case 16:
      if constexpr (CODES)
        return f(Form<band_core::Geom<16>, true, CB>{});
      else
        return f(Form<BandGeom, false>{});
    case 8: return f(Form<SweepGeom<8>, true, CB>{});
    case 4: return f(Form<SweepGeom<4>, true, CB>{});
    default: return bad;
  }
}

template <bool LOCAL, class K>
band_core::Width width(K) {
  using G = typename K::G;
  return {G::LANE_COLS,
          (const void*)band_affine_kernel<LOCAL, G, K::CLOSED, K::CB>,
          G::ROWS, G::LAG};
}

// A step of K5p (cycles, band_sweep.cuh StepCost), fitted to its device
// times at each width at 10k, 2,048 and 256 rows on an H100
// (tools/k1_ab.py --preds --sweep, PERF.md): a warp alone on its
// scheduler ~545 + 63 a column at one row a step (16 columns: ~1,550),
// ~950 + 100 at two (8: ~1,750, 4: ~1,350); each warp that shares it,
// K7's affine codes costs (swarm.cu STEP_AFFINE_*_CODES).
constexpr band_core::StepCost STEP_ONE_CODES{545, 63, 66, 29};
constexpr band_core::StepCost STEP_TWO_CODES{950, 100, 110, 53};

// K5's width rule (band_sweep.cuh width_of, K1's) over its kernels; K5p's,
// the level rule (band_sweep.cuh level_width) over its kernels on its own
// step costs, as K2's (band.cu).
template <bool LOCAL, bool CODES>
int sweep_width(int h, int n) {
  band_core::Width widths[3];
  band_core::StepCost costs[3];
  for (int w = 0; w < 3; ++w)
    with_width<CODES>(16 >> w, 0, [&](auto kind) {
      widths[w] = width<LOCAL>(kind);
      costs[w] = widths[w].rows == 2 ? STEP_TWO_CODES : STEP_ONE_CODES;
      return 0;
    });
  if (CODES)
    return band_core::level_width(widths, costs, 3, &h, &n, 1, 8,
                                  LLONG_MAX);
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

// K5 and K5p: the single-pair affine sweep of an h-row query against an
// n-column subject in `mode`, run as one band from the sweep's
// closed-form boundary (engine/affine.py top_row_affine and
// left_col_affine at row 0, the Myers-Miller one under `start_gap`) at
// `lane_cols` columns a lane, one of K5's widths or, with codes, of
// K5p's (anyseq_sweep_affine_width's choice, or one a caller forces): K5
// at 16 is K8 affine's kernel, which reads that boundary from row_in and
// rowf_in (n ints each), col_in and cole_in (h ints each); otherwise the
// kernel computes it (those unread). Scratch and outputs as
// anyseq_band_affine's, with strips of 32 * lane_cols columns;
// `max_grid` > 0 caps the warps. `codes` null: K5, score only; else K5p
// also writes cell (i, j)'s 4-bit code PH | PE << 2 | PF << 3 (the plain
// version's, engine/affine.py pack_codes4) in bits 4 * (j % 8) of word i
// * code_words + j / 8 (code_words >= ceil(n / 8)), a lane's codes of a
// row as one segment: a segment of columns past n - 1 is not stored, so
// the caller zeroes the row's last word where no lane's segment reaches
// its end. start_gap takes no codes. Another width, start_gap with codes,
// or no boundary tensors where read: cudaErrorInvalidValue.
extern "C" int anyseq_sweep_affine(
    const void* q, int h, const void* s, int n, int match, int mismatch,
    int gap_open, int gap_extend, int mode, int start_gap, int lane_cols,
    const void* row_in, const void* rowf_in, const void* col_in,
    const void* cole_in, int max_grid, void* ticket, void* bcols,
    void* bcols_e, void* flags, void* row_out, void* rowf_out,
    void* last_col, void* last_col_e, void* bests, void* codes,
    int code_words, void* stream) {
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
                     (int*)bests,        (unsigned*)codes,
                     code_words};
  const int bad = (int)cudaErrorInvalidValue;
  if (codes && start_gap) return bad;
  auto go = [&](auto kind) {
    using K = decltype(kind);
    using G = typename K::G;
    if (!K::CLOSED && !(row_in && rowf_in && col_in && cole_in)) return bad;
    return mode == MODE_LOCAL
               ? launch<true, G, K::CLOSED, K::CB>(B, 1, max_grid, stream)
               : launch<false, G, K::CLOSED, K::CB>(B, 1, max_grid, stream);
  };
  return codes ? with_width<true>(lane_cols, bad, go)
               : with_width<false>(lane_cols, bad, go);
}

// The columns a lane K5 (`codes` 0) or K5p sweeps an h x n pair at in
// `mode` on the current card (band_sweep.cuh width_of).
extern "C" int anyseq_sweep_affine_width(int h, int n, int mode,
                                         int codes) {
  const bool local = mode == MODE_LOCAL;
  if (codes)
    return local ? sweep_width<true, true>(h, n)
                 : sweep_width<false, true>(h, n);
  return local ? sweep_width<true, false>(h, n)
               : sweep_width<false, false>(h, n);
}

// The warps anyseq_sweep_affine launches for an h x n pair in `mode` at
// `lane_cols` columns a lane, with codes or not (-1 for a width K5 or
// K5p does not have).
extern "C" int anyseq_sweep_affine_grid(int h, int n, int mode,
                                        int lane_cols, int codes) {
  auto go = [&](auto kind) {
    using K = decltype(kind);
    using G = typename K::G;
    return mode == MODE_LOCAL
               ? grid_of<true, G, K::CLOSED, K::CB>(h, n, 1, 0)
               : grid_of<false, G, K::CLOSED, K::CB>(h, n, 1, 0);
  };
  return codes ? with_width<true>(lane_cols, -1, go)
               : with_width<false>(lane_cols, -1, go);
}
