// K8 affine: one band of rows of the single-pair affine-gap (Gotoh) DP
// from an explicit boundary -- the affine unit of the chained sweep, which
// scores genome-length queries and Myers-Miller halves of any height in
// bounded memory. K10 affine: the same band over one rank's stripe of
// columns, with the H and E boundary columns handed across ranks as in
// band.cu.
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

using band_affine_core::LANES;
using band_affine_core::WARPS;

template <bool LOCAL>
__global__ void __launch_bounds__(LANES * WARPS)
    band_affine_kernel(BandAffine B) {
  __shared__ band_affine_core::WarpSharedAffine sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= B.workers) return;
  for (;;) {
    const int k = band_affine_core::claim(B.ticket);
    if (k >= B.strips) return;
    if (k + 1 < B.strips)
      band_affine_core::sweep_strip<LOCAL, false>(B, k, sh[warp]);
    else
      band_affine_core::sweep_strip<LOCAL, true>(B, k, sh[warp]);
  }
}

template <bool LOCAL>
int grid_of(int h, int strips, int share, int max_grid) {
  return band_core::grid_of((const void*)band_affine_kernel<LOCAL>, h,
                            strips, share, max_grid);
}

template <bool LOCAL>
int launch(BandAffine B, int share, int max_grid, void* stream) {
  B.workers = grid_of<LOCAL>(B.h, B.strips, share, max_grid);
  ANYSEQ_LAUNCH(band_affine_kernel<LOCAL>, (B.workers + WARPS - 1) / WARPS,
                LANES * WARPS, stream, B);
  return (int)cudaGetLastError();
}

int strips_of(int n) {
  return (n + band_affine_core::STRIP - 1) / band_affine_core::STRIP;
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
                     (const int*)cole_in, halo,
                     strips_of(n),       0,
                     (int*)ticket,       (int*)bcols,
                     (int*)bcols_e,      (int*)flags,
                     (int*)row_out,      (int*)rowf_out,
                     (int*)last_col,     (int*)last_col_e,
                     (int*)bests};
  return mode == MODE_LOCAL ? launch<true>(B, share, max_grid, stream)
                            : launch<false>(B, share, max_grid, stream);
}

// The warps anyseq_band_affine launches for a band of h rows and n
// columns in `mode` with these `share` and `max_grid`, on the current
// card.
extern "C" int anyseq_band_affine_grid(int h, int n, int mode, int share,
                                       int max_grid) {
  const int strips = strips_of(n);
  return mode == MODE_LOCAL ? grid_of<true>(h, strips, share, max_grid)
                            : grid_of<false>(h, strips, share, max_grid);
}

// Columns a strip (kernels/band.py AFFINE_STRIP, which sizes the scratch
// and is checked against this when the library loads).
extern "C" int anyseq_band_affine_strip() { return band_affine_core::STRIP; }
