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
// What bounds it on an H100: as K5, the dependent int32 chain of the
// Gotoh recurrence (11 operations a cell), and latency; memory traffic is
// O(n + h). The scratch boundary columns (H and E) hold 2 * (strips - 1)
// * h ints, the bound on memory that lets a chain of bands run any height.
//
// Design: K5's (sweep_affine.cuh), with the explicit boundary and the halo
// of band.cu; `max_grid` caps the CTAs (0: as many as fit on the card, or
// their share among the ranks on one card).
#include "sweep_affine.cuh"

using namespace anyseq;

namespace {

// The halo hand-off of one K10 affine launch (all null for K8 affine).
struct HaloAffine {
  const int* in;         // rows [i0, i0 + h) of the H column left of the stripe
  const int* in_e;       // and of the E column
  const int* in_flag;    // rows published in this band
  int* out;              // rows [i0, i0 + h) of the right rank's halo, H
  int* out_e;            // and E
  int* out_flag;
  const int* corner;     // H[i0-1][-1] on the device, or null
  bool sys_in, sys_out;  // across cards
};

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    band_affine_kernel(const uint8_t* q, int h, const uint8_t* s, int n,
                       AffineScoring sc, const int* row_in,
                       const int* rowf_in, int corner, const int* col_in,
                       const int* cole_in, HaloAffine halo, int strips,
                       int* ticket, int* bcols, int* bcols_e, int* flags,
                       int* row_out, int* rowf_out, int* last_col,
                       int* last_col_e, int* bests) {
  __shared__ SweepAffineShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= strips) return;
    const bool last = k + 1 == strips;
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
    S.corner_ptr = halo.corner;
    S.left_in = col_in;
    S.left_in_e = cole_in;
    S.left_h = k > 0 ? bcols + (size_t)(k - 1) * h : halo.in;
    S.left_e = k > 0 ? bcols_e + (size_t)(k - 1) * h : halo.in_e;
    S.left_flag = k > 0 ? flags + (k - 1) : halo.in_flag;
    S.left_sys = k == 0 && halo.sys_in;
    S.right_h = last ? halo.out : bcols + (size_t)k * h;
    S.right_e = last ? halo.out_e : bcols_e + (size_t)k * h;
    S.right_flag = last ? halo.out_flag : flags + k;
    S.right_sys = last && halo.sys_out;
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
int launch(const uint8_t* q, int h, const uint8_t* s, int n, AffineScoring sc,
           const int* row_in, const int* rowf_in, int corner,
           const int* col_in, const int* cole_in, HaloAffine halo, int share,
           int max_grid, int* ticket, int* bcols, int* bcols_e, int* flags,
           int* row_out, int* rowf_out, int* last_col, int* last_col_e,
           int* bests, void* stream) {
  auto kernel = band_affine_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  const int grid = strip_grid((const void*)kernel, SWEEP_THREADS, strips,
                              share, max_grid);
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, h, s, n, sc, row_in,
                rowf_in, corner, col_in, cole_in, halo, strips, ticket, bcols,
                bcols_e, flags, row_out, rowf_out, last_col, last_col_e,
                bests);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs: q (h bytes), s (n bytes), row_in and rowf_in (n ints each),
// col_in and cole_in (h ints each; null when halo_in is given), corner
// (used where corner_ptr is null). K10: halo_in / halo_in_e and halo_out /
// halo_out_e (h ints each) with one flag each, or null. Scratch the caller
// allocates: ticket (1 int, zeroed), flags (strips ints, zeroed), bcols
// and bcols_e ((strips - 1) * h ints each); outputs row_out and rowf_out
// (n ints each, not the inputs), last_col and last_col_e (h each), bests
// (3 * strips). `share`: launches that must be resident together.
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
  const AffineScoring sc{match, mismatch, gap_open, gap_extend};
  const HaloAffine halo{(const int*)halo_in,      (const int*)halo_in_e,
                        (const int*)halo_in_flag, (int*)halo_out,
                        (int*)halo_out_e,         (int*)halo_out_flag,
                        (const int*)corner_ptr,   sys_in != 0,
                        sys_out != 0};
  auto run = [&](auto kernel_launch) {
    return kernel_launch((const uint8_t*)q, h, (const uint8_t*)s, n, sc,
                         (const int*)row_in, (const int*)rowf_in, corner,
                         (const int*)col_in, (const int*)cole_in, halo, share,
                         max_grid, (int*)ticket, (int*)bcols, (int*)bcols_e,
                         (int*)flags, (int*)row_out, (int*)rowf_out,
                         (int*)last_col, (int*)last_col_e, (int*)bests,
                         stream);
  };
  return mode == MODE_LOCAL ? run(launch<true>) : run(launch<false>);
}
