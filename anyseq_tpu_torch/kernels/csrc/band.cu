// K8: one band of rows of the single-pair linear-gap DP from an explicit
// boundary -- the unit of the chained sweep that scores queries of any
// length in bounded memory, and of the resumable scorer. K10: the same
// band over one rank's stripe of columns, handing its boundary columns to
// and from the neighbouring ranks as it runs -- the collective sweep that
// scores one pair over several devices (dist/collective.py).
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/kernels/band.py
// _score_band_padded (_make_kernel, band.py:1443): K8 its boundary mode as
// reached from score_pair_chained, K10 its collective mode
// (collective_axis=, reached from anyseq_tpu/dist/collective.py
// _stripe_bands :213), which streams each 128-row chunk of a stripe's
// right edge to the right-hand chip with remote DMA inside the kernel.
//
// Contract (that of engine/linmem.py score_band, its plain version): rows
// [i0, i0 + h) relaxed from the top row H[i0-1][0..n), the corner
// H[i0-1][-1] and the left column H[i0..i0+h)[-1]; out come the bottom row
// H[i0+h-1][0..n) (into a buffer apart from the top row), the last column
// H[i0..i0+h)[n-1] and per strip the first maximum (score, i, j), i from
// the top of the band, which the wrapper reduces in row-major order. K10
// (kernels/band.py plain_collective): the left column comes from the halo
// `halo_in` (rows [i0, i0 + h) of the column left of the stripe, raised
// per 64 rows in `halo_in_flag` by the rank on the left), the corner from
// `corner_ptr` (that halo's row i0 - 1, published in the band before) where
// given, and the last column also goes to `halo_out` for the rank on the
// right, raising `halo_out_flag`. Each band has its own flags.
//
// What bounds it on an H100: as K1, the dependent int32 max/add chain
// along anti-diagonals (6 operations a cell), and latency; the band's
// memory traffic is its two rows and its columns, O(n + h). The scratch
// boundary columns between strips hold (strips - 1) * h ints, which is
// why a chain of bands keeps a genome-length query in bounded memory
// where one K1 sweep needs (strips - 1) * m. K10 adds to each rank the
// fill of the ranks to its left: its first strip starts ~191 steps after
// the left rank's last strip (PERF.md).
//
// Design: K1's (sweep.cuh): 1024-column strips claimed in order from a
// ticket counter, 64 threads x 16 columns in registers, boundary columns
// published every 64 rows. A strip's first row waits for its left
// neighbour's first 64 rows, so a band pays a fill of about 64 * strips
// steps before every strip runs. `max_grid` caps the CTAs (0: as many as
// fit on the card), so the tests can run fewer CTAs than strips. K10 is K8
// with the halo pointers set: its ranks run concurrently, one stream each,
// and every rank must be resident while it spins on its left neighbour, so
// `share` ranks on one card split its CTAs (strip_grid). Ranks on other
// cards write the halo on the consumer's card through peer access, with
// system-scope fences and uncached reads (sys_in / sys_out).
#include "sweep.cuh"

using namespace anyseq;

namespace {

// The halo hand-off of one K10 launch (all null for K8).
struct Halo {
  const int* in;         // rows [i0, i0 + h) of the column left of the stripe
  const int* in_flag;    // rows of `in` published in this band
  int* out;              // rows [i0, i0 + h) of the right rank's halo
  int* out_flag;
  const int* corner;     // H[i0-1][-1] on the device, or null
  bool sys_in, sys_out;  // across cards
};

template <bool LOCAL>
__global__ void __launch_bounds__(SWEEP_THREADS)
    band_kernel(const uint8_t* q, int h, const uint8_t* s, int n, Scoring sc,
                const int* row_in, int corner, const int* col_in, Halo halo,
                int strips, int* ticket, int* bcols, int* flags, int* row_out,
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
    S.corner_ptr = halo.corner;
    S.left_in = col_in;
    S.left = k > 0 ? bcols + (size_t)(k - 1) * h : halo.in;
    S.left_flag = k > 0 ? flags + (k - 1) : halo.in_flag;
    S.left_sys = k == 0 && halo.sys_in;
    S.right = k + 1 < strips ? bcols + (size_t)k * h : halo.out;
    S.right_flag = k + 1 < strips ? flags + k : halo.out_flag;
    S.right_sys = k + 1 == strips && halo.sys_out;
    S.last_col = last_col;
    S.last_row = row_out;
    S.preds = nullptr;
    S.pred_stride = 0;
    S.best = bests + 3 * k;
    sweep_strip<LOCAL, false, true>(S, sc, sh);
  }
}

template <bool LOCAL>
int launch(const uint8_t* q, int h, const uint8_t* s, int n, Scoring sc,
           const int* row_in, int corner, const int* col_in, Halo halo,
           int share, int max_grid, int* ticket, int* bcols, int* flags,
           int* row_out, int* last_col, int* bests, void* stream) {
  auto kernel = band_kernel<LOCAL>;
  const int strips = (n + STRIP - 1) / STRIP;
  const int grid = strip_grid((const void*)kernel, SWEEP_THREADS, strips,
                              share, max_grid);
  ANYSEQ_LAUNCH(kernel, grid, SWEEP_THREADS, stream, q, h, s, n, sc, row_in,
                corner, col_in, halo, strips, ticket, bcols, flags, row_out,
                last_col, bests);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs: q (h bytes), s (n bytes), row_in (n ints), col_in (h ints; null
// when halo_in is given), corner (used where corner_ptr is null). K10:
// halo_in / halo_out (h ints each) with one flag each, or null. Scratch
// the caller allocates: ticket (1 int, zeroed), flags (strips ints,
// zeroed), bcols ((strips - 1) * h ints); outputs row_out (n ints, not
// row_in), last_col (h), bests (3 * strips). `share`: launches that must
// be resident on the card together (1 for K8).
extern "C" int anyseq_band(const void* q, int h, const void* s, int n,
                           int match, int mismatch, int gap, int mode,
                           const void* row_in, int corner,
                           const void* corner_ptr, const void* col_in,
                           const void* halo_in, const void* halo_in_flag,
                           void* halo_out, void* halo_out_flag, int sys_in,
                           int sys_out, int share, int max_grid, void* ticket,
                           void* bcols, void* flags, void* row_out,
                           void* last_col, void* bests, void* stream) {
  const Scoring sc{match, mismatch, gap};
  const Halo halo{(const int*)halo_in, (const int*)halo_in_flag,
                  (int*)halo_out,      (int*)halo_out_flag,
                  (const int*)corner_ptr, sys_in != 0, sys_out != 0};
  auto run = [&](auto kernel_launch) {
    return kernel_launch((const uint8_t*)q, h, (const uint8_t*)s, n, sc,
                         (const int*)row_in, corner, (const int*)col_in, halo,
                         share, max_grid, (int*)ticket, (int*)bcols,
                         (int*)flags, (int*)row_out, (int*)last_col,
                         (int*)bests, stream);
  };
  return mode == MODE_LOCAL ? run(launch<true>) : run(launch<false>);
}

// Peer access from `device` to `peer`'s memory, so that K10 on `device`
// writes the halo that lives on `peer`. Enabled once; enabling it again
// is no error.
extern "C" int anyseq_enable_peer(int device, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  int err = (int)cudaDeviceEnablePeerAccess(peer, 0);
  if (err == (int)cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = 0;
  }
  cudaSetDevice(prev);
  return err;
}
