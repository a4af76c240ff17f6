// K8: one band of rows of the single-pair linear-gap DP from an explicit
// boundary -- the unit of the chained sweep that scores queries of any
// length in bounded memory, and of the resumable scorer. K10: the same
// band over one rank's stripe of columns, handing its boundary columns to
// and from the neighbouring ranks as it runs -- the collective sweep that
// scores one pair over several devices (dist/collective.py). K1 and K2
// (anyseq_sweep): a whole single-pair sweep, up to kernels/band.py M_MAX
// rows score only, as one band of this kernel from the sweep's
// closed-form boundary, at a strip width the width rule (band_sweep.cuh
// width_of) chooses from the card and the pair; K2 also writes each
// cell's 2-bit code (the cores' OUT_CODES mode) -- the port of the JAX
// package's _score_padded (band.py:1336), score only and with
// emit_preds, which the first design swept on 1024-column CTA strips.
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
// per 32 rows in `halo_in_flag` by the rank on the left), the corner from
// `corner_ptr` (that halo's row i0 - 1, published in the band before) where
// given, and the last column also goes to `halo_out` for the rank on the
// right, raising `halo_out_flag`. Each band has its own flags.
//
// What bounds it on an H100: the dependent int32 max/add chain along each
// row (one max and one add a cell on it; 6 integer operations a cell in
// all, the bound PERF.md counts), and the integer pipe that runs them;
// the band's memory traffic is its two rows and its columns, O(n + h).
// The scratch boundary columns between strips hold (strips - 1) * h ints,
// which is why a chain of bands keeps a genome-length query in bounded
// memory where one K1 sweep needs (strips - 1) * m.
//
// What the first design (a CTA strip core: 64 threads x 16 columns a
// CTA, a CTA barrier and a shared-memory hand-off a step, publish every
// 64 rows, every resident CTA launched) lost, on an H100
// 80GB HBM3 at 700 W (PERF.md): a 262,144 x 4.6 M band took
// 1402-3737 ms at the full grid (~14 CTAs an SM, every thread of a
// waiting CTA spinning), 1184.6 ms at 462 CTAs, 19.8-36.5% of its
// bound; a step cost ~900 cycles for 16 cells a thread (a barrier, the
// shared hand-off, a compare and three selects a cell for the best,
// bound checks a cell); strips started ~191 steps apart.
//
// This core (band_sweep.cuh) and its grid (band_sweep.cuh grid_of, which
// K8 affine shares), step by step, with what the card measured
// (tools/k8_ab.py; PERF.md, which also holds the times of the variants
// measured slower, since removed from the source):
// 1. The grid: every strip at once where the card (or a K10 rank's share
//    of it) holds them, else as many warps as it holds over equal
//    rounds; at most the strips a band keeps busy, ~(h + 31) / 63
//    (kept: caps of 4-10 warps an SM ran 10-50% slower at 4.6 M columns,
//    2,112 warps in 2.13 rounds 20% slower than 1,498 in 3; the busy cap
//    ran 4,096- and 16,384-row bands 18-20% faster than every strip).
// 2. One lane waits on a flag while its warp waits at __syncwarp (kept;
//    a sleep that grew between looks measured the same as common.cuh's
//    fixed one, and went).
// 3. A warp a strip, 32 lanes x 32 columns, the boundary handed on with
//    __shfl_up_sync, no CTA barrier; CTAs of 4 warps, one a scheduler
//    (kept: one-warp CTAs ran 4-9% slower, and bimodal at 1 M columns).
// 4. DPX on the chain: __viaddmax_s32(_relu), __vimax3_s32 (kept as
//    written; nvcc makes the same VIADDMNMX of plain max/add code, so the
//    intrinsics changed no time).
// 5. The best from a row maximum a step, the row stored to shared memory
//    only where it beats the lane's best; bound checks only in the last
//    strip (kept: a compare and three selects a cell ran 12-36% slower).
// 6. Publish and stage every 32 rows, staged the step before they are
//    needed: strips start ~63 steps apart (kept: a chunk ahead, ~94
//    steps, ran 4-7% slower; 16-row chunks ran short bands 13% faster
//    and the 4.6 M band 5% slower, so the chunk stays 32).
// K8 went from 1184.6 ms (the first design's best grid) to ~630 ms at
// 262,144 x 4.6 M, 65-69% of its bound, and from ~405 to ~198 ms at
// x 1 M (PERF.md).
//
// K10 is K8 with the halo pointers set: its ranks run concurrently, one
// stream each, and every rank must be resident while it waits on its left
// neighbour, so `share` ranks on one card split its warps (grid_of).
// Ranks on other cards write the halo on the consumer's card through peer
// access, with system-scope fences and uncached reads (sys_in / sys_out).
#include "band_sweep.cuh"

using namespace anyseq;
using band_core::Band;
using band_core::Halo;

namespace {

using band_core::BandGeom;
using band_core::Form;
using band_core::LANES;
using band_core::WARPS;
template <int LANE_COLS>
using SweepGeom = band_core::Geom<LANE_COLS>;

// CB: the bits of a cell's code (2: K2, OUT_CODES), or 0 (K1, K8, K10).
template <bool LOCAL, class G, bool CLOSED, int CB = 0>
__global__ void __launch_bounds__(LANES * WARPS) band_kernel(Band B) {
  constexpr int OUT = band_core::OUT_ALL | (CB ? band_core::OUT_CODES : 0);
  __shared__ band_core::WarpShared<G, CB> sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= B.workers) return;
  for (;;) {
    const int k = band_core::claim(B.ticket);
    if (k >= B.strips) return;
    if (k + 1 < B.strips)
      band_core::sweep_strip<LOCAL, false, G, CLOSED, OUT, CB>(B, k, sh[warp]);
    else
      band_core::sweep_strip<LOCAL, true, G, CLOSED, OUT, CB>(B, k, sh[warp]);
  }
}

template <class G>
int strips_of(int n) { return (n + G::STRIP - 1) / G::STRIP; }

// CLOSED: K1 / K2 (the closed-form boundary of a whole sweep); else K8 /
// K10.
template <bool LOCAL, class G, bool CLOSED, int CB = 0>
int grid_of(int h, int n, int share, int max_grid) {
  return band_core::grid_of((const void*)band_kernel<LOCAL, G, CLOSED, CB>,
                            h, strips_of<G>(n), share, max_grid, G::LAG);
}

template <bool LOCAL, class G, bool CLOSED, int CB = 0>
int launch(Band B, int share, int max_grid, void* stream) {
  B.strips = strips_of<G>(B.n);
  B.workers = grid_of<LOCAL, G, CLOSED, CB>(B.h, B.n, share, max_grid);
  auto kernel = band_kernel<LOCAL, G, CLOSED, CB>;
  ANYSEQ_LAUNCH(kernel, (B.workers + WARPS - 1) / WARPS, LANES * WARPS,
                stream, B);
  return (int)cudaGetLastError();
}

// f(Form<...>{}) for one of K1's widths (= kernels/band.py WIDTHS) or,
// with codes, of K2's (CODE_WIDTHS), or `bad` for another. K1: 32
// columns a lane is K8's own kernel on the sweep's boundary tensors (its
// closed form ran 10% slower there, PERF.md), 16 and 8 the closed form,
// which spares a short sweep the boundary's six tensor launches; four
// columns a lane ran slower than eight at every shape of the main path
// (PERF.md), so K1 does not have it. K2: 16 and 8 columns a lane, the
// closed form with 2-bit codes (32- and 16-bit segments, K7's), one row a
// step (two, the affine core's form, ran 2-3% slower at 8 columns at
// 10k, 2,048 and 256 rows, PERF.md); at 32 a warp's code ring and best
// rows (8 + 4 KB) would take a CTA past the 48 KB of static shared
// memory.
template <bool CODES, class F>
int with_width(int lane_cols, int bad, F f) {
  constexpr int CB = CODES ? 2 : 0;
  switch (lane_cols) {
    case 32:
      if constexpr (!CODES) return f(Form<BandGeom, false>{});
      break;
    case 16: return f(Form<SweepGeom<16>, true, CB>{});
    case 8: return f(Form<SweepGeom<8>, true, CB>{});
  }
  return bad;
}

template <bool LOCAL, class K>
band_core::Width width(K) {
  using G = typename K::G;
  return {G::LANE_COLS, (const void*)band_kernel<LOCAL, G, K::CLOSED, K::CB>,
          G::ROWS, G::LAG};
}

// A step of K2 (cycles, band_sweep.cuh StepCost), fitted to its device
// times at 16 and 8 columns a lane at 10k, 2,048 and 256 rows on an
// H100 (tools/k1_ab.py --preds --sweep, PERF.md): a warp alone on its
// scheduler ~450 + 46 a column; each warp that shares it, K7's codes
// costs (swarm.cu STEP_CODES).
constexpr band_core::StepCost STEP_CODES{450, 46, 55, 40};

// K1's width rule (band_sweep.cuh width_of) over its widths; K2's, the
// level rule (band_sweep.cuh level_width) over its widths on its own step
// costs, the pair one problem with no cap on its boundary columns (width_of
// took 16 columns at 2,000 x 3,000 affine, where 8 ran 31% faster,
// PERF.md).
template <bool LOCAL, bool CODES>
int sweep_width(int h, int n) {
  band_core::Width widths[3];
  band_core::StepCost costs[3];
  int count = 0;
  for (const int w : {32, 16, 8})
    with_width<CODES>(w, 0, [&](auto kind) {
      costs[count] = STEP_CODES;
      widths[count++] = width<LOCAL>(kind);
      return 0;
    });
  if (CODES)
    return band_core::level_width(widths, costs, count, &h, &n, 1, 4,
                                  LLONG_MAX);
  return band_core::width_of(widths, count, h, n);
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
  const Halo halo{(const int*)halo_in, (const int*)halo_in_flag,
                  (int*)halo_out,      (int*)halo_out_flag,
                  (const int*)corner_ptr, sys_in != 0, sys_out != 0};
  const Band B{(const uint8_t*)q, h,        (const uint8_t*)s, n,
               match,             mismatch, gap,
               (const int*)row_in, corner,  (const int*)col_in,
               0,                 halo,     0,
               0,                 (int*)ticket, (int*)bcols,
               (int*)flags,       (int*)row_out, (int*)last_col,
               (int*)bests};
  return mode == MODE_LOCAL
             ? launch<true, BandGeom, false>(B, share, max_grid, stream)
             : launch<false, BandGeom, false>(B, share, max_grid, stream);
}

// The warps anyseq_band launches for a band of h rows and n columns in
// `mode` with these `share` and `max_grid`, on the current card.
extern "C" int anyseq_band_grid(int h, int n, int mode, int share,
                                int max_grid) {
  return mode == MODE_LOCAL
             ? grid_of<true, BandGeom, false>(h, n, share, max_grid)
             : grid_of<false, BandGeom, false>(h, n, share, max_grid);
}

// K1 and K2: the single-pair sweep of an h-row query against an n-column
// subject in `mode`, run as one band from the sweep's closed-form
// boundary (H[-1][j] = (j + 1) * gap, H[i][-1] = (i + 1) * gap for
// GLOBAL, 0 else) at `lane_cols` columns a lane, one of K1's widths or,
// with codes, of K2's (anyseq_sweep_width's choice, or one a caller
// forces): at 32, K8's kernel reads that boundary from row_in (n ints)
// and col_in (h ints); narrower, the kernel computes it (row_in, col_in
// unread). Scratch and outputs as anyseq_band's, with strips of 32 *
// lane_cols columns; `max_grid` > 0 caps the warps. `codes` null: K1,
// score only; else K2 also writes cell (i, j)'s 2-bit code (the plain
// version's, linmem.pack_codes) in bits 2 * (j % 16) of word i *
// code_words + j / 16 (code_words >= ceil(n / 16)), a lane's codes of a
// row as one segment: a segment of columns past n - 1 is not stored, so
// the caller zeroes the row's last word where no lane's segment reaches
// its end. Another width, or no boundary tensors at 32:
// cudaErrorInvalidValue.
extern "C" int anyseq_sweep(const void* q, int h, const void* s, int n,
                            int match, int mismatch, int gap, int mode,
                            int lane_cols, const void* row_in,
                            const void* col_in, int max_grid, void* ticket,
                            void* bcols, void* flags, void* row_out,
                            void* last_col, void* bests, void* codes,
                            int code_words, void* stream) {
  const Band B{(const uint8_t*)q, h,        (const uint8_t*)s, n,
               match,             mismatch, gap,
               (const int*)row_in, 0,       (const int*)col_in,
               mode == MODE_GLOBAL ? gap : 0, Halo{}, 0,
               0,                 (int*)ticket, (int*)bcols,
               (int*)flags,       (int*)row_out, (int*)last_col,
               (int*)bests,       (unsigned*)codes, code_words};
  const int bad = (int)cudaErrorInvalidValue;
  auto go = [&](auto kind) {
    using K = decltype(kind);
    using G = typename K::G;
    if (!K::CLOSED && !(row_in && col_in)) return bad;
    return mode == MODE_LOCAL
               ? launch<true, G, K::CLOSED, K::CB>(B, 1, max_grid, stream)
               : launch<false, G, K::CLOSED, K::CB>(B, 1, max_grid, stream);
  };
  return codes ? with_width<true>(lane_cols, bad, go)
               : with_width<false>(lane_cols, bad, go);
}

// The columns a lane K1 (`codes` 0) or K2 sweeps an h x n pair at in
// `mode` on the current card (band_sweep.cuh width_of).
extern "C" int anyseq_sweep_width(int h, int n, int mode, int codes) {
  const bool local = mode == MODE_LOCAL;
  if (codes)
    return local ? sweep_width<true, true>(h, n)
                 : sweep_width<false, true>(h, n);
  return local ? sweep_width<true, false>(h, n)
               : sweep_width<false, false>(h, n);
}

// The warps anyseq_sweep launches for an h x n pair in `mode` at
// `lane_cols` columns a lane, with codes or not (-1 for a width K1 or
// K2 does not have).
extern "C" int anyseq_sweep_grid(int h, int n, int mode, int lane_cols,
                                 int codes) {
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

#ifdef ANYSEQ_HOST_EMU
// The emulated card's SMs and CTAs an SM, for the tests of grid_of.
extern "C" void anyseq_emu_set_card(int sms, int ctas_per_sm) {
  emu_card_sms = sms;
  emu_card_ctas_per_sm = ctas_per_sm;
}
#endif

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
