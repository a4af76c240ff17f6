// K4: the last columns of a batch of independent GLOBAL linear-gap DP
// problems -- every half of one Hirschberg divide level in one launch.
//
// Replaces the JAX package's Pallas kernels anyseq_tpu/kernels/band.py
// _score_slotted_padded (slotted _make_kernel body, reached from
// score_level_parts / score_levels_fused / score_pairs_batched) and
// _score_batched_padded (the plain (B, GP) grid of score_pairs_batched).
//
// Contract (that of engine/batch.py last_cols_batch, its plain version):
// cols[b][i] = H_b[i][ns[b] - 1] for i < ms[b], with H_b the GLOBAL DP of
// query q[b][0..ms[b]) against subject s[b][0..ns[b]).
//
// Each problem is swept transposed: its subject down the rows and its
// query across the columns, so that its last column is the sweep's last
// row. Linear GLOBAL DP is transpose-symmetric, bit for bit: with H[i][-1]
// = (i + 1) g, H[-1][j] = (j + 1) g and the corner 0, the recurrence
// H[i][j] = max(H[i-1][j-1] + sub(q_i, s_j), H[i-1][j] + g, H[i][j-1] + g)
// is the same with i and j (and q and s) exchanged, because sub depends
// only on whether the two symbols are equal; int32 max is exact and each
// sum is the same wrapped int32 either way. So H'[j][i] = H[i][j] and
// cols[b][i] = H'[ns[b] - 1][i], the bottom row that the warp strip core
// writes (engine/hirschberg.py sweeps its per-half levels the same way).
// Hirschberg halves are about twice as tall as they are wide, so the
// transposed sweep's row chain, the critical path, is half as long.
//
// What bounds it on an H100: at the 100k alignment's levels (8 halves of
// 12,500 x 25,000 transposed to 512 of ~200 x ~400) the row chain of each
// problem's sweep (one dependent max-plus a column on it) plus the strips'
// staggered starts: none of them fills the card. The 1 Mbp alignment's
// levels fill it, and the integer pipe bounds them (the first at ~58% of
// its bound of 5 instructions a cell).
//
// Design: the warp strip core of K8 and K1 (band_sweep.cuh), run per
// problem. Every problem is cut into strips of 32 x W columns (W = 32, 16
// or 8 columns a lane, one row a step: K1's widths; two rows a step lost
// for linear K1, PERF.md) and all strips of all problems form one ticket
// list in problem order. A warp that claims a strip builds the Band of that
// strip's problem -- its sequences, the CLOSED boundary (edge = gap), its
// boundary columns and flags at its offset in the launch's scratch, its row
// of cols -- and sweeps the strip within the problem, writing only the
// bottom row (OUT_ROW: no best, no last column). A warp only ever waits on
// the strip to its left in the same problem, which was claimed earlier by a
// running warp, so no launch size can deadlock. One width for the whole
// launch: band_sweep.cuh level_width (anyseq_lastcols_width), the least
// modelled time among the widths whose boundary columns fit the caller's
// cap on memory; the warps by level_grid.
//
// What the first design (a CTA strip core: 64 threads x 16 columns a
// 1024-column strip, a CTA barrier a step, strips 64 steps apart, every
// resident CTA launched; the problem in its own orientation) took on an
// H100 80GB HBM3 at 700 W (PERF.md): 7.262 ms for level 2 of the 100k
// semiglobal alignment (8 halves up to 25,025 x 12,500, 104 CTAs, ~25.8k
// steps on the critical path), 14.097 ms for its 7 levels, 264.8 ms for
// the 1 Mbp alignment's levels. This design, in turns with the first on
// the same card (tools/k4_ab.py, PERF.md): 3.917 ms for that level 2 at 16
// columns a lane (15,563 steps; the first design 7.103), 7.785 for the 7
// levels (14.061), 254.4 for the 1 Mbp alignment's levels at 32 (286.2).
#include "band_sweep.cuh"

using namespace anyseq;

namespace {

using band_core::Band;
using band_core::LANES;
using band_core::StepCost;
using band_core::WARPS;
using band_core::Width;
template <int LANE_COLS>
using LevelGeom = band_core::Geom<LANE_COLS>;

// One launch: the level's problems and their ticket list.
struct Level {
  const uint8_t* q;         // (B, q_stride) queries
  int q_stride;
  const uint8_t* s;         // (B, s_stride) subjects
  int s_stride;
  band_core::LevelMeta meta;
  int total;                // strips of all problems
  int workers;              // warps that claim strips
  int match, mismatch, gap;
  int* ticket;              // strips claimed so far
  int* flags;               // rows of a strip's last column published
  int* bcols;               // the strips' last columns
  int* cols;                // (B, col_stride) output
  int col_stride;
};

template <class G>
__global__ void __launch_bounds__(LANES * WARPS) lastcols_kernel(Level L) {
  __shared__ band_core::WarpShared<G> sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= L.workers) return;
  for (;;) {
    const int k = band_core::claim(L.ticket);
    if (k >= L.total) return;
    const int b = L.meta.problem_of(k);
    const int kk = k - (int)L.meta.start[b];
    // problem b transposed: its subject down the rows, its query across
    Band P{};
    P.q = L.s + (size_t)b * L.s_stride;
    P.h = (int)L.meta.ns[b];
    P.s = L.q + (size_t)b * L.q_stride;
    P.n = (int)L.meta.ms[b];
    P.match = L.match;
    P.mismatch = L.mismatch;
    P.gap = L.gap;
    P.edge = L.gap;
    P.strips = (int)(L.meta.start[b + 1] - L.meta.start[b]);
    P.flags = L.flags + L.meta.start[b];
    P.bcols = L.bcols + L.meta.boff[b];
    P.row_out = L.cols + (size_t)b * L.col_stride;
    if (kk + 1 < P.strips)
      band_core::sweep_strip<false, false, G, true, band_core::OUT_ROW>(
          P, kk, sh[warp]);
    else
      band_core::sweep_strip<false, true, G, true, band_core::OUT_ROW>(
          P, kk, sh[warp]);
  }
}

// f(Geom<...>{}) for one of K4's widths (= kernels/lastcols.py WIDTHS), or
// `bad` for another.
template <class F>
int with_width(int lane_cols, int bad, F f) {
  switch (lane_cols) {
    case 32: return f(LevelGeom<32>{});
    case 16: return f(LevelGeom<16>{});
    case 8: return f(LevelGeom<8>{});
    default: return bad;
  }
}

template <class G>
Width width(G) {
  return {G::LANE_COLS, (const void*)lastcols_kernel<G>, G::ROWS, G::LAG};
}

// A step of K4 (cycles, band_sweep.cuh StepCost), fitted to K4's
// device times at every width at every level of the 100k and 1 Mbp
// alignments on an H100 (tools/k4_ab.py --sweep, PERF.md): a warp alone
// on its scheduler ~400 + 6 a column a lane, each warp that shares it
// ~80 + 13 a column. With it the rule takes a width within 2% of the
// fastest at each of those levels.
constexpr StepCost STEP{400, 6, 80, 13};

// The problems in K4's orientation: rows ns, columns ms.
int level_width(const int* ms, const int* ns, int B, long long cap) {
  Width widths[3];
  StepCost costs[3];
  for (int w = 0; w < 3; ++w) {
    with_width(32 >> w, 0, [&](auto g) {
      widths[w] = width(g);
      return 0;
    });
    costs[w] = STEP;
  }
  return band_core::level_width(widths, costs, 3, ns, ms, B, 4, cap);
}

}  // namespace

// Inputs: q (B, q_stride) and s (B, s_stride) bytes; ms_host and ns_host,
// the problems' lengths on the host (B ints each); meta on the device
// (band_sweep.cuh LevelMeta, for `lane_cols` columns a lane in K4's
// orientation: a problem's strips ceil(ms[b] / (32 lane_cols)), none
// where ms[b] or ns[b] is 0, its boundary columns (strips - 1) x ns[b]);
// total, the strips of all problems. Scratch: ticket_flags (1 + total
// ints, zeroed), bcols (the boundary columns). Output cols (B, col_stride),
// zeroed by the caller: [b][i] for i < ms[b]. `lane_cols`: one of K4's
// widths; `max_grid` > 0 caps the warps. Another width:
// cudaErrorInvalidValue.
extern "C" int anyseq_lastcols(const void* q, int q_stride, const void* s,
                               int s_stride, const void* ms_host,
                               const void* ns_host, const void* meta, int B,
                               int total, int match, int mismatch, int gap,
                               int lane_cols, int max_grid,
                               void* ticket_flags, void* bcols, void* cols,
                               int col_stride, void* stream) {
  return with_width(lane_cols, (int)cudaErrorInvalidValue, [&](auto g) {
    using G = decltype(g);
    Level L{(const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
            band_core::LevelMeta::of((const long long*)meta, B), total,
            band_core::level_grid(width(g), (const int*)ns_host,
                                  (const int*)ms_host, B, max_grid),
            match, mismatch, gap, (int*)ticket_flags,
            (int*)ticket_flags + 1, (int*)bcols, (int*)cols, col_stride};
    if (total <= 0 || L.workers <= 0) return 0;
    ANYSEQ_LAUNCH(lastcols_kernel<G>, (L.workers + WARPS - 1) / WARPS,
                  LANES * WARPS, stream, L);
    return (int)cudaGetLastError();
  });
}

// The columns a lane K4 sweeps the B problems of lengths ms, ns (host
// ints) at on the current card, its boundary columns held to cap_bytes
// (band_sweep.cuh level_width).
extern "C" int anyseq_lastcols_width(const void* ms, const void* ns, int B,
                                     long long cap_bytes) {
  return level_width((const int*)ms, (const int*)ns, B, cap_bytes);
}

// The warps anyseq_lastcols launches for those problems at `lane_cols`
// columns a lane with `max_grid` (-1 for a width K4 does not have).
extern "C" int anyseq_lastcols_grid(const void* ms, const void* ns, int B,
                                    int lane_cols, int max_grid) {
  return with_width(lane_cols, -1, [&](auto g) {
    return band_core::level_grid(width(g), (const int*)ns, (const int*)ms, B,
                                 max_grid);
  });
}
