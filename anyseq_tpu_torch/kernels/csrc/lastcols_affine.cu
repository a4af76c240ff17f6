// K5L: the H and E last columns of a batch of independent GLOBAL affine
// (Gotoh) DP problems, each with its own Myers-Miller start_gap flag --
// every half of one Myers-Miller divide level in one launch.
//
// Replaces the affine variant of the JAX package's Pallas kernels
// anyseq_tpu/kernels/band.py _score_slotted_padded (per-problem sgap in
// the dims rows, H and E last columns; reached from score_pairs_batched
// and the affine level functions) and _score_batched_padded (its plain
// (B, GP) grid).
//
// Contract (that of engine/batch.py last_cols_batch_affine, its plain
// version): cols[b][i] = H_b[i][ns[b] - 1] and cols_e[b][i] =
// E_b[i][ns[b] - 1] for i < ms[b], with H_b/E_b the GLOBAL Gotoh DP of
// query q[b][0..ms[b]) against subject s[b][0..ns[b]), its top row
// continuing a paid gap run where sgaps[b] (engine/affine.py start_gap).
//
// What bounds it on an H100: as K4 -- at the 100k alignment's levels (8
// halves of 25,000 x 12,500 to 512 of ~400 x ~200) the row chain of each
// problem (E's one max-plus a column, band_sweep_affine.cuh) and the
// strips' staggered starts; at the 2.2 Mbp alignment's first levels, which
// fill the card, the integer pipe.
//
// Design: the affine warp strip core of K8 affine and K5
// (band_sweep_affine.cuh), run per problem as K4 runs the linear one
// (lastcols.cu): one ticket list of all strips of all problems in problem
// order; a warp builds the BandAffine of its strip's problem -- its
// sequences, K5's CLOSED boundary under that problem's start_gap (as
// band_affine.cu anyseq_sweep_affine sets it: H of the top row and left
// column from go + (j + 1) ge, or (j + 1) ge and NEG under start_gap, the
// corner 0 or NEG), its boundary H and E columns and flags at its offset,
// its rows of cols and cols_e -- and writes only the last H and E columns
// (OUT_COL, OUT_COL_E). The problems keep their own orientation:
// transposing Gotoh swaps E and F, and start_gap names a horizontal gap
// run. So the row chain stays the half's height, and the core's two rows
// a lane a step (sweep_strip2) halve its steps instead: K5's widths, 16
// columns a lane one row a step, 8 and 4 two rows a step (two rows won
// for K5: 37.6 against 42.1 ms at the 100k local score, PERF.md; an odd
// problem's last row is swept alone). Column 0's E floor and the E
// column out of the lane that holds column n - 1 are K5's. One width a
// launch, by band_sweep.cuh
// level_width with H and E counted in the boundary columns
// (anyseq_lastcols_affine_width).
//
// What the first design (a CTA strip core: a CTA of 64 threads x 16
// columns a 1024-column strip, a CTA barrier and a shared-memory hand-off
// of three values a step, E in its H form, three dependent operations a
// column on the row chain) took on an H100 80GB HBM3 at 700 W (PERF.md):
// 14.987 ms for level 2 of the 100k semiglobal affine alignment (8 halves
// up to 25,025 x 12,500, 104 CTAs), 28.672 ms for its 7 levels. This
// design, in turns with the first on the same card (tools/k4_ab.py,
// PERF.md): 6.478 ms for that level 2 at 8 columns a lane (14,796 steps;
// the first design 14.508), 12.800 for the 7 levels (28.618), 0.937 s for
// the 2.2 Mbp affine alignment's K5L levels at 16 (1.378 s).
#include "band_sweep_affine.cuh"

using namespace anyseq;

namespace {

using band_affine_core::BandAffine;
using band_affine_core::LANES;
using band_affine_core::NEG;
using band_affine_core::WARPS;
using band_core::StepCost;
using band_core::Width;
// K5's strips: 16 columns a lane one row a step, narrower two rows
template <int LANE_COLS>
using LevelGeom = band_core::Geom<LANE_COLS, LANE_COLS < 16 ? 2 : 1>;

// One launch: the level's problems and their ticket list.
struct LevelAffine {
  const uint8_t* q;         // (B, q_stride) queries
  int q_stride;
  const uint8_t* s;         // (B, s_stride) subjects
  int s_stride;
  const uint8_t* sgaps;     // B flags: the top row continues a paid gap
  band_core::LevelMeta meta;
  int total;                // strips of all problems
  int workers;              // warps that claim strips
  int match, mismatch, go, ge;
  int* ticket;              // strips claimed so far
  int* flags;               // rows of a strip's last columns published
  int* bcols;               // the strips' last H columns
  int* bcols_e;             // and E columns
  int* cols;                // (B, col_stride) outputs, H
  int* cols_e;              // and E
  int col_stride;
};

template <class G>
__global__ void __launch_bounds__(LANES * WARPS)
    lastcols_affine_kernel(LevelAffine L) {
  __shared__ band_affine_core::WarpSharedAffine<G> sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= L.workers) return;
  for (;;) {
    const int k = band_affine_core::claim(L.ticket);
    if (k >= L.total) return;
    const int b = L.meta.problem_of(k);
    const int kk = k - (int)L.meta.start[b];
    const bool sg = L.sgaps[b] != 0;
    BandAffine P{};
    P.q = L.q + (size_t)b * L.q_stride;
    P.h = (int)L.meta.ms[b];
    P.s = L.s + (size_t)b * L.s_stride;
    P.n = (int)L.meta.ns[b];
    P.match = L.match;
    P.mismatch = L.mismatch;
    P.go = L.go;
    P.ge = L.ge;
    P.corner = sg ? NEG : 0;
    P.top_base = sg ? 0 : L.go;
    P.top_step = L.ge;
    P.left_base = sg ? NEG : L.go;
    P.left_step = sg ? 0 : L.ge;
    P.strips = (int)(L.meta.start[b + 1] - L.meta.start[b]);
    P.flags = L.flags + L.meta.start[b];
    P.bcols = L.bcols + L.meta.boff[b];
    P.bcols_e = L.bcols_e + L.meta.boff[b];
    P.last_col = L.cols + (size_t)b * L.col_stride;
    P.last_col_e = L.cols_e + (size_t)b * L.col_stride;
    constexpr int OUT = band_core::OUT_COL | band_core::OUT_COL_E;
    if (kk + 1 < P.strips)
      band_affine_core::sweep<false, false, G, true, OUT>(P, kk, sh[warp]);
    else
      band_affine_core::sweep<false, true, G, true, OUT>(P, kk, sh[warp]);
  }
}

// f(Geom<...>{}) for one of K5L's widths (= kernels/lastcols.py
// AFFINE_WIDTHS), or `bad` for another.
template <class F>
int with_width(int lane_cols, int bad, F f) {
  switch (lane_cols) {
    case 16: return f(LevelGeom<16>{});
    case 8: return f(LevelGeom<8>{});
    case 4: return f(LevelGeom<4>{});
    default: return bad;
  }
}

template <class G>
Width width(G) {
  return {G::LANE_COLS, (const void*)lastcols_affine_kernel<G>, G::ROWS,
          G::LAG};
}

// A step of K5L (cycles, band_sweep.cuh StepCost), fitted to K5L's
// device times at every width at every level of the 100k and 2.2 Mbp
// affine alignments on an H100 (tools/k4_ab.py --sweep, PERF.md): one row
// (16 columns a lane) ~550 + 6 a column a lane alone on its scheduler,
// ~66 + 24 a column for each warp that shares it; two rows ~825 + 5 and
// ~110 + 43. With it the rule takes a width within 5% of the fastest at
// each of those levels.
constexpr StepCost STEP_ONE{550, 6, 66, 24};
constexpr StepCost STEP_TWO{825, 5, 110, 43};

int level_width(const int* ms, const int* ns, int B, long long cap) {
  Width widths[3];
  StepCost costs[3];
  for (int w = 0; w < 3; ++w) {
    with_width(16 >> w, 0, [&](auto g) {
      widths[w] = width(g);
      costs[w] = decltype(g)::ROWS == 2 ? STEP_TWO : STEP_ONE;
      return 0;
    });
  }
  return band_core::level_width(widths, costs, 3, ms, ns, B, 8, cap);
}

}  // namespace

// Inputs: q (B, q_stride) and s (B, s_stride) bytes; ms_host and ns_host,
// the problems' lengths on the host (B ints each); meta on the device
// (band_sweep.cuh LevelMeta, for `lane_cols` columns a lane: a problem's
// strips ceil(ns[b] / (32 lane_cols)), none where ms[b] or ns[b] is 0, its
// boundary columns (strips - 1) x ms[b]); sgaps, B bytes on the device, 0
// or 1; total, the strips of all problems. Scratch: ticket_flags (1 +
// total ints, zeroed), bcols and bcols_e (the boundary columns, H and E).
// Outputs cols and cols_e (B, col_stride), zeroed by the caller: [b][i]
// for i < ms[b]. `lane_cols`: one of K5L's widths; `max_grid` > 0 caps the
// warps. Another width: cudaErrorInvalidValue.
extern "C" int anyseq_lastcols_affine(
    const void* q, int q_stride, const void* s, int s_stride,
    const void* ms_host, const void* ns_host, const void* meta,
    const void* sgaps, int B, int total, int match, int mismatch,
    int gap_open, int gap_extend, int lane_cols, int max_grid,
    void* ticket_flags, void* bcols, void* bcols_e, void* cols, void* cols_e,
    int col_stride, void* stream) {
  return with_width(lane_cols, (int)cudaErrorInvalidValue, [&](auto g) {
    using G = decltype(g);
    LevelAffine L{(const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                  (const uint8_t*)sgaps,
                  band_core::LevelMeta::of((const long long*)meta, B), total,
                  band_core::level_grid(width(g), (const int*)ms_host,
                                        (const int*)ns_host, B, max_grid),
                  match, mismatch, gap_open, gap_extend, (int*)ticket_flags,
                  (int*)ticket_flags + 1, (int*)bcols, (int*)bcols_e,
                  (int*)cols, (int*)cols_e, col_stride};
    if (total <= 0 || L.workers <= 0) return 0;
    ANYSEQ_LAUNCH(lastcols_affine_kernel<G>,
                  (L.workers + WARPS - 1) / WARPS, LANES * WARPS, stream, L);
    return (int)cudaGetLastError();
  });
}

// The columns a lane K5L sweeps the B problems of lengths ms, ns (host
// ints) at on the current card, its boundary H and E columns held to
// cap_bytes (band_sweep.cuh level_width).
extern "C" int anyseq_lastcols_affine_width(const void* ms, const void* ns,
                                            int B, long long cap_bytes) {
  return level_width((const int*)ms, (const int*)ns, B, cap_bytes);
}

// The warps anyseq_lastcols_affine launches for those problems at
// `lane_cols` columns a lane with `max_grid` (-1 for a width K5L does not
// have).
extern "C" int anyseq_lastcols_affine_grid(const void* ms, const void* ns,
                                           int B, int lane_cols,
                                           int max_grid) {
  return with_width(lane_cols, -1, [&](auto g) {
    return band_core::level_grid(width(g), (const int*)ms, (const int*)ns, B,
                                 max_grid);
  });
}
