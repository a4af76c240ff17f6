// K7: the batch sweep ("swarm"): many independent pairs in one launch,
// linear or affine (Gotoh) gaps, all three modes, optionally with each
// cell's traceback code.
//
// Replaces the JAX package's Pallas kernel anyseq_tpu/kernels/swarm.py
// _swarm_padded (body _make_kernel), which gives each of the 1024 lanes of
// an (8, 128) vector tile its own problem and sweeps all of them in
// lockstep, masking ragged lengths. Its tiles, its 16-step unroll and its
// VMEM budget are the TPU's economics; what it computes is kept:
//
// Contract (that of engine/batch.py swarm_batch, its plain version): for
// problem b, the DP of q[b][0..ms[b]) against s[b][0..ns[b]) in `mode`
// gives last_rows[b][j] = H[m-1][j] (j < n), last_cols[b][i] = H[i][n-1]
// (i < m) and best[b] = GLOBAL (H[m-1][n-1], m-1, n-1), SEMIGLOBAL (max_i
// H[i][n-1], 0, 0), LOCAL (score, i, j) of the first maximum in row-major
// order ((score, 0, 0) without need_pos); with PREDS the codes of cell
// (i, j): linear, 2 bits in bits 2*(j % 16) of word preds[b][i][j / 16],
// in the walk's (K3's) layout; affine, 4 bits PH | PE << 2 | PF << 3 in
// bits 4*(j % 8) of word preds[b][i][j / 8], the layout of
// engine/affine.py pack_codes4 (and K6's). Outputs past a problem's
// lengths are never written (the wrapper zero-fills them). An affine
// GLOBAL problem with sgaps[b] starts inside a paid gap run: its top row
// drops gap_open, its corner and left column are NEG. E[i][-1] is NEG +
// go - ge, so that E[i][0] = max(H[i][-1] + go + ge, NEG + go) is the
// closed form of engine/affine.py affine_row, and PE at j = 0 is the plain
// version's also under sgaps (the TPU kernel's NEG + ge there never wins
// H, but gives another PE where go or ge is 0).
//
// Design: the warp strip cores (band_sweep.cuh, band_sweep_affine.cuh),
// as the level sweeps K4 / K5L run them: each problem is cut by its own
// ns[b] into strips of 32 x W columns (W columns a lane), all strips of
// all problems of the launch form one ticket list in problem order
// (band_sweep.cuh LevelMeta, claim), and a warp that claims a strip
// builds its problem's band -- sequences, the CLOSED boundary of `mode`
// (and of sgaps[b]), its boundary columns and flags at its offset, its
// rows of the outputs -- and sweeps the strip: a lane W columns, lanes a
// row apart, H[i][c0-1] handed on by shuffle. A problem of one strip (at
// ~256 bp, most of them) reads and writes no boundary column and waits on
// no flag; strip k > 0 reads strip k - 1's last column (+ E) through the
// published flags. Problems keep their own orientation (LOCAL ties and the
// row-major codes fix it). Every strip writes its part of last_rows
// (OUT_ROW), the last strip last_cols (OUT_COL); LOCAL strips their first
// maxima (OUT_BEST): a problem of one strip straight into best[b], else
// into scratch, and the warp whose strip finishes a problem last (a count
// in the problem's last, otherwise unused, flag) reduces them by
// (score, i, j). The last strip of a GLOBAL or SEMIGLOBAL problem reads
// its own last column back for best[b]. With PREDS the cores' OUT_CODES
// mode writes the codes, a lane's W codes of a row as one segment, staged
// in shared memory until the warp writes the row whole (band_sweep.cuh
// Codes). Widths: linear 32, 16, 12 and 8 columns a lane, one row a step;
// affine 16 one row, 12, 8 and 4 two rows a step (sweep_strip2); with
// codes linear 16 and 8, affine 16, 8 and 4 (no 12: below; no 32: at the
// batch calls' widest pairs, 4,096 bp, 32 columns a lane ran 1.8x slower
// than 8 without codes). One width a launch, by band_sweep.cuh
// level_width on K7's step costs (anyseq_swarm_plan), under the caller's
// cap on boundary memory; the warps by level_grid.
//
// What bounds it on an H100: with thousands of ~256 bp problems a launch
// (one warp a problem, tens of warps an SM) the warps' issue, ~50 + 20
// cycles a column a lane a warp-step (~55 + 40 with codes; STEP below);
// at 4,096 bp (16 or 17 strips a problem at 8 columns a lane) the
// critical path, a problem's rows plus its strips' staggered starts. The
// first design, one thread a problem, gave a 5,640-problem launch 1.3
// warps an SM, each thread a chain of 65,536 dependent cells, and a
// 104-problem launch of 4,096 bp 4 warps on 132 SMs (1.633 and 333.5 ms,
// PERF.md).
#include "band_sweep_affine.cuh"

using namespace anyseq;

namespace {

using band_affine_core::BandAffine;
using band_core::Band;
using band_core::FULL;
using band_core::LANES;
using band_core::StepCost;
using band_core::WARPS;
using band_core::Width;
template <int W>
using LinearGeom = band_core::Geom<W>;
// K5's strips: 16 columns a lane one row a step, narrower two rows
template <int W>
using AffineGeom = band_core::Geom<W, W < 16 ? 2 : 1>;

// One launch: the problems and their ticket list.
struct Swarm {
  const uint8_t* q;         // (B, q_stride) queries
  int q_stride;
  const uint8_t* s;         // (B, s_stride) subjects
  int s_stride;
  const uint8_t* sgaps;     // B flags (affine GLOBAL): a paid gap run;
                            // null: none
  band_core::LevelMeta meta;
  int total;                // strips of all problems
  int workers;              // warps that claim strips
  int mode;
  int match, mismatch, gap, go, ge;
  bool need_pos;
  int* ticket;              // strips claimed so far
  int* flags;               // rows of a strip's last column published
  int* bcols;               // the strips' last columns (H)
  int* bcols_e;             // and (affine) E
  int* bests;               // (score, i, j) of each strip of a problem
                            // of several (LOCAL), at 3 x its ticket
  int* last_rows;           // (B, lr_stride)
  int lr_stride;
  int* last_cols;           // (B, lc_stride)
  int lc_stride;
  int* best;                // (B, 3)
  unsigned* preds;          // (B, pred_rows, pred_words) code words
  int pred_rows, pred_words;
};

// After strip kk of problem b (of `strips`, the first at ticket `first`):
// the problem's best, once its last strip (not LOCAL) or the last of its
// strips to finish (LOCAL) has swept.
template <bool LOCAL>
__device__ __forceinline__ void finish(const Swarm& L, int b, int kk,
                                       int strips, int first, int m, int n,
                                       const int* last_col) {
  const int lane = (int)(threadIdx.x & 31);
  int* out = L.best + 3 * (size_t)b;
  if (LOCAL) {
    if (strips > 1) {
      int last = 0;
      if (lane == 0) {
        __threadfence();
        last = atomicAdd(L.flags + first + strips - 1, 1) == strips - 1;
      }
      if (!__shfl_sync(FULL, last, 0)) return;
      __threadfence();
      int bs = SCORE_MIN, bi = 0x7fffffff, bj = 0x7fffffff;
      for (int t = lane; t < strips; t += LANES) {
        const int* x = L.bests + 3 * (size_t)(first + t);
        const int s = load_cg(x), i = load_cg(x + 1), j = load_cg(x + 2);
        if (band_core::better(s, i, j, bs, bi, bj)) {
          bs = s;
          bi = i;
          bj = j;
        }
      }
#pragma unroll
      for (int d = LANES / 2; d > 0; d /= 2) {
        const int os = __shfl_xor_sync(FULL, bs, d);
        const int oi = __shfl_xor_sync(FULL, bi, d);
        const int oj = __shfl_xor_sync(FULL, bj, d);
        if (band_core::better(os, oi, oj, bs, bi, bj)) {
          bs = os;
          bi = oi;
          bj = oj;
        }
      }
      if (lane == 0) {
        out[0] = bs;
        out[1] = bi;
        out[2] = bj;
      }
    }
    // (one strip: the core's store_best wrote best[b] from this lane)
    if (!L.need_pos && lane == 0) {
      out[1] = 0;
      out[2] = 0;
    }
    return;
  }
  if (kk + 1 < strips) return;
  // the last strip: its lanes wrote last_col, and the core ended with a
  // __syncwarp
  if (L.mode == MODE_GLOBAL) {
    if (lane == 0) {
      out[0] = last_col[m - 1];
      out[1] = m - 1;
      out[2] = n - 1;
    }
    return;
  }
  int v = SCORE_MIN;
  for (int i = lane; i < m; i += LANES) v = imax(v, last_col[i]);
#pragma unroll
  for (int d = LANES / 2; d > 0; d /= 2)
    v = imax(v, __shfl_xor_sync(FULL, v, d));
  if (lane == 0) {
    out[0] = v;
    out[1] = 0;
    out[2] = 0;
  }
}

// The CTAs an SM that ptxas must leave registers for (__launch_bounds__'s
// second argument; 0: its own choice). Left to itself, ptxas held the
// affine LOCAL kernels with codes at 8 columns a lane (two rows a step)
// and at 16 (one row) to 128 registers (four CTAs an SM) and spilled 24
// bytes each (the 16-column one only once `sgaps` could be null); asked
// for three they take ~150 and spill nothing.
template <bool AFFINE, bool LOCAL, class G, bool PREDS>
constexpr int MIN_CTAS =
    AFFINE && LOCAL && PREDS && G::LANE_COLS >= 8 ? 3 : 0;

template <bool AFFINE, bool LOCAL, class G, bool PREDS>
__global__ void __launch_bounds__(LANES * WARPS,
                                  MIN_CTAS<AFFINE, LOCAL, G, PREDS>)
    swarm_kernel(Swarm L) {
  constexpr int CB = PREDS ? (AFFINE ? 4 : 2) : 0;
  constexpr int OUT = band_core::OUT_ROW | band_core::OUT_COL |
                      (LOCAL ? band_core::OUT_BEST : 0) |
                      (PREDS ? band_core::OUT_CODES : 0);
  using Shared =
      typename std::conditional<AFFINE,
                                band_affine_core::WarpSharedAffine<G, CB>,
                                band_core::WarpShared<G, CB>>::type;
  __shared__ Shared sh[WARPS];
  const int warp = (int)threadIdx.x / LANES;
  if ((int)blockIdx.x * WARPS + warp >= L.workers) return;
  for (;;) {
    const int k = band_core::claim(L.ticket);
    if (k >= L.total) return;
    const int b = L.meta.problem_of(k);
    const int first = (int)L.meta.start[b];
    const int kk = k - first;
    const int strips = (int)L.meta.start[b + 1] - first;
    const int m = (int)L.meta.ms[b], n = (int)L.meta.ns[b];
    using P_t = typename std::conditional<AFFINE, BandAffine, Band>::type;
    P_t P{};
    P.q = L.q + (size_t)b * L.q_stride;
    P.h = m;
    P.s = L.s + (size_t)b * L.s_stride;
    P.n = n;
    P.match = L.match;
    P.mismatch = L.mismatch;
    P.strips = strips;
    P.flags = L.flags + first;
    P.bcols = L.bcols + L.meta.boff[b];
    P.row_out = L.last_rows + (size_t)b * L.lr_stride;
    P.last_col = L.last_cols + (size_t)b * L.lc_stride;
    P.bests = strips == 1 ? L.best + 3 * (size_t)b : L.bests + 3 * first;
    if (PREDS) {
      P.codes = L.preds + (size_t)b * L.pred_rows * L.pred_words;
      P.code_words = L.pred_words;
    }
    const bool global = L.mode == MODE_GLOBAL;
    if constexpr (AFFINE) {
      // K5's closed boundary (band_affine.cu anyseq_sweep_affine)
      const bool sg = global && L.sgaps && L.sgaps[b] != 0;
      P.go = L.go;
      P.ge = L.ge;
      P.corner = sg ? band_affine_core::NEG : 0;
      P.top_base = global && !sg ? L.go : 0;
      P.top_step = global ? L.ge : 0;
      P.left_base = global ? (sg ? band_affine_core::NEG : L.go) : 0;
      P.left_step = global && !sg ? L.ge : 0;
      P.bcols_e = L.bcols_e + L.meta.boff[b];
      if (kk + 1 < strips)
        band_affine_core::sweep<LOCAL, false, G, true, OUT>(P, kk, sh[warp]);
      else
        band_affine_core::sweep<LOCAL, true, G, true, OUT>(P, kk, sh[warp]);
    } else {
      P.gap = L.gap;
      P.edge = global ? L.gap : 0;
      if (kk + 1 < strips)
        band_core::sweep_strip<LOCAL, false, G, true, OUT>(P, kk, sh[warp]);
      else
        band_core::sweep_strip<LOCAL, true, G, true, OUT>(P, kk, sh[warp]);
    }
    finish<LOCAL>(L, b, kk, strips, first, m, n, P.last_col);
  }
}

// One instantiation of K7.
template <bool AFFINE_, bool LOCAL_, class G_, bool PREDS_>
struct Kind {
  static constexpr bool AFFINE = AFFINE_, LOCAL = LOCAL_, PREDS = PREDS_;
  using G = G_;
  static Width width() {
    return {G::LANE_COLS,
            (const void*)swarm_kernel<AFFINE, LOCAL, G, PREDS>, G::ROWS,
            G::LAG};
  }
};

// f(Kind<...>{}) for one of K7's widths (= kernels/swarm.py WIDTHS,
// PREDS_WIDTHS, AFFINE_WIDTHS and AFFINE_PREDS_WIDTHS), or `bad` for
// another. 12 columns a lane (a strip of 384 columns: the ~256 bp pairs
// of 257 to 384 columns in one strip) have no codes: a lane's 24 or 48
// bits of a row would share a word with the next lane's.
template <bool AFFINE, bool LOCAL, bool PREDS, class F>
int with_width(int lane_cols, int bad, F f) {
  if constexpr (AFFINE) {
    switch (lane_cols) {
      case 16: return f(Kind<true, LOCAL, AffineGeom<16>, PREDS>{});
      case 12:
        if constexpr (!PREDS)
          return f(Kind<true, LOCAL, AffineGeom<12>, false>{});
        break;
      case 8: return f(Kind<true, LOCAL, AffineGeom<8>, PREDS>{});
      case 4: return f(Kind<true, LOCAL, AffineGeom<4>, PREDS>{});
    }
  } else {
    switch (lane_cols) {
      case 32:
        if constexpr (!PREDS)
          return f(Kind<false, LOCAL, LinearGeom<32>, false>{});
        break;
      case 16: return f(Kind<false, LOCAL, LinearGeom<16>, PREDS>{});
      case 12:
        if constexpr (!PREDS)
          return f(Kind<false, LOCAL, LinearGeom<12>, false>{});
        break;
      case 8: return f(Kind<false, LOCAL, LinearGeom<8>, PREDS>{});
    }
  }
  return bad;
}

template <class F>
int with_kind(bool affine, bool local, bool preds, int lane_cols, int bad,
              F f) {
  if (affine) {
    if (local)
      return preds ? with_width<true, true, true>(lane_cols, bad, f)
                   : with_width<true, true, false>(lane_cols, bad, f);
    return preds ? with_width<true, false, true>(lane_cols, bad, f)
                 : with_width<true, false, false>(lane_cols, bad, f);
  }
  if (local)
    return preds ? with_width<false, true, true>(lane_cols, bad, f)
                 : with_width<false, true, false>(lane_cols, bad, f);
  return preds ? with_width<false, false, true>(lane_cols, bad, f)
               : with_width<false, false, false>(lane_cols, bad, f);
}

// A step of K7 (cycles, band_sweep.cuh StepCost). Linear: fitted to K7's
// device times at every width on the batch calls' launches on an H100
// (tools/k7_probe.py --sweep, PERF.md): a warp alone on its scheduler
// ~417 + 35 a column a lane (the 4,096 bp launch at 12, 16 and 32
// columns), each warp that shares it ~50 + 20 a column (the ~256 bp
// launches at 8, 16 and 32), with codes ~55 + 40. Affine: K5L's fits
// (lastcols_affine.cu), within 10% of K7's ~256 bp launches, with ~5 a
// column more for the codes.
constexpr StepCost STEP{417, 35, 50, 20};
constexpr StepCost STEP_CODES{417, 39, 55, 40};
constexpr StepCost STEP_AFFINE_ONE{550, 6, 66, 24};
constexpr StepCost STEP_AFFINE_TWO{825, 5, 110, 43};
constexpr StepCost STEP_AFFINE_ONE_CODES{550, 8, 66, 29};
constexpr StepCost STEP_AFFINE_TWO_CODES{825, 7, 110, 53};

int swarm_width(const int* ms, const int* ns, int B, bool affine, bool local,
                bool preds, long long cap, long long* most) {
  Width widths[4];
  StepCost costs[4];
  int count = 0;
  for (const int w : {32, 16, 12, 8, 4}) {
    with_kind(affine, local, preds, w, 0, [&](auto kind) {
      using K = decltype(kind);
      widths[count] = K::width();
      costs[count] = !K::AFFINE   ? (K::PREDS ? STEP_CODES : STEP)
                     : K::G::ROWS == 2
                         ? (K::PREDS ? STEP_AFFINE_TWO_CODES
                                     : STEP_AFFINE_TWO)
                         : (K::PREDS ? STEP_AFFINE_ONE_CODES
                                     : STEP_AFFINE_ONE);
      ++count;
      return 0;
    });
  }
  return band_core::level_width(widths, costs, count, ms, ns, B,
                                affine ? 8 : 4, cap, most);
}

}  // namespace

// The plan of a launch of the B problems of lengths ms, ns (host ints,
// >= 1) on the current card, for the scoring, mode and codes: its width,
// `lane_cols` (0: the rule's, band_sweep.cuh level_width on K7's step
// costs, its boundary columns held to cap_bytes), returned (-1: a width
// K7 does not have there). Fills meta (4 B + 1 int64 values on the host,
// band_sweep.cuh LevelMeta: a problem's strips ceil(ns[b] / (32
// lane_cols)), its boundary columns (strips - 1) x ms[b]) and plan (4
// int64 values: the launch's strips, its boundary values -- H, and E
// alike where affine --, its warps (band_sweep.cuh level_grid) and, where
// the rule ran, the most bytes of boundary columns any width takes, for
// the caller to plan again under the card's cap where that is large).
extern "C" int anyseq_swarm_plan(const void* ms, const void* ns, int B,
                                 int affine, int mode, int emit_preds,
                                 int lane_cols, long long cap_bytes,
                                 void* meta, void* plan) {
  const int* m = (const int*)ms;
  const int* n = (const int*)ns;
  long long* out = (long long*)plan;
  out[3] = 0;
  if (lane_cols == 0)
    lane_cols = swarm_width(m, n, B, affine != 0, mode == MODE_LOCAL,
                            emit_preds != 0, cap_bytes, out + 3);
  return with_kind(
      affine != 0, mode == MODE_LOCAL, emit_preds != 0, lane_cols, -1,
      [&](auto kind) {
        const Width w = decltype(kind)::width();
        long long* x = (long long*)meta;
        long long start = 0, held = 0;
        for (int b = 0; b < B; ++b) {
          const int k = band_core::level_strips(m[b], n[b], w.lane_cols);
          x[b] = m[b];
          x[B + b] = n[b];
          x[2 * B + b] = start;
          x[3 * B + 1 + b] = held;
          start += k;
          held += (long long)imax(k - 1, 0) * m[b];
        }
        x[3 * B] = start;
        out[0] = start;
        out[1] = held;
        out[2] = band_core::level_grid(w, m, n, B, 0);
        return lane_cols;
      });
}

// Inputs: q (B, q_stride) and s (B, s_stride) bytes; meta on the device
// (anyseq_swarm_plan's for `lane_cols`); sgaps, B bytes on the device
// (affine GLOBAL; null: none); total and workers, the plan's strips and
// warps. Scratch: ticket_flags (1 + total ints, zeroed), bcols and
// (affine) bcols_e (the boundary columns), bests (3 x total ints, LOCAL),
// each unread (and may be null) where every problem has one strip.
// Outputs, zeroed by the caller: last_rows (B, lr_stride), last_cols (B,
// lc_stride), best (B, 3) and with emit_preds preds (B, pred_rows,
// pred_words) words (16 codes a word linear, 8 affine). `lane_cols`: one
// of K7's widths for the scoring and codes; another:
// cudaErrorInvalidValue.
extern "C" int anyseq_swarm(
    const void* q, int q_stride, const void* s, int s_stride,
    const void* meta, const void* sgaps, int B, int total, int workers,
    int match, int mismatch, int gap, int gap_open, int gap_extend,
    int affine, int mode, int need_pos, int emit_preds, int lane_cols,
    void* ticket_flags, void* bcols, void* bcols_e, void* bests,
    void* last_rows, int lr_stride, void* last_cols, int lc_stride,
    void* best, void* preds, int pred_rows, int pred_words, void* stream) {
  return with_kind(
      affine != 0, mode == MODE_LOCAL, emit_preds != 0, lane_cols,
      (int)cudaErrorInvalidValue, [&](auto kind) {
        using K = decltype(kind);
        const Swarm L{(const uint8_t*)q, q_stride, (const uint8_t*)s,
                      s_stride, (const uint8_t*)sgaps,
                      band_core::LevelMeta::of((const long long*)meta, B),
                      total, workers, mode, match, mismatch, gap, gap_open,
                      gap_extend, need_pos != 0, (int*)ticket_flags,
                      (int*)ticket_flags + 1, (int*)bcols, (int*)bcols_e,
                      (int*)bests, (int*)last_rows, lr_stride,
                      (int*)last_cols, lc_stride, (int*)best,
                      (unsigned*)preds, pred_rows, pred_words};
        if (total <= 0 || workers <= 0) return 0;
        const auto kernel =
            swarm_kernel<K::AFFINE, K::LOCAL, typename K::G, K::PREDS>;
        ANYSEQ_LAUNCH(kernel, (workers + WARPS - 1) / WARPS, LANES * WARPS,
                      stream, L);
        return (int)cudaGetLastError();
      });
}
