// K7: the batch sweep ("swarm"), one thread per problem: many small
// independent pairs, linear or affine (Gotoh) gaps, all three modes.
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
// engine/affine.py pack_codes4 and of the TPU kernel (swarm.py:201-213).
// Outputs past a problem's lengths are never written (the wrapper
// zero-fills them). An affine GLOBAL problem with sgaps[b] starts inside a
// paid gap run: its top row drops gap_open, its corner and left column are
// NEG. E[i][-1] is NEG + go - ge, so that E[i][0] = max(H[i][-1] + go + ge,
// NEG + go) is the closed form of engine/affine.py affine_row, and PE at
// j = 0 is the plain version's also under sgaps (the TPU kernel's NEG + ge
// there never wins H, but gives another PE where go or ge is 0).
//
// Design: each thread sweeps its own (m, n) row-major and stops at its own
// lengths, so no masks run inside the DP; divergence only idles lanes.
// diag, left and E live in registers; the previous row (and the F row)
// lives in device memory interleaved by problem, element (j, b) at
// j * B + b, so the 32 lanes of a warp touch 32 consecutive words at each
// j. A row runs in blocks of 16 columns: the subject is read 16 bytes at a
// time (rows padded to a multiple of 16), the next block's row values are
// loaded while the current block computes, one code word (two affine) is
// written per block, and only a row's last, partial block tests j < n per
// cell.
//
// What bounds it on an H100: one dependent chain of int32 max/add a cell
// a thread (about 6 operations linear, 11 affine); with 10^4 problems of
// ~256 x 256 only ~313 warps run, ~2.4 per SM, so the chain's latency
// (with the instructions around it) sets the pace, not the card's int32
// rate nor the row buffer's ~8 bytes a cell through L2 (10 MB at that
// size, inside the 50 MB L2). A per-cell branch (a bounds test, or codes
// picked by a nested conditional) or a load inside the chain each cost
// about 3x. A shared-memory row ([j][thread] for n up to a few hundred),
// several rows a pass, or several threads per problem for mid-size pairs
// (a few thousand columns, where one thread a problem runs millions of
// serial cells) is later work.
#include "common.cuh"

using namespace anyseq;

namespace {

constexpr int THREADS = 128;
constexpr int NEG = -(1 << 29);  // the affine -inf, safe under gap additions

struct alignas(16) Bytes16 {
  uint32_t w[4];
};

struct Params {
  int match, mismatch, gap, go, ge;
  bool need_pos;
};

// H[i][-1] of one problem; i = -1 is the corner
template <bool AFFINE, int MODE>
__device__ __forceinline__ int col_bound(int i, bool sg, const Params& p) {
  if (MODE != MODE_GLOBAL) return 0;
  if (AFFINE) return sg ? NEG : i < 0 ? 0 : p.go + (i + 1) * p.ge;
  return (i + 1) * p.gap;
}

// One 16-column block of a thread's row buffers (H and F of the previous
// row) and of its subject, starting at column j0; 0 past column n (FULL:
// the block lies below n).
struct Block {
  int up[16];
  int f[16];
  Bytes16 sv;
};

template <bool AFFINE, bool FULL>
__device__ __forceinline__ Block load_block(const int* R, const int* F,
                                            const uint8_t* S, size_t step,
                                            int j0, int n) {
  Block blk;
  blk.sv = *reinterpret_cast<const Bytes16*>(S + j0);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool in = FULL || j0 + k < n;
    blk.up[k] = in ? R[(j0 + k) * step] : 0;
    blk.f[k] = AFFINE && in ? F[(j0 + k) * step] : 0;
  }
  return blk;
}

// A thread's running sweep: H[i][j-1], H[i-1][j-1] and E[i][j-1] of the
// current row, and (LOCAL) the first maximum so far.
struct State {
  int left, diag, e;
  int vmax, vi, vj;
};

// Cells (i, j0 .. j0 + 15) of one problem (only those below n unless
// FULL, so that a full block runs without a branch a cell): H and F go
// to the row buffers; returns the block's codes, 2 bits a cell (linear)
// or 4 (affine) from bit 0 up.
template <bool AFFINE, int MODE, bool PREDS, bool FULL>
__device__ __forceinline__ uint64_t sweep_block(const Block& cur, int i,
                                                int j0, int n, int qi,
                                                int* R, int* F, size_t step,
                                                const Params& p, State& st) {
  const int goe = p.go + p.ge;
  uint64_t word = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = j0 + k;
    if (FULL || j < n) {
      const int sj = (int)((cur.sv.w[k >> 2] >> (8 * (k & 3))) & 0xFF);
      const int dsub = st.diag + (qi == sj ? p.match : p.mismatch);
      const int up = cur.up[k];
      int h;
      if (AFFINE) {
        const int f = imax(up + goe, cur.f[k] + p.ge);
        st.e = imax(st.left + goe, st.e + p.ge);
        int t = imax(dsub, f);
        if (MODE == MODE_LOCAL) t = imax(t, 0);
        h = imax(t, st.e);
        F[j * step] = f;
        if (PREDS) {
          // PH by diag > E > F as selects, PE / PF 1 where the run extends
          int ph = h == f ? PRED_GAP_S : PRED_NONE;
          ph = h == st.e ? PRED_GAP_Q : ph;
          ph = h == dsub ? PRED_NO_GAP : ph;
          const int code = ph | (st.e != st.left + goe) << 2 | (f != up + goe) << 3;
          word |= (uint64_t)code << (4 * k);
        }
      } else {
        h = imax(dsub, imax(up, st.left) + p.gap);
        if (MODE == MODE_LOCAL) h = imax(h, 0);
        if (PREDS) {
          // priority diag > gap_q > gap_s, as three selects (a nested
          // conditional compiles to branches)
          int code = h == up + p.gap ? PRED_GAP_S : PRED_NONE;
          code = h == st.left + p.gap ? PRED_GAP_Q : code;
          code = h == dsub ? PRED_NO_GAP : code;
          word |= (uint64_t)code << (2 * k);
        }
      }
      R[j * step] = h;
      if (MODE == MODE_LOCAL && h > st.vmax) {
        st.vmax = h;
        st.vi = i;
        st.vj = j;
      }
      st.diag = up;
      st.left = h;
    }
  }
  return word;
}

// The codes of the block at column j0 into its row of words: one word
// (linear), or two (affine), the second only where it holds a cell.
template <bool AFFINE>
__device__ __forceinline__ void store_codes(uint32_t* row, int j0, int n,
                                            uint64_t word) {
  if (!AFFINE) {
    row[j0 / 16] = (uint32_t)word;
    return;
  }
  row[j0 / 8] = (uint32_t)word;
  if (j0 + 8 < n) row[j0 / 8 + 1] = (uint32_t)(word >> 32);
}

template <bool AFFINE, int MODE, bool PREDS>
__global__ void __launch_bounds__(THREADS)
    swarm_kernel(const uint8_t* __restrict__ q, int q_stride,
                 const uint8_t* __restrict__ s, int s_stride,
                 const int* __restrict__ ms, const int* __restrict__ ns,
                 const uint8_t* __restrict__ sgaps, int B, Params p,
                 int* __restrict__ rowbuf, int* __restrict__ frow,
                 int* __restrict__ last_rows, int lr_stride,
                 int* __restrict__ last_cols, int lc_stride,
                 int* __restrict__ best, uint32_t* __restrict__ preds,
                 int pred_rows, int pred_words) {
  const int b = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const int m = ms[b];
  const int n = ns[b];
  const bool sg = AFFINE && MODE == MODE_GLOBAL && sgaps[b] != 0;
  const uint8_t* Q = q + (size_t)b * q_stride;
  const uint8_t* S = s + (size_t)b * s_stride;
  int* R = rowbuf + b;
  int* F = frow + b;
  const size_t step = (size_t)B;
  uint32_t* P = preds + (size_t)b * pred_rows * pred_words;

  // the top row H[-1][0..n)
  for (int j = 0; j < n; ++j) {
    int h = 0;
    if (MODE == MODE_GLOBAL)
      h = AFFINE ? (j + 1) * p.ge + (sg ? 0 : p.go) : (j + 1) * p.gap;
    R[j * step] = h;
    if (AFFINE) F[j * step] = NEG;
  }

  State st{0, 0, NEG, SCORE_MIN, 0, 0};
  int colmax = SCORE_MIN;
  for (int i = 0; i < m; ++i) {
    const int qi = Q[i];
    st.left = col_bound<AFFINE, MODE>(i, sg, p);
    st.diag = col_bound<AFFINE, MODE>(i - 1, sg, p);
    st.e = AFFINE ? NEG + p.go - p.ge : NEG;
    // The next block's row values, F's and subject bytes are loaded while
    // this block computes: they do not depend on its stores.
    Block next = n >= 16 ? load_block<AFFINE, true>(R, F, S, step, 0, n)
                         : load_block<AFFINE, false>(R, F, S, step, 0, n);
    int j0 = 0;
    for (; j0 + 16 <= n; j0 += 16) {
      const Block cur = next;
      if (j0 + 32 <= n)
        next = load_block<AFFINE, true>(R, F, S, step, j0 + 16, n);
      else if (j0 + 16 < n)
        next = load_block<AFFINE, false>(R, F, S, step, j0 + 16, n);
      const uint64_t word = sweep_block<AFFINE, MODE, PREDS, true>(
          cur, i, j0, n, qi, R, F, step, p, st);
      if (PREDS) store_codes<AFFINE>(P + (size_t)i * pred_words, j0, n, word);
    }
    if (j0 < n) {
      const uint64_t word = sweep_block<AFFINE, MODE, PREDS, false>(
          next, i, j0, n, qi, R, F, step, p, st);
      if (PREDS) store_codes<AFFINE>(P + (size_t)i * pred_words, j0, n, word);
    }
    last_cols[(size_t)b * lc_stride + i] = st.left;  // H[i][n-1]
    colmax = imax(colmax, st.left);
  }
  for (int j = 0; j < n; ++j) last_rows[(size_t)b * lr_stride + j] = R[j * step];

  int* out = best + 3 * (size_t)b;
  if (MODE == MODE_GLOBAL) {
    out[0] = st.left;
    out[1] = m - 1;
    out[2] = n - 1;
  } else if (MODE == MODE_SEMIGLOBAL) {
    out[0] = colmax;
    out[1] = 0;
    out[2] = 0;
  } else {
    out[0] = imax(st.vmax, 0);
    out[1] = p.need_pos ? st.vi : 0;
    out[2] = p.need_pos ? st.vj : 0;
  }
}

template <bool AFFINE, int MODE, bool PREDS>
void launch(int grid, void* stream, const uint8_t* q, int q_stride,
            const uint8_t* s, int s_stride, const int* ms, const int* ns,
            const uint8_t* sgaps, int B, Params p, int* rowbuf, int* frow,
            int* last_rows, int lr_stride, int* last_cols, int lc_stride,
            int* best, uint32_t* preds, int pred_rows, int pred_words) {
  const auto kernel = swarm_kernel<AFFINE, MODE, PREDS>;
  ANYSEQ_LAUNCH(kernel, grid, THREADS, stream, q, q_stride, s, s_stride, ms,
                ns, sgaps, B, p, rowbuf, frow, last_rows, lr_stride,
                last_cols, lc_stride, best, preds, pred_rows, pred_words);
}

template <bool AFFINE, bool PREDS, class... A>
void launch_mode(int mode, A... args) {
  if (mode == MODE_GLOBAL)
    launch<AFFINE, MODE_GLOBAL, PREDS>(args...);
  else if (mode == MODE_SEMIGLOBAL)
    launch<AFFINE, MODE_SEMIGLOBAL, PREDS>(args...);
  else
    launch<AFFINE, MODE_LOCAL, PREDS>(args...);
}

}  // namespace

// q: (B, q_stride) uint8, s: (B, s_stride) uint8 with s_stride a multiple
// of 16 and s 16-byte aligned; ms, ns: (B,) int32; sgaps: (B,) bool.
// Scratch: rowbuf (max ns x B ints), frow (the same, affine only).
// Outputs (zero-filled by the caller): last_rows (B, lr_stride), last_cols
// (B, lc_stride), best (B, 3), preds (B, pred_rows, pred_words) words with
// emit_preds (16 codes a word linear, 8 affine).
extern "C" int anyseq_swarm(const void* q, int q_stride, const void* s,
                            int s_stride, const void* ms, const void* ns,
                            const void* sgaps, int B, int match, int mismatch,
                            int gap, int gap_open, int gap_extend, int affine,
                            int mode, int need_pos, int emit_preds,
                            void* rowbuf, void* frow, void* last_rows,
                            int lr_stride, void* last_cols, int lc_stride,
                            void* best, void* preds, int pred_rows,
                            int pred_words, void* stream) {
  if (B <= 0) return 0;
  const Params p{match, mismatch, gap, gap_open, gap_extend, need_pos != 0};
  const int grid = (B + THREADS - 1) / THREADS;
  auto args = [&](auto run) {
    run(grid, stream, (const uint8_t*)q, q_stride, (const uint8_t*)s,
        s_stride, (const int*)ms, (const int*)ns, (const uint8_t*)sgaps, B, p,
        (int*)rowbuf, (int*)frow, (int*)last_rows, lr_stride, (int*)last_cols,
        lc_stride, (int*)best, (uint32_t*)preds, pred_rows, pred_words);
  };
  if (affine && emit_preds)
    args([&](auto... a) { launch_mode<true, true>(mode, a...); });
  else if (affine)
    args([&](auto... a) { launch_mode<true, false>(mode, a...); });
  else if (emit_preds)
    args([&](auto... a) { launch_mode<false, true>(mode, a...); });
  else
    args([&](auto... a) { launch_mode<false, false>(mode, a...); });
  return (int)cudaGetLastError();
}
