// One strip of the affine-gap (Gotoh) DP, swept by one CTA along
// anti-diagonals: the affine twin of sweep.cuh, with its geometry, its
// staging ring and its strip hand-off.
//
// Used by K5p alone, the single-pair sweep with codes
// (wavefront_affine.cu): K5, the score sweep, and K5L, the level sweep, run
// on the affine warp strip core (band_sweep_affine.cuh).
//
// Thread t owns COLS consecutive columns and keeps H[i-1][j] and F[i-1][j]
// of each in registers: F runs down a column, so it never leaves its
// thread. E runs along a row: thread t-1 hands over H and E of its last
// column at row i (and q[i]) through shared memory, and thread 0 takes
// them from the ring that the CTA fills from the left strip's published
// H and E columns (or from the closed-form boundary for the first strip).
//
// The cell recurrence, with go = gap_open, ge = gap_extend:
//
//   F[i][j] = max(H[i-1][j] + go + ge, F[i-1][j] + ge)
//   T       = max(H[i-1][j-1] + sub, F[i][j]   [, 0 LOCAL])
//   E[i][j] = max(E[i][j-1] + ge, H[i][j-1] + go + ge)
//   H[i][j] = max(T, E[i][j])
//
// E[i][j] equals engine/affine.py's closed form max_{k<j}(T[i][k] + go +
// (j-k)*ge): reopening from an E-derived H[i][j-1] is never better than
// extending. The first strip's E[i][-1] is NEG + go - ge, so that E[i][0] =
// go + max(NEG, H[i][-1] + ge) exactly as there.
#pragma once

#include "sweep.cuh"

namespace anyseq {

constexpr int NEG = -(1 << 29);  // the affine -inf, safe under gap additions

struct AffineScoring {
  int match, mismatch, gap_open, gap_extend;
};

struct StripAffine {
  const uint8_t* q;
  int m;                    // rows (query length)
  const uint8_t* s;
  int n;                    // columns (subject length)
  int col0;                 // first column of the strip
  bool global_init;         // GLOBAL boundaries, else 0
  bool start_gap;           // (GLOBAL) the top row continues a paid gap run
  const int* left_h;        // left boundary H column, or null for the first strip
  const int* left_e;        // left boundary E column
  const int* left_flag;     // rows of the left columns published so far
  int* right_h;             // this strip's last H column, or null for the last strip
  int* right_e;             // and its E column
  int* right_flag;
  int* last_col;            // H[i][n-1] for i < m, or null
  int* last_col_e;          // E[i][n-1] for i < m, or null
  int* last_row;            // H[m-1][j] for the strip's columns, or null
  uint32_t* preds;          // 4-bit codes, word (i, j / 8)
  int pred_stride;          // words per row
  int* best;                // (score, i, j) of the strip's first maximum
};

struct SweepAffineShared {
  int hand_h[2][SWEEP_THREADS];
  int hand_e[2][SWEEP_THREADS];
  int hand_q[2][SWEEP_THREADS];
  int ring_h[RING];
  int ring_e[RING];
  int ring_q[RING];
  int best[3][SWEEP_THREADS];
};

// H[i][-1] for i >= 0; the corner H[-1][-1] for i = -1.
__device__ __forceinline__ int col_bound(const StripAffine& S,
                                         const AffineScoring& sc, int i) {
  if (!S.global_init) return 0;
  if (S.start_gap) return NEG;
  return i < 0 ? 0 : sc.gap_open + (i + 1) * sc.gap_extend;
}

// H[-1][j] for j >= 0.
__device__ __forceinline__ int row_bound(const StripAffine& S,
                                         const AffineScoring& sc, int j) {
  if (!S.global_init) return 0;
  return (S.start_gap ? 0 : sc.gap_open) + (j + 1) * sc.gap_extend;
}

// Rows [chunk*CHUNK, (chunk+1)*CHUNK) of the left boundary (H and E) and
// the query into the ring, one row per thread.
__device__ __forceinline__ void stage_chunk_affine(const StripAffine& S,
                                                   const AffineScoring& sc,
                                                   SweepAffineShared& sh,
                                                   int chunk) {
  const int r = chunk * CHUNK + (int)threadIdx.x;
  if (r >= S.m) return;
  int h, e;
  if (S.left_h) {
    wait_for(S.left_flag, imin(S.m, (chunk + 1) * CHUNK));
    h = load_cg(S.left_h + r);
    e = load_cg(S.left_e + r);
  } else {
    h = col_bound(S, sc, r);
    e = NEG + sc.gap_open - sc.gap_extend;
  }
  sh.ring_h[r % RING] = h;
  sh.ring_e[r % RING] = e;
  sh.ring_q[r % RING] = S.q[r];
}

template <bool LOCAL>
__device__ void sweep_strip_affine(const StripAffine& S, const AffineScoring sc,
                                   SweepAffineShared& sh) {
  const int t = (int)threadIdx.x;
  const int c0 = S.col0 + t * COLS;
  const int ge = sc.gap_extend;
  const int go_ge = sc.gap_open + sc.gap_extend;

  int sj[COLS];
  int H[COLS];  // H[i-1][c0 + c] before row i, H[i][c0 + c] after it
  int F[COLS];  // F likewise
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = c0 + c;
    sj[c] = j < S.n ? (int)S.s[j] : -1;
    H[c] = row_bound(S, sc, j);
    F[c] = NEG;
  }
  // H[i-1][c0-1]: the corner for the first column, else the top row
  int diag_in = c0 == 0 ? col_bound(S, sc, -1) : row_bound(S, sc, c0 - 1);
  const int lc = S.last_col ? S.n - 1 - c0 : -1;  // which column is n-1
  int bs = SCORE_MIN, bi = -1, bj = -1;

  stage_chunk_affine(S, sc, sh, 0);
  __syncthreads();

  const int steps = S.m + SWEEP_THREADS - 1;
  for (int step = 0; step < steps; ++step) {
    if (step % CHUNK == 0) stage_chunk_affine(S, sc, sh, step / CHUNK + 1);
    const int i = step - t;
    if (i >= 0 && i < S.m) {
      int h_left, e_left, qi;
      if (t == 0) {
        h_left = sh.ring_h[i % RING];
        e_left = sh.ring_e[i % RING];
        qi = sh.ring_q[i % RING];
      } else {
        h_left = sh.hand_h[(step - 1) & 1][t - 1];
        e_left = sh.hand_e[(step - 1) & 1][t - 1];
        qi = sh.hand_q[(step - 1) & 1][t - 1];
      }
      int diag = diag_in;
      diag_in = h_left;
      uint32_t word[2] = {0, 0};
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int up = H[c];
        const int f = imax(up + go_ge, F[c] + ge);
        const int dsub = diag + (qi == sj[c] ? sc.match : sc.mismatch);
        int tt = imax(dsub, f);
        if (LOCAL) tt = imax(tt, 0);
        const int e = imax(e_left + ge, h_left + go_ge);
        const int h = imax(tt, e);
        if (c0 + c < S.n) {
          // the same comparisons, in the same order, as the plain version
          const int ph = h == dsub ? PRED_NO_GAP
                         : h == e  ? PRED_GAP_Q
                         : h == f  ? PRED_GAP_S
                                   : PRED_NONE;
          const int code = ph | (e != h_left + go_ge) << 2 | (f != up + go_ge) << 3;
          word[c / 8] |= (uint32_t)code << (4 * (c % 8));
        }
        if (c0 + c < S.n && h > bs) {
          bs = h;
          bi = i;
          bj = c0 + c;
        }
        if (c == lc) {
          S.last_col[i] = h;
          if (S.last_col_e) S.last_col_e[i] = e;
        }
        diag = up;
        h_left = h;
        e_left = e;
        H[c] = h;
        F[c] = f;
      }
      sh.hand_h[step & 1][t] = h_left;
      sh.hand_e[step & 1][t] = e_left;
      sh.hand_q[step & 1][t] = qi;
      if (c0 < S.n) {
        uint32_t* row = S.preds + (size_t)i * S.pred_stride + c0 / 8;
        row[0] = word[0];
        if (c0 + 8 < S.n) row[1] = word[1];
      }
      if (S.right_h && t == SWEEP_THREADS - 1) {
        S.right_h[i] = h_left;
        S.right_e[i] = e_left;
        if ((i + 1) % CHUNK == 0 || i + 1 == S.m)
          publish(S.right_flag, i + 1);
      }
    }
    __syncthreads();
  }

  if (S.last_row) {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (c0 + c < S.n) S.last_row[c0 + c] = H[c];
  }
  sh.best[0][t] = bs;
  sh.best[1][t] = bi;
  sh.best[2][t] = bj;
  __syncthreads();
  if (t == 0) {
    for (int u = 1; u < SWEEP_THREADS; ++u) {
      if (better(sh.best[0][u], sh.best[1][u], sh.best[2][u], bs, bi, bj)) {
        bs = sh.best[0][u];
        bi = sh.best[1][u];
        bj = sh.best[2][u];
      }
    }
    S.best[0] = bs;
    S.best[1] = bi;
    S.best[2] = bj;
  }
  __syncthreads();
}

}  // namespace anyseq
