// One strip of the linear-gap DP, swept by one CTA along anti-diagonals.
//
// Used by K2 alone, the single-pair sweep with codes (wavefront.cu): K1,
// the score sweep, and K4, the level sweep, run on the warp strip core
// (band_sweep.cuh).
//
// The subject (columns) is cut into strips of STRIP columns; thread t of
// the CTA owns the COLS consecutive columns [col0 + t*COLS, +COLS) and
// keeps their previous-row scores in registers. At step s thread t works
// on row i = s - t, so thread t-1 finished row i one step earlier and
// handed over H[i][its last column] and the query symbol q[i] through
// shared memory (one barrier per step). Thread 0 takes the same two
// values from a ring in shared memory that the whole CTA fills CHUNK rows
// ahead: the strip's left boundary column, written by the CTA that swept
// the strip to the left and published in chunks through a progress flag
// (or, for the first strip, the closed-form boundary), and the query.
#pragma once

#include "common.cuh"

namespace anyseq {

constexpr int SWEEP_THREADS = 64;          // threads per CTA
constexpr int COLS = 16;                   // columns per thread: one word of 2-bit codes
constexpr int STRIP = SWEEP_THREADS * COLS;
constexpr int CHUNK = SWEEP_THREADS;       // boundary rows staged at a time, one per thread
constexpr int RING = 2 * CHUNK;

struct Scoring {
  int match, mismatch, gap;
};

struct Strip {
  const uint8_t* q;
  int m;                    // rows (query length)
  const uint8_t* s;
  int n;                    // columns (subject length)
  int col0;                 // first column of the strip
  bool global_init;         // boundary H[i][-1] = (i+1)*gap, else 0
  const int* left;          // left boundary column, or null for the first strip
  const int* left_flag;     // rows of `left` published so far
  int* right;               // this strip's last column, or null for the last strip
  int* right_flag;
  int* last_col;            // H[i][n-1] for i < m, or null
  int* last_row;            // H[m-1][j] for the strip's columns, or null
  uint32_t* preds;          // packed codes, word (i, j / COLS)
  int pred_stride;          // words per row
  int* best;                // (score, i, j) of the strip's first maximum
};

struct SweepShared {
  int hand_h[2][SWEEP_THREADS];
  int hand_q[2][SWEEP_THREADS];
  int ring_h[RING];
  int ring_q[RING];
  int best[3][SWEEP_THREADS];
};

__device__ __forceinline__ int boundary(bool global_init, int gap, int x) {
  return global_init ? (x + 1) * gap : 0;
}

// Rows [chunk*CHUNK, (chunk+1)*CHUNK) of the left boundary and the query
// into the ring, one row per thread.
__device__ __forceinline__ void stage_chunk(const Strip& S, int gap,
                                            SweepShared& sh, int chunk) {
  const int r = chunk * CHUNK + (int)threadIdx.x;
  if (r >= S.m) return;
  int h;
  if (S.left) {
    wait_for(S.left_flag, imin(S.m, (chunk + 1) * CHUNK));
    h = load_cg(S.left + r);
  } else {
    h = boundary(S.global_init, gap, r);
  }
  sh.ring_h[r % RING] = h;
  sh.ring_q[r % RING] = S.q[r];
}

// (a better than b): higher score, then smaller i, then smaller j -- the
// first maximum in row-major order.
__device__ __forceinline__ bool better(int as, int ai, int aj, int bs, int bi,
                                       int bj) {
  return as > bs || (as == bs && (ai < bi || (ai == bi && aj < bj)));
}

template <bool LOCAL>
__device__ void sweep_strip(const Strip& S, const Scoring sc, SweepShared& sh) {
  const int t = (int)threadIdx.x;
  const int c0 = S.col0 + t * COLS;
  const int g = sc.gap;

  int sj[COLS];
  int H[COLS];  // H[i-1][c0 + c] before row i, H[i][c0 + c] after it
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = c0 + c;
    sj[c] = j < S.n ? (int)S.s[j] : -1;
    H[c] = boundary(S.global_init, g, j);
  }
  int diag_in = boundary(S.global_init, g, c0 - 1);   // H[i-1][c0-1]
  const int lc = S.last_col ? S.n - 1 - c0 : -1;     // which column is n-1
  int bs = SCORE_MIN, bi = -1, bj = -1;

  stage_chunk(S, g, sh, 0);
  __syncthreads();

  const int steps = S.m + SWEEP_THREADS - 1;
  for (int step = 0; step < steps; ++step) {
    if (step % CHUNK == 0) stage_chunk(S, g, sh, step / CHUNK + 1);
    const int i = step - t;
    if (i >= 0 && i < S.m) {
      int left, qi;
      if (t == 0) {
        left = sh.ring_h[i % RING];
        qi = sh.ring_q[i % RING];
      } else {
        left = sh.hand_h[(step - 1) & 1][t - 1];
        qi = sh.hand_q[(step - 1) & 1][t - 1];
      }
      int diag = diag_in;
      diag_in = left;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int up = H[c];
        const int dsub = diag + (qi == sj[c] ? sc.match : sc.mismatch);
        int h = imax(dsub, up + g);
        if (LOCAL) h = imax(h, 0);
        h = imax(h, left + g);
        if (c0 + c < S.n) {
          // the same comparisons, in the same order, as the plain version
          const int code = h == dsub         ? PRED_NO_GAP
                           : h == left + g ? PRED_GAP_Q
                           : h == up + g   ? PRED_GAP_S
                                           : PRED_NONE;
          word |= (uint32_t)code << (2 * c);
        }
        if (c0 + c < S.n && h > bs) {
          bs = h;
          bi = i;
          bj = c0 + c;
        }
        if (c == lc) S.last_col[i] = h;
        diag = up;
        left = h;
        H[c] = h;
      }
      sh.hand_h[step & 1][t] = left;
      sh.hand_q[step & 1][t] = qi;
      if (c0 < S.n) S.preds[(size_t)i * S.pred_stride + c0 / COLS] = word;
      if (S.right && t == SWEEP_THREADS - 1) {
        S.right[i] = left;
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

// Claims the next strip for the whole CTA. Strips are handed out in
// increasing order, so the strip a CTA waits on was claimed earlier by a
// CTA that is already running: no launch size can deadlock.
__device__ __forceinline__ int claim(int* ticket, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1);
  __syncthreads();
  const int k = *slot;
  __syncthreads();
  return k;
}

}  // namespace anyseq
