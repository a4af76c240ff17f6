// The strip core of K8 affine and K10 affine (band_affine.cu): one
// 512-column strip of a band of the affine-gap (Gotoh) DP, swept by one
// warp. The affine twin of band_sweep.cuh, whose lanes, CTAs, staging
// rhythm, flags, claim and grid rule it shares.
//
// Lane t owns the 16 consecutive columns [col0 + 16t, +16) and keeps
// H[i-1][j] and F[i-1][j] of each, and its subject symbols, in registers.
// At step `step` lane t works on row i = step - t, and lane t-1 hands over
// H[i][its last column], the E state of lane t's first column and q[i]
// with __shfl_up_sync; lane 0 takes them from a ring that the warp stages
// CHUNK rows at a time, the step before use, from the left strip's
// published H and E columns (`bcols`, `bcols_e`), the band's explicit left
// columns, or (K10) the halo. No CTA barrier runs.
//
// The cell recurrence, with go = gap_open <= 0 (AffineScoring refuses
// more), ge = gap_extend:
//
//   F[i][j] = max(H[i-1][j] + go + ge, F[i-1][j] + ge)
//   T[i][j] = max(H[i-1][j-1] + sub, F[i][j]   [, 0 LOCAL])
//   E[i][j] = max(E[i][j-1] + ge, T[i][j-1] + go + ge)
//   H[i][j] = max(T[i][j], E[i][j])
//
// E's T form equals the H form max(E + ge, H + go + ge) exactly, since
// go <= 0 makes the term E + go + ge never exceed E + ge; it is the closed
// form that engine/affine.py computes. T and F depend on the row above
// only, so the one dependent step along a row is E's. The lane carries
// Ê = E - (go + ge), which makes that step one max-plus and H one more:
//
//   Ê[j+1] = max(Ê[j] + ge, T[j])      H[j] = max(Ê[j] + go + ge, T[j])
//
// (each a __viaddmax_s32), so a cell is F's add and max-plus, the
// substitution's compare and select, T's max-plus (its _relu form for
// LOCAL) and those two: the linear core's one DPX instruction a column on
// the chain, and six integer operations a cell beside it.
//
// A strip's first column takes E from the H and E of the column to its
// left (the left strip's last column, or the band's left column), in the
// H form max(E[-1] + ge, H[-1] + go + ge), at staging time. At the band's
// column 0 the plain version also floors E at NEG + go (affine_row's
// cummax starts from NEG) and the run on to column 1 does not see that
// floor, so the ring carries both: the chain's start and the floored E
// that column 0's H takes.
//
// The best, the bound checks and the publishing are the linear core's: a
// row maximum a step, the row stored to shared memory only where it
// beats the lane's best, the first column and a warp reduction by
// (score, i, j) at the end; columns past n - 1 masked only in the strip
// that holds column n - 1; the last lane writes its last column's H and
// E and publishes every CHUNK rows.
//
// Half the linear core's 32 columns a lane: the same band then has twice
// the strips and warps, and an H100 ran it 10% faster at 1 M columns and
// 20% faster at 2.2 M than with 32 columns a lane (167 registers, 12
// warps an SM; 16 columns: 117 and 16; PERF.md).
#pragma once

#include "band_sweep.cuh"

namespace anyseq {
namespace band_affine_core {

using band_core::addmax;
using band_core::better;
using band_core::CHUNK;
using band_core::claim;
using band_core::FULL;
using band_core::LANES;
using band_core::max3;
using band_core::RING;
using band_core::wait_rows;
using band_core::WARPS;

constexpr int LANE_COLS = 16;
constexpr int STRIP = LANES * LANE_COLS;   // = kernels/band.py AFFINE_STRIP
constexpr int NEG = -(1 << 29);  // the affine -inf of engine/affine.py

// The halo hand-off of one K10 affine launch (all null for K8 affine).
struct HaloAffine {
  const int* in;         // rows [i0, i0 + h) of the H column left of the stripe
  const int* in_e;       // and of the E column
  const int* in_flag;    // rows of `in` published in this band
  int* out;              // rows [i0, i0 + h) of the right rank's halo, H
  int* out_e;            // and E
  int* out_flag;
  const int* corner;     // H[i0-1][-1] on the device, or null
  bool sys_in, sys_out;  // across cards
};

// One launch: the band, its boundary, the hand-off scratch and outputs.
struct BandAffine {
  const uint8_t* q;
  int h;                   // rows of the band
  const uint8_t* s;
  int n;                   // columns
  int match, mismatch, go, ge;
  const int* top;          // H[i0-1][0..n)
  const int* top_f;        // F[i0-1][0..n)
  int corner;              // H[i0-1][-1] where halo.corner is null
  const int* left_in;      // H[i0..i0+h)[-1] where halo.in is null
  const int* left_in_e;    // E[i0..i0+h)[-1] likewise
  HaloAffine halo;
  int strips;
  int workers;             // warps that claim strips (the launch's grid)
  int* ticket;             // strips claimed so far
  int* bcols;              // (strips - 1) x h: strip k's last H column at k * h
  int* bcols_e;            // and its E column
  int* flags;              // rows of bcols[k] published
  int* row_out;            // H[i0+h-1][0..n)
  int* rowf_out;           // F[i0+h-1][0..n)
  int* last_col;           // H[i0..i0+h)[n-1]
  int* last_col_e;         // E[i0..i0+h)[n-1]
  int* bests;              // (score, i, j) a strip
};

// Where one strip reads its left columns and writes its right ones.
struct EdgesAffine {
  const int* left;        // flagged left H column, or null: B.left_in
  const int* left_e;
  const int* left_flag;
  bool left_sys;
  bool first;             // the band's column 0: E takes the NEG + go floor
  int* right;             // this strip's last H column, or null
  int* right_e;
  int* right_flag;
  bool right_sys;
};

// A warp's shared memory: its ring of (H[i][c0-1], Ê of the chain's start,
// Ê that column 0's H takes, q[i]) a row, and each lane's row of its
// best so far, as in band_sweep.cuh.
struct WarpSharedAffine {
  int4 ring[RING];
  int4 held[LANE_COLS / 4][LANES];
};

// The maximum of a lane's row over its columns below n (LAST: the first
// `valid`), as a tree of three-way maxima.
template <bool LAST>
__device__ __forceinline__ int lane_row_max(const int (&H)[LANE_COLS],
                                            int valid) {
  static_assert(LANE_COLS == 16, "the tree below takes 16 columns");
  int v[LANE_COLS];
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c)
    v[c] = !LAST || c < valid ? H[c] : SCORE_MIN;
  int r[5];
#pragma unroll
  for (int u = 0; u < 5; ++u)
    r[u] = max3(v[3 * u], v[3 * u + 1], v[3 * u + 2]);
  return max3(max3(r[0], r[1], r[2]), imax(r[3], r[4]), v[15]);
}

// Rows [chunk * CHUNK, +CHUNK) of the left columns and the query into the
// ring, one row a lane; lane 0 waits for them where they are published.
__device__ __forceinline__ void stage(const BandAffine& B,
                                      const EdgesAffine& E, int4* ring,
                                      int chunk) {
  const int r0 = chunk * CHUNK;
  if (r0 >= B.h) return;
  const int lane = (int)(threadIdx.x & 31);
  if (E.left) {
    if (lane == 0) wait_rows(E.left_flag, imin(B.h, r0 + CHUNK), E.left_sys);
    __syncwarp();
  }
  const int r = r0 + lane;
  if (lane < CHUNK && r < B.h) {
    int h, e;
    if (!E.left) {
      h = B.left_in[r];
      e = B.left_in_e[r];
    } else if (E.left_sys) {
      h = load_sys(E.left + r);
      e = load_sys(E.left_e + r);
    } else {
      h = load_cg(E.left + r);
      e = load_cg(E.left_e + r);
    }
    const int go_ge = B.go + B.ge;
    // E of the strip's first column, in the H form
    const int e0 = imax(e + B.ge, h + go_ge);
    const int e0_floor = E.first ? imax(e0, NEG + B.go) : e0;
    ring[r & (RING - 1)] = int4{h, e0 - go_ge, e0_floor - go_ge, (int)B.q[r]};
  }
  __syncwarp();
}

// Strip k of the band. LAST: the strip that holds column n - 1.
template <bool LOCAL, bool LAST>
__device__ void sweep_strip(const BandAffine& B, int k, WarpSharedAffine& sh) {
  const int lane = (int)(threadIdx.x & 31);
  const int c0 = k * STRIP + lane * LANE_COLS;
  const int h = B.h, ge = B.ge, go_ge = B.go + B.ge;
  EdgesAffine E;
  E.left = k > 0 ? B.bcols + (size_t)(k - 1) * h : B.halo.in;
  E.left_e = k > 0 ? B.bcols_e + (size_t)(k - 1) * h : B.halo.in_e;
  E.left_flag = k > 0 ? B.flags + (k - 1) : B.halo.in_flag;
  E.left_sys = k == 0 && B.halo.sys_in;
  E.first = k == 0;
  E.right = !LAST ? B.bcols + (size_t)k * h : B.halo.out;
  E.right_e = !LAST ? B.bcols_e + (size_t)k * h : B.halo.out_e;
  E.right_flag = !LAST ? B.flags + k : B.halo.out_flag;
  E.right_sys = LAST && B.halo.sys_out;
  // LAST: the lane's columns below n, and which of them is n - 1
  const int valid = LAST ? B.n - c0 : LANE_COLS;
  const int lc = LAST ? B.n - 1 - c0 : -1;

  int sj[LANE_COLS];
  int H[LANE_COLS];      // H[i-1][c0 + c] before row i, H[i][c0 + c] after it
  int F[LANE_COLS];      // F likewise
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    const int j = c0 + c;
    const bool in = !LAST || c < valid;
    sj[c] = in ? (int)B.s[j] : -1;
    H[c] = in ? B.top[j] : 0;
    F[c] = in ? B.top_f[j] : 0;
  }
  // H[i-1][c0-1]
  int diag_in = c0 == 0 ? (B.halo.corner ? load_sys(B.halo.corner) : B.corner)
                : (!LAST || c0 <= B.n) ? B.top[c0 - 1]
                                       : 0;
  int bs = SCORE_MIN, bi = -1, bj = -1;

  stage(B, E, sh.ring, 0);
  // from lane t-1: H[i][c0-1], Ê[i][c0] and q[i]
  int in_h = 0, in_e = 0, in_q = 0;
  const int steps = h + LANES - 1;
  for (int step = 0; step < steps; ++step) {
    if ((step & (CHUNK - 1)) == CHUNK - 1)
      stage(B, E, sh.ring, step / CHUNK + 1);
    const int i = step - lane;
    const bool row = i >= 0 && i < h;
    int left = in_h, eh = in_e, eh0 = in_e, qi = in_q;
    if (lane == 0) {
      const int4 r = sh.ring[step & (RING - 1)];
      left = r.x;
      eh = r.y;
      eh0 = r.z;
      qi = r.w;
    }
    if (row) {
      int diag = diag_in;
      diag_in = left;
      int e_out = 0;    // Ê of the column this lane writes out
#pragma unroll
      for (int c = 0; c < LANE_COLS; ++c) {
        const int up = H[c];
        const int f = addmax<false>(up, go_ge, F[c] + ge);
        const int t = addmax<LOCAL>(diag, qi == sj[c] ? B.match : B.mismatch,
                                    f);
        const int ec = c == 0 ? eh0 : eh;
        if (LAST ? c == lc : c == LANE_COLS - 1) e_out = ec;
        H[c] = addmax<false>(ec, go_ge, t);
        F[c] = f;
        eh = addmax<false>(eh, ge, t);    // the row's one dependent step
        diag = up;
      }
      if (LAST) {
        if (lc >= 0 && lc < LANE_COLS) {
          int v = H[0];
#pragma unroll
          for (int c = 1; c < LANE_COLS; ++c)
            if (c == lc) v = H[c];
          B.last_col[i] = v;
          B.last_col_e[i] = e_out + go_ge;
          if (E.right) {
            E.right[i] = v;
            E.right_e[i] = e_out + go_ge;
            if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
              publish(E.right_flag, i + 1, E.right_sys);
          }
        }
      } else if (lane == LANES - 1) {
        E.right[i] = H[LANE_COLS - 1];
        E.right_e[i] = e_out + go_ge;
        if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
          publish(E.right_flag, i + 1, E.right_sys);
      }
    }
    // the next step's inputs first, so that the best below overlaps them
    in_h = __shfl_up_sync(FULL, H[LANE_COLS - 1], 1);
    in_e = __shfl_up_sync(FULL, eh, 1);
    in_q = __shfl_up_sync(FULL, qi, 1);
    if (row) {
      const int row_max = lane_row_max<LAST>(H, valid);
      if (row_max > bs) {
        bs = row_max;
        bi = i;
#pragma unroll
        for (int u = 0; u < LANE_COLS / 4; ++u)
          sh.held[u][lane] = int4{H[4 * u], H[4 * u + 1], H[4 * u + 2],
                                  H[4 * u + 3]};
      }
    }
  }

#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    if (!LAST || c < valid) {
      B.row_out[c0 + c] = H[c];
      B.rowf_out[c0 + c] = F[c];
    }
  }

  // the first column of the best row that holds the best
  if (bi >= 0) {
#pragma unroll
    for (int u = LANE_COLS / 4 - 1; u >= 0; --u) {
      const int4 w = sh.held[u][lane];
      const int v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int c = 4 * u + e;
        if ((!LAST || c < valid) && v[e] == bs) bj = c0 + c;
      }
    }
  }
#pragma unroll
  for (int d = LANES / 2; d > 0; d /= 2) {
    const int os = __shfl_xor_sync(FULL, bs, d);
    const int oi = __shfl_xor_sync(FULL, bi, d);
    const int oj = __shfl_xor_sync(FULL, bj, d);
    if (better(os, oi, oj, bs, bi, bj)) {
      bs = os;
      bi = oi;
      bj = oj;
    }
  }
  if (lane == 0) {
    int* best = B.bests + 3 * k;
    best[0] = bs;
    best[1] = bi;
    best[2] = bj;
  }
  __syncwarp();   // the ring is free for the warp's next strip
}

}  // namespace band_affine_core
}  // namespace anyseq
