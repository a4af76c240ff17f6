// The strip core of K8 affine and K10 affine (band_affine.cu), of K5 and
// K5p, the single-pair affine sweep score only and with 4-bit codes
// (band_affine.cu anyseq_sweep_affine), of K5L, the affine level sweep
// (lastcols_affine.cu, a band a problem), and of K7's affine mode
// (swarm.cu, with 4-bit codes where asked): one strip of a band of the
// affine-gap (Gotoh) DP, swept by one warp. The
// affine twin of band_sweep.cuh, whose lanes, CTAs, strip shapes (Geom),
// staging rhythm, flags, claim, grid rule and width rule it shares.
//
// Lane t owns the LANE_COLS consecutive columns [col0 + LANE_COLS * t,
// +LANE_COLS) (16 for K8 affine and K10 affine; 16, 8 or 4 for K5, by the
// width rule: at 16 K8 affine's kernel itself, narrower two rows a lane a
// step, sweep_strip2, in the CLOSED form) and keeps H[i-1][j] and
// F[i-1][j] of each, and its subject symbols, in registers.
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
// K8 affine takes half the linear core's 32 columns a lane: the same band
// then has twice the strips and warps, and an H100 ran it 10% faster at
// 1 M columns and 20% faster at 2.2 M than with 32 columns a lane (167
// registers, 12 warps an SM; 16 columns: 117 and 16; PERF.md). Two rows a
// step ran K5 at 8 and 4 columns a lane 10-13% faster than one (PERF.md),
// the linear core's K1 no faster, so only this core has them.
#pragma once

#include "band_sweep.cuh"

namespace anyseq {
namespace band_affine_core {

using band_core::addmax;
using band_core::claim;
using band_core::Codes;
using band_core::FULL;
using band_core::Geom;
using band_core::LANES;
using band_core::lane_row_max;
using band_core::OUT_ALL;
using band_core::OUT_BEST;
using band_core::OUT_CODES;
using band_core::OUT_COL;
using band_core::OUT_COL_E;
using band_core::OUT_ROW;
using band_core::OUT_ROW_F;
using band_core::store_best;
using band_core::wait_rows;
using band_core::WARPS;

// K8 affine and K10 affine: 512-column strips (= kernels/band.py
// AFFINE_LANE_COLS)
using BandGeom = Geom<16>;
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
  // CLOSED: the closed form's H[-1][j] = top_base + (j + 1) * top_step and
  // H[r][-1] = left_base + (r + 1) * left_step (below)
  int top_base, top_step, left_base, left_step;
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
  unsigned* codes;         // OUT_CODES: row i's code words at i * code_words
  int code_words;
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
// Ê that column 0's H takes, q[i]) a row, each lane's row of its best so
// far, and (OUT_CODES) its ring of staged code segments, as in
// band_sweep.cuh.
template <class G, int CODE_BITS = 0>
struct WarpSharedAffine {
  int4 ring[G::RING];
  int4 held[G::LANE_COLS / 4][LANES];
  band_core::CodeRing<G, CODE_BITS> codes;
};

// The 4-bit code of a cell, PH | PE << 2 | PF << 3 (engine/affine.py
// pred_codes4): PH by diag > E > F as selects, PRED_NONE for a LOCAL
// cell clamped at 0; PE where E does not open from H[i][j-1] (Ê[j] !=
// H[i][j-1], as E = Ê + go + ge), PF where F does not open from H[i-1][j].
__device__ __forceinline__ int code4(int h, int dsub, int e_hat, int go_ge,
                                     int f, int h_left, int up) {
  int ph = h == f ? PRED_GAP_S : PRED_NONE;
  ph = h == e_hat + go_ge ? PRED_GAP_Q : ph;
  ph = h == dsub ? PRED_NO_GAP : ph;
  return ph | (e_hat != h_left) << 2 | (f != up + go_ge) << 3;
}

// CLOSED (K5, a whole single-pair sweep): the band's top rows and left
// columns are the sweep's closed-form boundary (engine/affine.py
// top_row_affine, left_col_affine), computed where they are read: H of
// the top row and of the left column from their base and step (GLOBAL:
// go + (j + 1) * ge, or (j + 1) * ge and NEG under start_gap; else 0), F
// of the top row NEG, E of the left column NEG + go - ge.
template <bool CLOSED>
__device__ __forceinline__ int top_at(const BandAffine& B, int j) {
  return CLOSED ? band_core::closed(j, B.top_base, B.top_step) : B.top[j];
}

// Rows [chunk * CHUNK, +CHUNK) of the left columns and the query into the
// ring, one row a lane; lane 0 waits for them where they are published.
template <class G, bool CLOSED>
__device__ __forceinline__ void stage(const BandAffine& B,
                                      const EdgesAffine& E, int4* ring,
                                      int chunk) {
  const int r0 = chunk * G::CHUNK;
  if (r0 >= B.h) return;
  const int lane = (int)(threadIdx.x & 31);
  if (E.left) {
    if (lane == 0)
      wait_rows(E.left_flag, imin(B.h, r0 + G::CHUNK), E.left_sys);
    __syncwarp();
  }
  const int r = r0 + lane;
  if (lane < G::CHUNK && r < B.h) {
    int h, e;
    if (!E.left && CLOSED) {
      h = band_core::closed(r, B.left_base, B.left_step);
      e = NEG + B.go - B.ge;
    } else if (!E.left) {
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
    ring[r & (G::RING - 1)] =
        int4{h, e0 - go_ge, e0_floor - go_ge, (int)B.q[r]};
  }
  __syncwarp();
}

// Where strip k reads its left columns (strip k - 1's published ones, or
// for strip 0 the halo or the band's own) and writes its right ones (into
// bcols for strip k + 1, or from the last strip the right halo).
template <bool LAST>
__device__ __forceinline__ EdgesAffine edges_of(const BandAffine& B, int k) {
  const int h = B.h;
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
  return E;
}

// A lane's subject symbols and the band's top rows H and F at its columns
// c0 + c (LAST: those below n, `valid`); returns H[i0-1][c0-1], the
// diagonal of its first column.
template <bool LAST, bool CLOSED, int LANE_COLS>
__device__ __forceinline__ int load_top(const BandAffine& B, int c0,
                                        int valid, int (&sj)[LANE_COLS],
                                        int (&H)[LANE_COLS],
                                        int (&F)[LANE_COLS]) {
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    const int j = c0 + c;
    const bool in = !LAST || c < valid;
    sj[c] = in ? (int)B.s[j] : -1;
    H[c] = in ? top_at<CLOSED>(B, j) : 0;
    F[c] = !in ? 0 : CLOSED ? NEG : B.top_f[j];
  }
  return c0 == 0 ? (B.halo.corner ? load_sys(B.halo.corner) : B.corner)
         : (!LAST || c0 <= B.n) ? top_at<CLOSED>(B, c0 - 1)
                                : 0;
}

// A lane's columns of the band's bottom rows H and (ROW_F) F.
template <bool LAST, bool ROW_F, int LANE_COLS>
__device__ __forceinline__ void store_rows(const BandAffine& B, int c0,
                                           int valid,
                                           const int (&H)[LANE_COLS],
                                           const int (&F)[LANE_COLS]) {
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    if (!LAST || c < valid) {
      B.row_out[c0 + c] = H[c];
      if (ROW_F) B.rowf_out[c0 + c] = F[c];
    }
  }
}

// Strip k of the band. LAST: the strip that holds column n - 1; OUT: what
// it writes (band_sweep.cuh; OUT_CODES: 4-bit codes, CB = 4).
template <bool LOCAL, bool LAST, class G, bool CLOSED, int OUT = OUT_ALL,
          int CB = 0>
__device__ void sweep_strip(const BandAffine& B, int k,
                            WarpSharedAffine<G, CB>& sh) {
  constexpr int LANE_COLS = G::LANE_COLS, CHUNK = G::CHUNK;
  constexpr bool CODES = (OUT & OUT_CODES) != 0;
  static_assert(!CODES || CB == 4, "4-bit codes");
  using Cw = Codes<G, 4>;
  const int lane = (int)(threadIdx.x & 31);
  const int c0 = k * G::STRIP + lane * LANE_COLS;
  const int h = B.h, ge = B.ge, go_ge = B.go + B.ge;
  const EdgesAffine E = edges_of<LAST>(B, k);
  // LAST: the lane's columns below n, and which of them is n - 1
  const int valid = LAST ? B.n - c0 : LANE_COLS;
  const int lc = LAST ? B.n - 1 - c0 : -1;

  int sj[LANE_COLS];
  int H[LANE_COLS];      // H[i-1][c0 + c] before row i, H[i][c0 + c] after it
  int F[LANE_COLS];      // F likewise
  // H[i-1][c0-1]
  int diag_in = load_top<LAST, CLOSED>(B, c0, valid, sj, H, F);
  int bs = SCORE_MIN, bi = -1;
  const Cw cw(B.codes, B.code_words, c0, B.n, h);

  stage<G, CLOSED>(B, E, sh.ring, 0);
  // from lane t-1: H[i][c0-1], Ê[i][c0] and q[i]
  int in_h = 0, in_e = 0, in_q = 0;
  const int steps = h + LANES - 1;
  for (int step = 0; step < steps; ++step) {
    if ((step & (CHUNK - 1)) == CHUNK - 1)
      stage<G, CLOSED>(B, E, sh.ring, step / CHUNK + 1);
    const int i = step - lane;
    const bool row = i >= 0 && i < h;
    int left = in_h, eh = in_e, eh0 = in_e, qi = in_q;
    if (lane == 0) {
      const int4 r = sh.ring[step & (G::RING - 1)];
      left = r.x;
      eh = r.y;
      eh0 = r.z;
      qi = r.w;
    }
    if (row) {
      int diag = diag_in;
      diag_in = left;
      int e_out = 0;    // Ê of the column this lane writes out
      typename Cw::Seg bits = 0;
#pragma unroll
      for (int c = 0; c < LANE_COLS; ++c) {
        const int up = H[c];
        const int f = addmax<false>(up, go_ge, F[c] + ge);
        const int sub = qi == sj[c] ? B.match : B.mismatch;
        const int t = addmax<LOCAL>(diag, sub, f);
        const int ec = c == 0 ? eh0 : eh;
        if (LAST ? c == lc : c == LANE_COLS - 1) e_out = ec;
        H[c] = addmax<false>(ec, go_ge, t);
        if constexpr (CODES) {
          int code = code4(H[c], diag + sub, ec, go_ge, f,
                           c == 0 ? left : H[c - 1], up);
          if (LAST) code = c < valid ? code : 0;
          bits |= (typename Cw::Seg)code << (4 * c);
        }
        F[c] = f;
        eh = addmax<false>(eh, ge, t);    // the row's one dependent step
        diag = up;
      }
      if constexpr (CODES) cw.put(sh.codes, i, bits);
      if (LAST) {
        if constexpr ((OUT & OUT_COL) != 0) {
          if (lc >= 0 && lc < LANE_COLS) {
            int v = H[0];
#pragma unroll
            for (int c = 1; c < LANE_COLS; ++c)
              if (c == lc) v = H[c];
            B.last_col[i] = v;
            if constexpr ((OUT & OUT_COL_E) != 0)
              B.last_col_e[i] = e_out + go_ge;
            if (E.right) {
              E.right[i] = v;
              E.right_e[i] = e_out + go_ge;
              if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
                publish(E.right_flag, i + 1, E.right_sys);
            }
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
    if constexpr (CODES) cw.flush(sh.codes, step);
    if constexpr ((OUT & OUT_BEST) != 0) {
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
  }

  if constexpr ((OUT & OUT_ROW) != 0)
    store_rows<LAST, (OUT & OUT_ROW_F) != 0>(B, c0, valid, H, F);
  if constexpr ((OUT & OUT_BEST) != 0)
    store_best<LAST, LANE_COLS>(sh.held, B, k, c0, valid, bs, bi);
  __syncwarp();   // the ring is free for the warp's next strip
}

// Strip k of the band, two rows a lane a step (Geom ROWS = 2; K5 at 8
// and 4 columns a lane): sweep_strip's cell, with the second row one
// column behind the first, so that the two E chains of a lane overlap,
// and the hand-off (five values), ring reads and loop serve two rows. Odd
// h: a lane's last step sweeps the one row left.
template <bool LOCAL, bool LAST, class G, bool CLOSED, int OUT = OUT_ALL,
          int CB = 0>
__device__ void sweep_strip2(const BandAffine& B, int k,
                             WarpSharedAffine<G, CB>& sh) {
  constexpr int LANE_COLS = G::LANE_COLS, CHUNK = G::CHUNK;
  constexpr int STEPS = G::CHUNK_STEPS;
  constexpr bool CODES = (OUT & OUT_CODES) != 0;
  static_assert(!CODES || CB == 4, "4-bit codes");
  using Cw = Codes<G, 4>;
  using Seg = typename Cw::Seg;
  const int lane = (int)(threadIdx.x & 31);
  const int c0 = k * G::STRIP + lane * LANE_COLS;
  const int h = B.h, ge = B.ge, go_ge = B.go + B.ge;
  const int match = B.match, mismatch = B.mismatch;
  const EdgesAffine E = edges_of<LAST>(B, k);
  const int valid = LAST ? B.n - c0 : LANE_COLS;
  const int lc = LAST ? B.n - 1 - c0 : -1;

  int sj[LANE_COLS];
  int H[LANE_COLS];      // H[i0-1][c0 + c] before the pair, H[i0+1] after
  int F[LANE_COLS];      // F likewise
  // H[i0-1][c0-1]
  int diag_in = load_top<LAST, CLOSED>(B, c0, valid, sj, H, F);
  int bs = SCORE_MIN, bi = -1;
  const Cw cw(B.codes, B.code_words, c0, B.n, h);

  stage<G, CLOSED>(B, E, sh.ring, 0);
  // from lane t-1: H[i0][c0-1], H[i0+1][c0-1], Ê[i0][c0], Ê[i0+1][c0],
  // q[i0] | q[i0+1] << 8
  int in_h0 = 0, in_h1 = 0, in_e0 = 0, in_e1 = 0, in_q = 0;
  int R0[LANE_COLS] = {};    // H[i0][c0 + c]
  const int pairs = (h + 1) / 2;
  const int steps = pairs + LANES - 1;
  for (int step = 0; step < steps; ++step) {
    if ((step & (STEPS - 1)) == STEPS - 1)
      stage<G, CLOSED>(B, E, sh.ring, step / STEPS + 1);
    const int p = step - lane;
    const int i0 = 2 * p;
    const bool row = p >= 0 && p < pairs;
    int left0 = in_h0, left1 = in_h1, qq = in_q;
    int e0 = in_e0, e0_first = in_e0, e1 = in_e1, e1_first = in_e1;
    if (lane == 0) {
      const int4 r0 = sh.ring[(2 * step) & (G::RING - 1)];
      const int4 r1 = sh.ring[(2 * step + 1) & (G::RING - 1)];
      left0 = r0.x;
      e0 = r0.y;
      e0_first = r0.z;
      left1 = r1.x;
      e1 = r1.y;
      e1_first = r1.z;
      qq = r0.w | (r1.w << 8);
    }
    const bool second = i0 + 1 < h;
    if (row) {
      const int q0 = qq & 0xff, q1 = qq >> 8;
      int d0 = diag_in, d1 = left0;
      diag_in = left1;
      int e_out0 = 0, e_out1 = 0;   // Ê of the column this lane writes out
      Seg bits0 = 0, bits1 = 0;
      if (second) {
#pragma unroll
        for (int c = 0; c < LANE_COLS; ++c) {
          const int up = H[c];
          const int f0 = addmax<false>(up, go_ge, F[c] + ge);
          const int sub0 = q0 == sj[c] ? match : mismatch;
          const int t0 = addmax<LOCAL>(d0, sub0, f0);
          const int ec0 = c == 0 ? e0_first : e0;
          const int h0 = addmax<false>(ec0, go_ge, t0);
          e0 = addmax<false>(e0, ge, t0);
          const int f1 = addmax<false>(h0, go_ge, f0 + ge);
          const int sub1 = q1 == sj[c] ? match : mismatch;
          const int t1 = addmax<LOCAL>(d1, sub1, f1);
          const int ec1 = c == 0 ? e1_first : e1;
          const int h1 = addmax<false>(ec1, go_ge, t1);
          e1 = addmax<false>(e1, ge, t1);
          if (LAST ? c == lc : c == LANE_COLS - 1) {
            e_out0 = ec0;
            e_out1 = ec1;
          }
          if constexpr (CODES) {
            int code0 = code4(h0, d0 + sub0, ec0, go_ge, f0,
                              c == 0 ? left0 : R0[c - 1], up);
            int code1 = code4(h1, d1 + sub1, ec1, go_ge, f1,
                              c == 0 ? left1 : H[c - 1], h0);
            if (LAST) {
              code0 = c < valid ? code0 : 0;
              code1 = c < valid ? code1 : 0;
            }
            bits0 |= (Seg)code0 << (4 * c);
            bits1 |= (Seg)code1 << (4 * c);
          }
          d0 = up;
          d1 = h0;
          R0[c] = h0;
          H[c] = h1;
          F[c] = f1;
        }
      } else {
        // the band's last row alone
#pragma unroll
        for (int c = 0; c < LANE_COLS; ++c) {
          const int up = H[c];
          const int f0 = addmax<false>(up, go_ge, F[c] + ge);
          const int sub0 = q0 == sj[c] ? match : mismatch;
          const int t0 = addmax<LOCAL>(d0, sub0, f0);
          const int ec0 = c == 0 ? e0_first : e0;
          if (LAST ? c == lc : c == LANE_COLS - 1) e_out0 = ec0;
          const int h0 = addmax<false>(ec0, go_ge, t0);
          if constexpr (CODES) {
            int code0 = code4(h0, d0 + sub0, ec0, go_ge, f0,
                              c == 0 ? left0 : R0[c - 1], up);
            if (LAST) code0 = c < valid ? code0 : 0;
            bits0 |= (Seg)code0 << (4 * c);
          }
          H[c] = R0[c] = h0;
          F[c] = f0;
          e0 = addmax<false>(e0, ge, t0);
          d0 = up;
        }
      }
      if constexpr (CODES) {
        cw.put(sh.codes, i0, bits0);
        if (second) cw.put(sh.codes, i0 + 1, bits1);
      }
      if (LAST) {
        if constexpr ((OUT & OUT_COL) != 0) {
          if (lc >= 0 && lc < LANE_COLS) {
            int v0 = R0[0], v1 = H[0];
#pragma unroll
            for (int c = 1; c < LANE_COLS; ++c) {
              if (c == lc) {
                v0 = R0[c];
                v1 = H[c];
              }
            }
            B.last_col[i0] = v0;
            if constexpr ((OUT & OUT_COL_E) != 0)
              B.last_col_e[i0] = e_out0 + go_ge;
            if (second) {
              B.last_col[i0 + 1] = v1;
              if constexpr ((OUT & OUT_COL_E) != 0)
                B.last_col_e[i0 + 1] = e_out1 + go_ge;
            }
            if (E.right) {
              E.right[i0] = v0;
              E.right_e[i0] = e_out0 + go_ge;
              if (second) {
                E.right[i0 + 1] = v1;
                E.right_e[i0 + 1] = e_out1 + go_ge;
              }
              if (((i0 + 2) & (CHUNK - 1)) == 0 || i0 + 2 >= h)
                publish(E.right_flag, imin(i0 + 2, h), E.right_sys);
            }
          }
        }
      } else if (lane == LANES - 1) {
        E.right[i0] = R0[LANE_COLS - 1];
        E.right_e[i0] = e_out0 + go_ge;
        if (second) {
          E.right[i0 + 1] = H[LANE_COLS - 1];
          E.right_e[i0 + 1] = e_out1 + go_ge;
        }
        if (((i0 + 2) & (CHUNK - 1)) == 0 || i0 + 2 >= h)
          publish(E.right_flag, imin(i0 + 2, h), E.right_sys);
      }
    }
    // the next step's inputs first, so that the best below overlaps them
    in_h0 = __shfl_up_sync(FULL, R0[LANE_COLS - 1], 1);
    in_h1 = __shfl_up_sync(FULL, H[LANE_COLS - 1], 1);
    in_e0 = __shfl_up_sync(FULL, e0, 1);
    in_e1 = __shfl_up_sync(FULL, e1, 1);
    in_q = __shfl_up_sync(FULL, qq, 1);
    if constexpr (CODES) cw.flush(sh.codes, step);
    if constexpr ((OUT & OUT_BEST) != 0) {
      if (row) {
        const int m0 = lane_row_max<LAST>(R0, valid);
        const int m1 = second ? lane_row_max<LAST>(H, valid) : SCORE_MIN;
        if (imax(m0, m1) > bs) {
          // the earlier row on a tie
          const bool first = m0 >= m1;
          bs = first ? m0 : m1;
          bi = first ? i0 : i0 + 1;
#pragma unroll
          for (int u = 0; u < LANE_COLS / 4; ++u)
            sh.held[u][lane] =
                first ? int4{R0[4 * u], R0[4 * u + 1], R0[4 * u + 2],
                             R0[4 * u + 3]}
                      : int4{H[4 * u], H[4 * u + 1], H[4 * u + 2],
                             H[4 * u + 3]};
        }
      }
    }
  }

  if constexpr ((OUT & OUT_ROW) != 0)
    store_rows<LAST, (OUT & OUT_ROW_F) != 0>(B, c0, valid, H, F);
  if constexpr ((OUT & OUT_BEST) != 0)
    store_best<LAST, LANE_COLS>(sh.held, B, k, c0, valid, bs, bi);
  __syncwarp();   // the ring is free for the warp's next strip
}

// Strip k at G's rows a step.
template <bool LOCAL, bool LAST, class G, bool CLOSED, int OUT = OUT_ALL,
          int CB = 0>
__device__ __forceinline__ void sweep(const BandAffine& B, int k,
                                      WarpSharedAffine<G, CB>& sh) {
  if constexpr (G::ROWS == 2)
    sweep_strip2<LOCAL, LAST, G, CLOSED, OUT>(B, k, sh);
  else
    sweep_strip<LOCAL, LAST, G, CLOSED, OUT>(B, k, sh);
}

}  // namespace band_affine_core
}  // namespace anyseq
