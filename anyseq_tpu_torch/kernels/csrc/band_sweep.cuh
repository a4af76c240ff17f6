// The strip core of K8 and K10 (band.cu): one 1024-column strip of a band
// of the linear-gap DP, swept by one warp.
//
// Lane t owns the 32 consecutive columns [col0 + 32t, +32) and keeps their
// previous-row scores and its subject symbols in registers. At step
// `step` lane t works on row i = step - t: lane t-1 finished row i one
// step earlier, and hands over H[i][its last column] and q[i] with
// __shfl_up_sync; lane 0 takes the two from a ring in shared memory that
// the warp stages CHUNK rows at a time, one row a lane, in the step before
// the rows are needed. No CTA barrier runs: each of a CTA's WARPS warps
// claims and sweeps strips on its own. A CTA of four warps puts one on
// each of the SM's four schedulers, so that no scheduler holds more of a
// launch's warps than another: the slowest strip paces every strip to
// its right.
//
// The left column of strip k > 0 is the last column of strip k-1, which
// its warp writes into `bcols` and publishes every CHUNK rows through a
// progress flag (common.cuh publish); strip 0 reads the band's explicit
// left column, or (K10) the halo that the rank on the left publishes the
// same way. One lane waits on a flag, sleeping between looks, while the
// other lanes wait at __syncwarp and run nothing. A strip's
// first row therefore waits on its left neighbour's first CHUNK rows plus
// the warp's 31-step pipeline: strips start ~63 steps apart.
//
// A cell is H = max(diag + sub, up + g, left + g [, 0]): the first two
// terms off the chain with __viaddmax_s32, the last on it with one more
// (its _relu form for LOCAL) -- one DPX instruction a column on the
// dependent chain. int32 max is exact and the adds wrap as in the plain
// version, so the order of the maxima changes no value.
//
// Each strip's first maximum in row-major order, (score, i, j): a lane
// takes its row's maximum with __vimax3_s32, and only where that beats
// its best (strictly, so the earliest row keeps a tie) stores the row in
// shared memory (eight 16-byte stores, off the integer pipe); at the end
// it finds the first column of that row that holds the best, and the
// warp reduces the lanes by (score, i, j).
//
// Full strips carry no bound checks; the strip that holds column n - 1
// runs the LAST variant, which masks columns past n - 1, writes the last
// column (and, K10, the right halo) from the lane that holds column n - 1.
#pragma once

#include "common.cuh"

namespace anyseq {
namespace band_core {

constexpr int LANES = 32;                   // a warp sweeps a strip
constexpr int WARPS = 4;                    // a CTA
constexpr int LANE_COLS = 32;
constexpr int STRIP = LANES * LANE_COLS;    // = kernels/_sweep.py STRIP
constexpr int CHUNK = 32;                   // rows published / staged at a time
constexpr int RING = 2 * CHUNK;
static_assert(CHUNK <= LANES && (CHUNK & (CHUNK - 1)) == 0,
              "a chunk is staged one row a lane");
constexpr unsigned FULL = 0xffffffffu;

// The halo hand-off of one K10 launch (all null for K8).
struct Halo {
  const int* in;         // rows [i0, i0 + h) of the column left of the stripe
  const int* in_flag;    // rows of `in` published in this band
  int* out;              // rows [i0, i0 + h) of the right rank's halo
  int* out_flag;
  const int* corner;     // H[i0-1][-1] on the device, or null
  bool sys_in, sys_out;  // across cards
};

// One launch: the band, its boundary, the hand-off scratch and outputs.
struct Band {
  const uint8_t* q;
  int h;                   // rows of the band
  const uint8_t* s;
  int n;                   // columns
  int match, mismatch, gap;
  const int* top;          // H[i0-1][0..n)
  int corner;              // H[i0-1][-1] where halo.corner is null
  const int* left_in;      // H[i0..i0+h)[-1] where halo.in is null
  Halo halo;
  int strips;
  int workers;             // warps that claim strips (the launch's grid)
  int* ticket;             // strips claimed so far
  int* bcols;              // (strips - 1) x h: strip k's last column at k * h
  int* flags;              // rows of bcols[k] published
  int* row_out;            // H[i0+h-1][0..n)
  int* last_col;           // H[i0..i0+h)[n-1]
  int* bests;              // (score, i, j) a strip
};

// One lane of the warp waits until *flag >= value, as common.cuh
// wait_for does for every thread of a CTA (a sleep between looks; a wait
// of 2^34 cycles, ~9 s, means a broken schedule and traps).
__device__ __forceinline__ void wait_rows(const int* flag, int value,
                                          bool sys) {
#ifdef ANYSEQ_HOST_EMU
  (void)sys;
  emu_wait_published(flag, value);
#else
  wait_for(flag, value, sys);
#endif
}

// (a better than b): higher score, then smaller i, then smaller j -- the
// first maximum in row-major order.
__device__ __forceinline__ bool better(int as, int ai, int aj, int bs, int bi,
                                       int bj) {
  return as > bs || (as == bs && (ai < bi || (ai == bi && aj < bj)));
}

// Where one strip reads its left column and writes its right one.
struct Edges {
  const int* left;        // flagged left column, or null: B.left_in
  const int* left_flag;
  bool left_sys;
  int* right;             // this strip's last column, or null
  int* right_flag;
  bool right_sys;
};

// Rows [chunk * CHUNK, +CHUNK) of the left column and the query into the
// ring, one row a lane; lane 0 waits for them where they are published.
__device__ __forceinline__ void stage(const Band& B, const Edges& E,
                                      unsigned long long* ring, int chunk) {
  const int r0 = chunk * CHUNK;
  if (r0 >= B.h) return;
  const int lane = (int)(threadIdx.x & 31);
  if (E.left) {
    if (lane == 0) wait_rows(E.left_flag, imin(B.h, r0 + CHUNK), E.left_sys);
    __syncwarp();
  }
  const int r = r0 + lane;
  if (lane < CHUNK && r < B.h) {
    const int v = !E.left     ? B.left_in[r]
                  : E.left_sys ? load_sys(E.left + r)
                               : load_cg(E.left + r);
    ring[r & (RING - 1)] =
        (unsigned long long)(unsigned)v | ((unsigned long long)B.q[r] << 32);
  }
  __syncwarp();
}

// max(a + b, c), and with LOCAL's clamp at 0 (nvcc also makes VIADDMNMX
// of imax(a + b, c) by itself; the intrinsics keep it so)
template <bool RELU>
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return RELU ? __viaddmax_s32_relu(a, b, c) : __viaddmax_s32(a, b, c);
}

__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}

// A warp's shared memory: its ring, and each lane's row of its best so
// far, four columns a 16-byte word, lane-minor (conflict-free stores).
struct WarpShared {
  unsigned long long ring[RING];
  int4 held[LANE_COLS / 4][LANES];
};

// The maximum of a lane's row over its columns below n (LAST: the first
// `valid`), as a tree of three-way maxima.
template <bool LAST>
__device__ __forceinline__ int lane_row_max(const int (&H)[LANE_COLS],
                                            int valid) {
  static_assert(LANE_COLS == 32, "the tree below takes 32 columns");
  int v[LANE_COLS];
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c)
    v[c] = !LAST || c < valid ? H[c] : SCORE_MIN;
  int r[11];
#pragma unroll
  for (int u = 0; u < 10; ++u) r[u] = max3(v[3 * u], v[3 * u + 1], v[3 * u + 2]);
  r[10] = imax(v[30], v[31]);
  return imax(max3(max3(r[0], r[1], r[2]), max3(r[3], r[4], r[5]),
                   max3(r[6], r[7], r[8])),
              imax(r[9], r[10]));
}

// Strip k of the band. LAST: the strip that holds column n - 1.
template <bool LOCAL, bool LAST>
__device__ void sweep_strip(const Band& B, int k, WarpShared& sh) {
  const int lane = (int)(threadIdx.x & 31);
  const int c0 = k * STRIP + lane * LANE_COLS;
  const int h = B.h, g = B.gap;
  Edges E;
  E.left = k > 0 ? B.bcols + (size_t)(k - 1) * h : B.halo.in;
  E.left_flag = k > 0 ? B.flags + (k - 1) : B.halo.in_flag;
  E.left_sys = k == 0 && B.halo.sys_in;
  E.right = !LAST ? B.bcols + (size_t)k * h : B.halo.out;
  E.right_flag = !LAST ? B.flags + k : B.halo.out_flag;
  E.right_sys = LAST && B.halo.sys_out;
  // LAST: the lane's columns below n, and which of them is n - 1
  const int valid = LAST ? B.n - c0 : LANE_COLS;
  const int lc = LAST ? B.n - 1 - c0 : -1;

  int sj[LANE_COLS];
  int H[LANE_COLS];      // H[i-1][c0 + c] before row i, H[i][c0 + c] after it
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    const int j = c0 + c;
    const bool in = !LAST || c < valid;
    sj[c] = in ? (int)B.s[j] : -1;
    H[c] = in ? B.top[j] : 0;
  }
  // H[i-1][c0-1]
  int diag_in = c0 == 0 ? (B.halo.corner ? load_sys(B.halo.corner) : B.corner)
                : (!LAST || c0 <= B.n) ? B.top[c0 - 1]
                                       : 0;
  int bs = SCORE_MIN, bi = -1, bj = -1;

  stage(B, E, sh.ring, 0);
  int in_h = 0, in_q = 0;   // H[i][c0-1] and q[i] from lane t-1
  const int steps = h + LANES - 1;
  for (int step = 0; step < steps; ++step) {
    if ((step & (CHUNK - 1)) == CHUNK - 1)
      stage(B, E, sh.ring, step / CHUNK + 1);
    const int i = step - lane;
    const bool row = i >= 0 && i < h;
    int left = in_h, qi = in_q;
    if (lane == 0) {
      const unsigned long long r = sh.ring[step & (RING - 1)];
      left = (int)(unsigned)r;
      qi = (int)(r >> 32);
    }
    if (row) {
      int diag = diag_in;
      diag_in = left;
      int hl = left;
#pragma unroll
      for (int c = 0; c < LANE_COLS; ++c) {
        const int up = H[c];
        const int x = addmax<false>(up, g,
                                    diag + (qi == sj[c] ? B.match : B.mismatch));
        hl = addmax<LOCAL>(hl, g, x);
        diag = up;
        H[c] = hl;
      }
      if (LAST) {
        if (lc >= 0 && lc < LANE_COLS) {
          int v = H[0];
#pragma unroll
          for (int c = 1; c < LANE_COLS; ++c)
            if (c == lc) v = H[c];
          B.last_col[i] = v;
          if (E.right) {
            E.right[i] = v;
            if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
              publish(E.right_flag, i + 1, E.right_sys);
          }
        }
      } else if (lane == LANES - 1) {
        E.right[i] = hl;
        if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
          publish(E.right_flag, i + 1, E.right_sys);
      }
    }
    // the next step's inputs first, so that the best below overlaps them
    in_h = __shfl_up_sync(FULL, H[LANE_COLS - 1], 1);
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
  for (int c = 0; c < LANE_COLS; ++c)
    if (!LAST || c < valid) B.row_out[c0 + c] = H[c];

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

// Claims the next strip for the warp. Strips are handed out in increasing
// order, so the strip a warp waits on was claimed earlier by a warp that
// is already running: no launch size can deadlock.
__device__ __forceinline__ int claim(int* ticket) {
  int k = 0;
  if ((threadIdx.x & 31) == 0) k = atomicAdd(ticket, 1);
  return __shfl_sync(FULL, k, 0);
}

// Steps from a strip's start to its right neighbour's: a chunk of rows
// and the warp's pipeline.
constexpr int LAG = CHUNK + LANES - 1;

// The warps of `kernel` (CTAs of WARPS warps, one warp a strip) that sweep
// a launch's `strips` strips of h rows, of which `share` launches run on
// the card together (K10's ranks of one card): every strip at once where
// the card's share holds them all and the band is tall enough to keep
// them busy; else as many as it holds, or as the band keeps busy, spread
// over equal rounds, so that no last round runs a few strips alone. A
// strip starts LAG steps after the one to its left and sweeps h + 31
// steps, so about (h + 31) / LAG strips run at once: more warps would
// only wait, and take scheduler slots from those that run. `max_grid` > 0
// overrides the choice (at most the share of the card, so that the ranks
// of a sweep stay resident together). The CTAs an SM holds are the
// kernel's own (its registers bound them). K8 and K8 affine choose by
// this one rule.
inline int grid_of(const void* kernel, int h, int strips, int share,
                   int max_grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                LANES * WARPS, 0);
  const int parts = share > 1 ? share : 1;
  const int resident = imax(per_sm * sms / parts, 1) * WARPS;
  if (max_grid > 0) return imin(strips, imin(max_grid, resident));
  const int busy = (h + LANES - 1 + LAG - 1) / LAG + 1;
  const int cap = imin(resident, busy);
  const int rounds = (strips + cap - 1) / cap;
  return (strips + rounds - 1) / rounds;
}

}  // namespace band_core
}  // namespace anyseq
