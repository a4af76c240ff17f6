// The strip core of K8 and K10 (band.cu), of K1 and K2, the single-pair
// sweep score only and with codes (band.cu anyseq_sweep), of K4, the
// level sweep (lastcols.cu, a band a problem), and of K7, the batch sweep
// (swarm.cu, a band a problem, with codes where asked): one strip of a
// band of the linear-gap DP, swept by one warp.
//
// The strip's shape is a template parameter (Geom): lane t owns the
// LANE_COLS consecutive columns [col0 + LANE_COLS * t, +LANE_COLS) of a
// strip of 32 * LANE_COLS columns, and keeps their previous-row scores and
// its subject symbols in registers. K8 and K10 sweep 1024-column strips
// (32 columns a lane); K1 takes 32, 16 or 8 columns a lane by the width
// rule (width_of below), so that a subject of 100k columns, or a
// Hirschberg half of 25k, still makes enough strips to fill the card: at
// 32 it is K8's kernel on the sweep's boundary tensors, narrower the
// CLOSED form, which computes that boundary (K2: 16 or 8, CLOSED, with
// codes). At step `step`
// lane t works on row i = step - t: lane t-1 finished row i one step
// earlier, and hands over H[i][its last column] and q[i] with
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
// other lanes wait at __syncwarp and run nothing. A strip's first row
// therefore waits on its left neighbour's first CHUNK rows plus the warp's
// 31-step pipeline: strips start LAG = CHUNK + 31 (63) steps apart.
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
// shared memory (LANE_COLS / 4 16-byte stores, off the integer pipe); at
// the end it finds the first column of that row that holds the best, and
// the warp reduces the lanes by (score, i, j).
//
// Full strips carry no bound checks; the strip that holds column n - 1
// runs the LAST variant, which masks columns past n - 1, writes the last
// column (and, K10, the right halo) from the lane that holds column n - 1.
#pragma once

#include <algorithm>
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace anyseq {
namespace band_core {

constexpr int LANES = 32;                   // a warp sweeps a strip
constexpr int WARPS = 4;                    // a CTA
constexpr unsigned FULL = 0xffffffffu;

// The shape of a strip sweep: LANE_COLS columns a lane and ROWS rows a
// lane a step (1, or 2 in the affine core's sweep_strip2); the boundary is
// published and staged CHUNK rows at a time, one row a lane (16-row chunks
// ran slower at every shape measured, PERF.md).
template <int LANE_COLS_, int ROWS_ = 1>
struct Geom {
  static constexpr int LANE_COLS = LANE_COLS_;
  static constexpr int STRIP = LANES * LANE_COLS;
  static constexpr int CHUNK = 32;
  static constexpr int RING = 2 * CHUNK;
  static constexpr int ROWS = ROWS_;
  static constexpr int CHUNK_STEPS = CHUNK / ROWS;
  // steps from a strip's start to its right neighbour's: a chunk of rows
  // and the warp's pipeline
  static constexpr int LAG = CHUNK_STEPS + LANES - 1;
  static_assert(LANE_COLS >= 4 && LANE_COLS % 4 == 0,
                "a lane's best row is held four columns a 16-byte word");
  static_assert(ROWS == 1 || ROWS == 2, "one or two rows a step");
};

// K8 and K10: 1024-column strips (= kernels/band.py LANE_COLS).
using BandGeom = Geom<32>;

// What a strip sweep writes, a template flag of both cores: each strip's
// first maximum (bests), the band's bottom row (row_out; affine also
// rowf_out, OUT_ROW_F) and its last column (last_col, and K10's right
// halo; affine also last_col_e, OUT_COL_E), and each cell's code
// (OUT_CODES, below). K8, K10, K1 and K5 write all but the codes, K2 and
// K5p all of them; the
// level sweeps only what they return (K4 the bottom row, K5L the H and E
// last columns), and their GLOBAL problems need no best; the batch sweep
// K7 the bottom row, the H last column, the best where LOCAL and the
// codes where asked.
constexpr int OUT_BEST = 1, OUT_ROW = 2, OUT_COL = 4, OUT_COL_E = 8,
              OUT_ROW_F = 16, OUT_CODES = 32;
constexpr int OUT_ALL = OUT_BEST | OUT_ROW | OUT_COL | OUT_COL_E | OUT_ROW_F;

// A strip shape G, whether a kernel reads the band's boundary from
// tensors (K8's, K8 affine's) or computes the closed form of a whole
// sweep (CLOSED: K1, K2, K5, K5p), and the bits of a cell's code it
// writes (CB: K2 2, K5p 4; 0: none).
template <class G_, bool CLOSED_, int CB_ = 0>
struct Form {
  using G = G_;
  static constexpr bool CLOSED = CLOSED_;
  static constexpr int CB = CB_;
};

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
  int edge;                // CLOSED: the closed form's step (below)
  Halo halo;
  int strips;
  int workers;             // warps that claim strips (the launch's grid)
  int* ticket;             // strips claimed so far
  int* bcols;              // (strips - 1) x h: strip k's last column at k * h
  int* flags;              // rows of bcols[k] published
  int* row_out;            // H[i0+h-1][0..n)
  int* last_col;           // H[i0..i0+h)[n-1]
  int* bests;              // (score, i, j) a strip
  unsigned* codes;         // OUT_CODES: row i's code words at i * code_words
  int code_words;
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

// base + (x + 1) * step, wrapping in 32 bits as the plain version's int32
// tensors do.
__device__ __forceinline__ int closed(int x, int base, int step) {
  return (int)((unsigned)base + (unsigned)(x + 1) * (unsigned)step);
}

// CLOSED (K1, a whole single-pair sweep): the band's top row and left
// column are the sweep's closed-form boundary, H[-1][j] = (j + 1) * edge
// and H[r][-1] = (r + 1) * edge (edge: the gap for GLOBAL, else 0; the
// corner 0), computed where they are read instead of read from `top` and
// `left_in`.
template <bool CLOSED>
__device__ __forceinline__ int top_at(const Band& B, int j) {
  return CLOSED ? closed(j, 0, B.edge) : B.top[j];
}

// Rows [chunk * CHUNK, +CHUNK) of the left column and the query into the
// ring, one row a lane; lane 0 waits for them where they are published.
template <class G, bool CLOSED>
__device__ __forceinline__ void stage(const Band& B, const Edges& E,
                                      unsigned long long* ring, int chunk) {
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
    const int v = !E.left     ? (CLOSED ? closed(r, 0, B.edge) : B.left_in[r])
                  : E.left_sys ? load_sys(E.left + r)
                               : load_cg(E.left + r);
    ring[r & (G::RING - 1)] =
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

// --- OUT_CODES: each cell's code, in the walks' layout (K3's 2-bit
// codes, 16 a word, or K6's 4-bit codes, 8 a word, row-major: the code of
// column j in bits CODE_BITS * (j % per word) of word j / per word of its
// row). A lane's codes of one row are LANE_COLS x CODE_BITS bits (16 to
// 64) from bit 0 (its first column) up: one segment of the row, at byte
// c0 x CODE_BITS / 8. At a step the 32 lanes are on 32 rows, so their
// stores would land in 32 places. The segments are staged instead: each
// lane keeps its segments of the rows in flight in a ring in shared
// memory, one slot a lane and row (its own: no lane reads another's, so
// no barrier), and at step s, when lane 31 has finished row s - 31 (two
// rows, s - 31's pair, at two rows a step), every lane stores its segment
// of that row: the warp writes the row whole. On an H100
// (tools/k7_probe.py --sweep builds a copy that stores each segment
// directly; PERF.md) staging won with 16-bit segments (K7 at 8 columns a
// lane linear, 4 affine: 18-24%), tied with 32-bit ones (8 affine) and
// lost 4% with 32- and 64-bit ones (16 linear), where storing directly
// made ptxas spill. Segments of columns past n are not stored; codes of
// those columns inside a stored segment are 0.

// A lane's segment: 16, 32 or 64 bits.
template <int BITS>
using Segment = typename std::conditional<
    BITS == 16, unsigned short,
    typename std::conditional<BITS == 32, unsigned,
                              unsigned long long>::type>::type;

// The ring of a warp's staged segments: a slot a lane for each row in
// flight (32 rows at one row a step, 64 at two); empty without codes
// (CODE_BITS 0).
template <class G, int CODE_BITS>
struct CodeRing {
  static constexpr int ROWS = LANES * G::ROWS;
  Segment<G::LANE_COLS * CODE_BITS> slot[ROWS][LANES];
};
template <class G>
struct CodeRing<G, 0> {};

// One lane's writer of a strip's codes; the ring is the warp's (in shared
// memory, passed at each use so that it is addressed as such).
template <class G, int CODE_BITS>
struct Codes {
  static constexpr int LANE_BITS = G::LANE_COLS * CODE_BITS;
  static constexpr int ROWS = LANES * G::ROWS;
  using Ring = CodeRing<G, CODE_BITS>;
  using Seg = Segment<LANE_BITS>;
  unsigned char* seg;   // the lane's segment of row 0, or null: past n
  int row_bytes;
  int h;
  bool hi;              // 64-bit segments: a column below n in the upper word

  __device__ __forceinline__ Codes(const unsigned* codes, int code_words,
                                   int c0, int n, int h_)
      : seg(c0 < n ? (unsigned char*)codes + (size_t)c0 * CODE_BITS / 8
                   : nullptr),
        row_bytes(code_words * 4),
        h(h_),
        hi(c0 + G::LANE_COLS / 2 < n) {}

  __device__ __forceinline__ void store(int r, Seg bits) const {
    if (!seg) return;
    unsigned char* p = seg + (size_t)r * row_bytes;
    if constexpr (LANE_BITS <= 32) {
      *(Seg*)p = bits;
    } else {
      // rows are 4-byte aligned only: two words
      ((unsigned*)p)[0] = (unsigned)bits;
      if (hi) ((unsigned*)p)[1] = (unsigned)(bits >> 32);
    }
  }

  // row r's segment, at the step the lane sweeps it
  __device__ __forceinline__ void put(Ring& ring, int r, Seg bits) const {
    ring.slot[r & (ROWS - 1)][threadIdx.x & 31] = bits;
  }

  // after the lane's step `step`: the rows that lane 31 finished in it
  __device__ __forceinline__ void flush(const Ring& ring, int step) const {
    const int p = step - (LANES - 1);
    if (p < 0) return;
#pragma unroll
    for (int u = 0; u < G::ROWS; ++u) {
      const int r = G::ROWS * p + u;
      if (r < h) store(r, ring.slot[r & (ROWS - 1)][threadIdx.x & 31]);
    }
  }
};

// A warp's shared memory: its ring, each lane's row of its best so far,
// four columns a 16-byte word, lane-minor (conflict-free stores), and
// (OUT_CODES) its ring of staged code segments.
template <class G, int CODE_BITS = 0>
struct WarpShared {
  unsigned long long ring[G::RING];
  int4 held[G::LANE_COLS / 4][LANES];
  CodeRing<G, CODE_BITS> codes;
};

// The maximum of N values as a tree of three-way maxima.
template <int N>
__device__ __forceinline__ int max_tree(const int (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else if constexpr (N == 2) {
    return imax(v[0], v[1]);
  } else {
    constexpr int M = (N + 2) / 3;
    int r[M];
#pragma unroll
    for (int u = 0; u < N / 3; ++u)
      r[u] = max3(v[3 * u], v[3 * u + 1], v[3 * u + 2]);
    if constexpr (N % 3 == 1) r[M - 1] = v[N - 1];
    if constexpr (N % 3 == 2) r[M - 1] = imax(v[N - 2], v[N - 1]);
    return max_tree<M>(r);
  }
}

// The maximum of a lane's row over its columns below n (LAST: the first
// `valid`).
template <bool LAST, int N>
__device__ __forceinline__ int lane_row_max(const int (&H)[N], int valid) {
  int v[N];
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = !LAST || c < valid ? H[c] : SCORE_MIN;
  return max_tree<N>(v);
}

// The end of strip k's best (LAST: the strip that holds column n - 1):
// each lane finds the first column c0 + c (c < valid) of its best row bi
// that holds its best bs, from that row in `held`; the warp reduces the
// lanes by (score, i, j), and lane 0 stores the strip's (score, i, j) in
// the launch's (Band's or BandAffine's) bests. Both cores' strips end with
// it. Lane 0 forms the bests pointer itself: passed in, formed before the
// shuffles, it took K8 11 more registers.
template <bool LAST, int LANE_COLS, class BandT>
__device__ __forceinline__ void store_best(
    const int4 (&held)[LANE_COLS / 4][LANES], const BandT& B, int k, int c0,
    int valid, int bs, int bi) {
  const int lane = (int)(threadIdx.x & 31);
  int bj = -1;
  if (bi >= 0) {
#pragma unroll
    for (int u = LANE_COLS / 4 - 1; u >= 0; --u) {
      const int4 w = held[u][lane];
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
}

// Strip k of the band. LAST: the strip that holds column n - 1; OUT: what
// it writes (OUT_CODES: 2-bit codes, CB = 2).
template <bool LOCAL, bool LAST, class G, bool CLOSED, int OUT = OUT_ALL,
          int CB = 0>
__device__ void sweep_strip(const Band& B, int k, WarpShared<G, CB>& sh) {
  constexpr int LANE_COLS = G::LANE_COLS, CHUNK = G::CHUNK;
  constexpr bool CODES = (OUT & OUT_CODES) != 0;
  static_assert(!CODES || CB == 2, "2-bit codes");
  const int lane = (int)(threadIdx.x & 31);
  const int c0 = k * G::STRIP + lane * LANE_COLS;
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
    H[c] = in ? top_at<CLOSED>(B, j) : 0;
  }
  // H[i-1][c0-1]
  int diag_in = c0 == 0 ? (B.halo.corner ? load_sys(B.halo.corner) : B.corner)
                : (!LAST || c0 <= B.n) ? top_at<CLOSED>(B, c0 - 1)
                                       : 0;
  int bs = SCORE_MIN, bi = -1;

  using Cw = Codes<G, 2>;
  const Cw cw(B.codes, B.code_words, c0, B.n, h);
  stage<G, CLOSED>(B, E, sh.ring, 0);
  int in_h = 0, in_q = 0;   // H[i][c0-1] and q[i] from lane t-1
  const int steps = h + LANES - 1;
  for (int step = 0; step < steps; ++step) {
    if ((step & (CHUNK - 1)) == CHUNK - 1)
      stage<G, CLOSED>(B, E, sh.ring, step / CHUNK + 1);
    const int i = step - lane;
    const bool row = i >= 0 && i < h;
    int left = in_h, qi = in_q;
    if (lane == 0) {
      const unsigned long long r = sh.ring[step & (G::RING - 1)];
      left = (int)(unsigned)r;
      qi = (int)(r >> 32);
    }
    if (row) {
      int diag = diag_in;
      diag_in = left;
      int hl = left;
      typename Cw::Seg bits = 0;
#pragma unroll
      for (int c = 0; c < LANE_COLS; ++c) {
        const int up = H[c];
        const int dsub = diag + (qi == sj[c] ? B.match : B.mismatch);
        const int x = addmax<false>(up, g, dsub);
        const int hleft = hl;
        hl = addmax<LOCAL>(hl, g, x);
        if constexpr (CODES) {
          // priority diag > gap_q > gap_s, as selects (a nested
          // conditional compiles to branches); 0 past column n - 1
          int code = hl == up + g ? PRED_GAP_S : PRED_NONE;
          code = hl == hleft + g ? PRED_GAP_Q : code;
          code = hl == dsub ? PRED_NO_GAP : code;
          if (LAST) code = c < valid ? code : PRED_NONE;
          bits |= (typename Cw::Seg)code << (2 * c);
        }
        diag = up;
        H[c] = hl;
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
            if (E.right) {
              E.right[i] = v;
              if ((i & (CHUNK - 1)) == CHUNK - 1 || i + 1 == h)
                publish(E.right_flag, i + 1, E.right_sys);
            }
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

  if constexpr ((OUT & OUT_ROW) != 0) {
#pragma unroll
    for (int c = 0; c < LANE_COLS; ++c)
      if (!LAST || c < valid) B.row_out[c0 + c] = H[c];
  }
  if constexpr ((OUT & OUT_BEST) != 0)
    store_best<LAST, LANE_COLS>(sh.held, B, k, c0, valid, bs, bi);
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

// The SMs of the current card, and the CTAs of `kernel` that one holds:
// asked of the runtime once a kernel and card and thread (the width rule
// weighs every width of a launch), anew in the host emulation, whose
// tests change the emulated card.
inline void card_of(const void* kernel, int* sms, int* per_sm) {
  int dev = 0;
  cudaGetDevice(&dev);
#ifndef ANYSEQ_HOST_EMU
  struct Known {
    const void* kernel;
    int dev, sms, per_sm;
  };
  static thread_local Known known[64];
  static thread_local int count = 0;
  for (int i = 0; i < count; ++i) {
    if (known[i].kernel == kernel && known[i].dev == dev) {
      *sms = known[i].sms;
      *per_sm = known[i].per_sm;
      return;
    }
  }
#endif
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                LANES * WARPS, 0);
#ifndef ANYSEQ_HOST_EMU
  if (count < 64) known[count++] = {kernel, dev, *sms, *per_sm};
#endif
}

// The warps of `kernel` (CTAs of WARPS warps, one warp a strip) that sweep
// a launch's `strips` strips of h steps (rows, or pairs of rows), whose
// strips start `lag` steps apart, of which `share` launches run on the card together (K10's ranks
// of one card): every strip at once where the card's share holds them all
// and the band is tall enough to keep them busy; else as many as it
// holds, or as the band keeps busy, spread over equal rounds, so that no
// last round runs a few strips alone. A strip starts `lag` steps after
// the one to its left and sweeps h + 31 steps, so about (h + 31) / lag
// strips run at once: more warps would only wait, and take scheduler
// slots from those that run. `max_grid` > 0 overrides the choice (at most
// the share of the card, so that the ranks of a sweep stay resident
// together). The CTAs an SM holds are the kernel's own (its registers
// bound them). K8, K8 affine, K1 and K5 choose by this one rule.
inline int grid_of(const void* kernel, int h, int strips, int share,
                   int max_grid, int lag) {
  int sms = 0, per_sm = 0;
  card_of(kernel, &sms, &per_sm);
  const int parts = share > 1 ? share : 1;
  const int resident = imax(per_sm * sms / parts, 1) * WARPS;
  if (max_grid > 0) return imin(strips, imin(max_grid, resident));
  const int busy = (h + LANES - 1 + lag - 1) / lag + 1;
  const int cap = imin(resident, busy);
  const int rounds = (strips + cap - 1) / cap;
  return (strips + rounds - 1) / rounds;
}

// One width K1 or K5 may sweep at: its columns a lane, its kernel, its
// rows a step and its strips' lag.
struct Width {
  int lane_cols;
  const void* kernel;
  int rows;
  int lag;
};

// The width rule's two measured limits (PERF.md: the width sweep): a
// launch with SWEEP_WARPS_PER_SM warps an SM keeps the card busy enough
// that a narrower strip, which gives more warps but more fixed work a
// step for its fewer cells and a longer fill, no longer pays; and a
// narrower strip pays only while its fill (the strips' staggered starts,
// (strips - 1) x lag steps) takes at most half of a strip's own steps
// (1 / SWEEP_FILL_SHARE).
constexpr int SWEEP_WARPS_PER_SM = 2;
constexpr int SWEEP_FILL_SHARE = 2;

// The width rule of K1 and K5 (the single-pair score sweeps), over
// `widths`, widest first: the widest whose launch (by grid_of) runs at
// least SWEEP_WARPS_PER_SM warps an SM; where none does (a short or
// narrow pair), the narrowest whose fill is at most a strip's steps /
// SWEEP_FILL_SHARE; else the widest. The boundary columns between strips
// take (strips - 1) x h ints (K5: twice that, H and E): the first rule
// keeps them to about twice the warps it asks for, the second to a few
// columns of h each. At kernels/band.py M_MAX, a 512 Ki x 1 M sweep, K1
// takes 32 columns a lane: 976 x 512 Ki ints, 2.0 GB, as on the first
// design's 1024-column strips. K5 takes 16, K8 affine's width: 2 x 1,953
// x 512 Ki ints, 8.2 GB, twice the first design's 4.1 GB, kept for its
// pace there (516 ms against 1,093, PERF.md); a memory rule that chains
// bands above a share of the card is ROADMAP R2.
inline int width_of(const Width* widths, int count, int h, int n) {
  int sms = 0, per_sm = 0;
  card_of(widths[0].kernel, &sms, &per_sm);
  for (int w = 0; w < count; ++w) {
    const int steps = (h + widths[w].rows - 1) / widths[w].rows;
    const int strips = (n + LANES * widths[w].lane_cols - 1) /
                       (LANES * widths[w].lane_cols);
    if (grid_of(widths[w].kernel, steps, strips, 1, 0, widths[w].lag) >=
        SWEEP_WARPS_PER_SM * sms)
      return widths[w].lane_cols;
  }
  for (int w = count - 1; w >= 0; --w) {
    const long long steps = (h + widths[w].rows - 1) / widths[w].rows;
    const long long strips = (n + LANES * widths[w].lane_cols - 1) /
                             (LANES * widths[w].lane_cols);
    if ((strips - 1) * widths[w].lag * SWEEP_FILL_SHARE <=
        steps + LANES - 1)
      return widths[w].lane_cols;
  }
  return widths[0].lane_cols;
}

// --- The level sweeps K4 and K5L (lastcols.cu, lastcols_affine.cu): the
// independent GLOBAL problems of one divide level in one launch, all their
// strips in one ticket list in problem order. A problem is counted here in
// the orientation its kernel sweeps it: h rows of n columns. ---

// A level's problems on the device, one int64 array of 4 B + 1 values:
// ms[B] and ns[B] (query and subject lengths), start[B + 1] (the prefix
// sums of the problems' strips: problem b's strips are the tickets
// [start[b], start[b + 1])) and boff[B] (where problem b's boundary
// columns start in the launch's scratch).
struct LevelMeta {
  const long long* ms;
  const long long* ns;
  const long long* start;
  const long long* boff;
  int problems;

  static LevelMeta of(const long long* meta, int B) {
    return {meta, meta + B, meta + 2 * B, meta + 3 * B + 1, B};
  }

  // The problem whose strips hold ticket k: the last b with start[b] <= k.
  __device__ __forceinline__ int problem_of(int k) const {
    int lo = 0, hi = problems - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start[mid] <= k)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }
};

// A problem's strips at `lane_cols` columns a lane (none when empty).
// (The width rule runs these over every problem of a launch on the host:
// one strip and one row a step cost no division.)
inline int level_strips(int h, int n, int lane_cols) {
  const int strip = LANES * lane_cols;
  return h <= 0 || n <= 0 ? 0 : n <= strip ? 1 : (n + strip - 1) / strip;
}

// A problem's steps of h rows at w (rows a step).
inline int level_steps(const Width& w, int h) {
  return w.rows == 1 ? h : (h + w.rows - 1) / w.rows;
}

// The strips of a problem of h rows and k strips at width w that keep busy
// at once: about (steps + 31) / lag (grid_of's `busy`).
inline int level_busy(const Width& w, int h, int k) {
  if (k == 1) return 1;
  return imin(k, (level_steps(w, h) + LANES - 1 + w.lag - 1) / w.lag + 1);
}

// The warps of a level launch of `strips` strips of which `busy` keep
// busy at once: as many as keep busy, up to `resident` (the card's
// resident warps) and over equal rounds beyond them; `max_grid` > 0 caps
// them.
inline int level_warps(long long strips, long long busy, long long resident,
                       int max_grid) {
  if (strips == 0) return 0;
  if (max_grid > 0) return (int)std::min<long long>(
      strips, std::min<long long>(max_grid, resident));
  const long long cap = std::min(resident, busy);
  const long long rounds = (busy + cap - 1) / cap;
  return (int)((busy + rounds - 1) / rounds);
}

// The card's resident warps of a kernel (CTAs of WARPS warps), and its SMs.
inline long long level_resident(const Width& w, int* sms) {
  int per_sm = 0;
  card_of(w.kernel, sms, &per_sm);
  return (long long)imax(per_sm * *sms, 1) * WARPS;
}

// The warps a level launch at width w runs (level_warps over its
// problems); `max_grid` > 0 caps them.
inline int level_grid(const Width& w, const int* hs, const int* ns,
                      int problems, int max_grid) {
  int sms = 0;
  const long long resident = level_resident(w, &sms);
  long long strips = 0, busy = 0;
  for (int b = 0; b < problems; ++b) {
    const int k = level_strips(hs[b], ns[b], w.lane_cols);
    if (k == 0) continue;
    strips += k;
    busy += level_busy(w, hs[b], k);
  }
  return level_warps(strips, busy, resident, max_grid);
}

// A warp's step at a level width, in cycles: `fixed + per_col x lane_cols`
// while it has its scheduler to itself (the row chain's latency and the
// hand-off), and at least `issue_fixed + issue_per_col x lane_cols` for
// each warp that shares its scheduler (the instructions the warp issues).
struct StepCost {
  int fixed, per_col, issue_fixed, issue_per_col;
};

// The width rule of K4, K5L and K7 (and of K2 and K5p, a pair one
// problem), over `widths` (at most LEVEL_WIDTHS, widest first) with their
// step costs: the least modelled time among the widths whose boundary
// columns -- (strips_b - 1) x h_b values a problem,
// of `bytes` each (4 linear; 8 affine, H and E) -- fit in `cap` bytes (the
// caller's share of the card's free memory), the wider on a tie; the
// widest where none fits (the most scratch any level takes, for the
// fewest strips). A width's modelled time is its steps, the longer of the
// slowest problem's critical path -- (its steps + 31) + (its strips - 1)
// x lag -- and the launch's warp-steps spread over its warps
// (level_warps), times the step's cycles at that many warps a scheduler.
// One pass over the problems gathers every width's sums; `most`, where
// given, gets the most bytes of boundary columns any of the widths takes.
constexpr int LEVEL_WIDTHS = 8;
inline int level_width(const Width* widths, const StepCost* costs, int count,
                       const int* hs, const int* ns, int problems, int bytes,
                       long long cap, long long* most = nullptr) {
  count = imin(count, LEVEL_WIDTHS);
  long long values[LEVEL_WIDTHS] = {}, strips[LEVEL_WIDTHS] = {},
            busy[LEVEL_WIDTHS] = {};
  double path[LEVEL_WIDTHS] = {}, work[LEVEL_WIDTHS] = {};
  for (int b = 0; b < problems; ++b) {
    const int h = hs[b];
    for (int w = 0; w < count; ++w) {
      const Width& x = widths[w];
      const int k = level_strips(h, ns[b], x.lane_cols);
      if (k == 0) break;  // an empty problem, at every width
      const double steps = level_steps(x, h) + LANES - 1;
      values[w] += (long long)(k - 1) * h;
      strips[w] += k;
      busy[w] += level_busy(x, h, k);
      path[w] = std::max(path[w], steps + (double)(k - 1) * x.lag);
      work[w] += k * steps;
    }
  }
  int best = 0;
  double best_cycles = -1;
  if (most) *most = 0;
  for (int w = 0; w < count; ++w) {
    if (most) *most = std::max(*most, values[w] * bytes);
    if (values[w] * bytes > cap) continue;
    int sms = 0;
    const long long resident = level_resident(widths[w], &sms);
    const int warps = level_warps(strips[w], busy[w], resident, 0);
    double cycles = 0;
    if (warps > 0) {
      // warps a scheduler (an SM has WARPS of them), on average
      const double sharing =
          std::max(1.0, (double)warps / (imax(sms, 1) * WARPS));
      const StepCost& c = costs[w];
      const double step = std::max<double>(
          c.fixed + c.per_col * widths[w].lane_cols,
          sharing * (c.issue_fixed + c.issue_per_col * widths[w].lane_cols));
      cycles = std::max(path[w], work[w] / warps) * step;
    }
    if (best_cycles < 0 || cycles < best_cycles) {
      best = w;
      best_cycles = cycles;
    }
  }
  return widths[best].lane_cols;
}

}  // namespace band_core
}  // namespace anyseq
