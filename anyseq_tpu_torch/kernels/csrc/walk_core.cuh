// The traceback-walk core of K3 (walk.cu, linear 2-bit codes) and K6
// (walk_affine.cu, affine 4-bit codes): one warp a walk, stepping over
// code windows staged in shared memory.
//
// A walk is a serial chain: each step's address depends on the code the
// step before read. Read from device memory, every step of a diagonal
// walk lands on a new row and a new 32-byte sector, so a step costs a
// device-memory round trip (~690 cycles on an H100 when it misses L2,
// ~290 when it hits, tools/step_probe.py). Here the warp stages a window
// of the codes around the walker in shared memory, one code a byte, and
// the walker steps there: a step is one dependent shared load (~34
// cycles) and, linear, one subtraction (the byte holds the move's offset
// in the window), affine four operations (the state's move).
//
// The window: ROWS rows of 128 bytes, the first 16 of each row left 0 and
// the other 112 one code column each, anchored at the walker (its cell is
// in the last row, in the last word's span of columns); a row 0 of zeros
// above. A zero byte stops the walker: a linear move of 0, and affine
// data bytes carry 0x30, which the step masks the move with. Cells of the
// halo (i < 0 or j < 0) are zero too. So the walker needs no bounds test:
// it walks BLOCK steps without a branch (a stopped walker repeats a move
// of 0), then tests once whether it stopped, whether its record of steps
// is full, and whether it came within AHEAD rows or columns of the
// window's top or left. There it issues the loads of the next window,
// anchored where it stands, into registers (asm volatile: issued there,
// waited on only at their use); the second block of steps after them
// unpacks them into the other buffer (one code a byte, PRMT byte
// permutes) in its idle issue slots. Where the walker stops on the
// window's edge, it carries on in the other buffer; where it stops in the
// halo, the halo's straight run follows. The query and subject bytes of
// the window's rows and columns are staged with it.
//
// Output: lane l keeps the window offset and move of steps l and l + 32
// in registers; every RING steps, and before the walker changes window,
// each lane writes its pairs at position i + j + 1, the symbols from the
// staged bytes. No store to shared memory sits between two of the
// walker's loads, which would hold the second behind it.
//
// All 32 lanes walk together: the shared loads of the walk are
// broadcasts, and the loads, unpack and flushes are spread over the
// lanes. A CTA is one warp and one walk (two 12 KB windows).
//
// Host emulation (host_emu.h): __byte_perm is its formula, the early
// loads are plain loads, the shared windows are a static (one CTA runs
// at a time), and a shared-memory address is an offset from the first
// window.
#pragma once

#include "common.cuh"

namespace anyseq {
namespace walk_core {

// The window's rows, the prefetch distance (rows or columns from the
// window's top or left) and the steps between tests: measured (PERF.md,
// the walks; tools/walk_ab.py --sweep builds copies with other values).
constexpr int ROWS = 96;
constexpr int AHEAD = 32;
constexpr int BLOCK = 16;
constexpr int RING = 64;            // recorded steps: two a lane
constexpr int ROW_BYTES = 128;      // a window row; the up move's offset
constexpr int PAD = 16;             // zero bytes left of a row's codes
constexpr int COLS = ROW_BYTES - PAD;  // code columns a window row
static_assert(ROW_BYTES == 0x80, "a linear byte's offsets: 1, 0x80, 0x81");
static_assert(ROWS % 32 == 0 && (ROWS + 1) * ROW_BYTES <= 65536,
              "ROWS: a multiple of 32; a window offset fits 16 bits");
static_assert(AHEAD > BLOCK && AHEAD < ROWS && AHEAD < COLS - 16,
              "the trigger lies inside the window, a block from its edge");
static_assert(RING % BLOCK == 0, "whole blocks a flush");

constexpr uint32_t STATE_E = PRED_GAP_Q, STATE_F = PRED_GAP_S;  // 0 is H
constexpr uint32_t VALID = 0x30303030u;  // the affine data bytes' mark

// A warp's shared memory: two windows and their staged symbols.
constexpr int WIN = (ROWS + 1) * ROW_BYTES;  // a window's bytes
struct alignas(16) Smem {
  uint8_t win[2][WIN];
  uint8_t spare[16];           // the idle lanes' unpack stores
  uint8_t qw[2][ROWS + 1];     // qw[b][r]: the query symbol of data row r
  uint8_t sw[2][PAD + COLS / 32 * 32 + 32];  // sw[b][c]: of byte c
};
static_assert(sizeof(Smem) <= 48 * 1024, "a CTA's static shared memory");

// One window's loads, held in registers from the trigger to the switch.
// PW: codes a word (16 two-bit, 8 four-bit). A lane loads word slot
// lane % SLOTS of rows lane / SLOTS + k * (32 / SLOTS); slots past CW idle.
template <int PW>
struct Stage {
  static constexpr int CW = COLS / PW;             // words a window row
  static constexpr int SLOTS = PW == 16 ? 8 : 16;  // word slots a row
  static constexpr int STEP = 32 / SLOTS;          // rows a load round
  static constexpr int WORDS = ROWS / STEP;        // loads a lane
  uint32_t w[WORDS];
  uint8_t q[ROWS / 32];
  uint8_t s[COLS / 32 + 1];
  int top;     // the matrix row of data row 1
  int jbase;   // the matrix column of byte PAD (a multiple of PW)
};

// A load issued where it stands (where `ok`; else 0): asm volatile, so
// that the compiler does not sink it to its first use, and the walk goes
// on while it is in flight. The host emulation loads at once.
template <class T>
__device__ __forceinline__ uint32_t early_load(const T* p, bool ok) {
#ifdef ANYSEQ_HOST_EMU
  return ok ? (uint32_t)*p : 0u;
#else
  uint32_t v;
  if constexpr (sizeof(T) == 4)
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
        " @q ld.global.nc.b32 %0, [%1];\n}"
        : "=r"(v) : "l"(p), "r"((int)ok));
  else
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
        " @q ld.global.nc.u8 %0, [%1];\n}"
        : "=r"(v) : "l"(p), "r"((int)ok));
  return v;
#endif
}

// Issue the loads of the window anchored at (i, j), both >= 0; rows and
// words of the halo load 0.
template <int PW>
__device__ __forceinline__ void stage(Stage<PW>& st, const uint32_t* P,
                                      int row_words, const uint8_t* Q,
                                      const uint8_t* S, int i, int j,
                                      int lane) {
  using St = Stage<PW>;
  st.top = i - ROWS + 1;
  st.jbase = (j / PW + 1) * PW - COLS;
  const int slot = lane % St::SLOTS;
  const int col = st.jbase / PW + slot;
  int row = st.top + lane / St::SLOTS;
  const bool col_ok = col >= 0 && slot < St::CW;
  const uint32_t* p = P + (long long)row * row_words + col;
  const long long step = (long long)St::STEP * row_words;
#pragma unroll
  for (int k = 0; k < St::WORDS; ++k) {
    st.w[k] = early_load(p, col_ok && row >= 0);
    p += step;
    row += St::STEP;
  }
#pragma unroll
  for (int k = 0; k < ROWS / 32; ++k) {
    const int r = st.top + lane + 32 * k;
    st.q[k] = (uint8_t)early_load(Q + r, r >= 0);
  }
  // the walker never goes right of its anchor: no subject byte past j
#pragma unroll
  for (int k = 0; k < COLS / 32 + 1; ++k) {
    const int c = lane + 32 * k;
    const int jj = st.jbase + c;
    st.s[k] = (uint8_t)early_load(S + jj, c < COLS && jj >= 0 && jj <= j);
  }
}

// A two-bit code as the walker's byte: its move's offset in the window
// (GAP_Q 1, GAP_S 0x80 = ROW_BYTES, NO_GAP 0x81), from bytes of 0..3.
__device__ __forceinline__ uint32_t offsets(uint32_t y) {
  return (y | y << 6) & 0x81818181u;
}

// One code a byte: the 16 two-bit codes of x into out[0..3] as offsets,
// or the 8 four-bit codes into out[0..1], lowest code in the lowest byte.
template <int PW>
__device__ __forceinline__ void spread(uint32_t x, uint32_t* out) {
  if constexpr (PW == 16) {
    const uint32_t a = x & 0x33333333u, b = (x >> 2) & 0x33333333u;
    const uint32_t la = offsets(a & 0x0f0f0f0fu);
    const uint32_t ha = offsets((a >> 4) & 0x0f0f0f0fu);
    const uint32_t lb = offsets(b & 0x0f0f0f0fu);
    const uint32_t hb = offsets((b >> 4) & 0x0f0f0f0fu);
    // la = [c0 c4 c8 c12], lb = [c1 c5 ..], ha = [c2 c6 ..], hb = [c3 ..]
    const uint32_t p0 = __byte_perm(la, lb, 0x5140);   // c0 c1 c4 c5
    const uint32_t p1 = __byte_perm(ha, hb, 0x5140);   // c2 c3 c6 c7
    const uint32_t p2 = __byte_perm(la, lb, 0x7362);   // c8 c9 c12 c13
    const uint32_t p3 = __byte_perm(ha, hb, 0x7362);   // c10 c11 c14 c15
    out[0] = __byte_perm(p0, p1, 0x5410);
    out[1] = __byte_perm(p0, p1, 0x7632);
    out[2] = __byte_perm(p2, p3, 0x5410);
    out[3] = __byte_perm(p2, p3, 0x7632);
  } else {
    const uint32_t lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
    out[0] = __byte_perm(lo, hi, 0x5140);
    out[1] = __byte_perm(lo, hi, 0x7362);
  }
}

// Unpack a staged window into buffer `buf`, with its symbols. Only the
// code bytes are written: the pad, row 0 and the halo stay 0. No branch
// (the idle slots store to `spare`), so that it shares a basic block with
// a block of steps; the caller syncs the warp before the walker reads
// the buffer.
template <int PW>
__device__ __forceinline__ void unpack(const Stage<PW>& st, Smem& sm,
                                       int buf, int lane) {
  using St = Stage<PW>;
  const int slot = lane % St::SLOTS;
  const bool mine = slot < St::CW;
  uint8_t* dst = sm.win[buf] + (1 + lane / St::SLOTS) * ROW_BYTES + PAD +
                 slot * PW;
  int row = st.top + lane / St::SLOTS;
  const uint32_t valid = st.jbase / PW + slot >= 0 ? VALID : 0u;
#pragma unroll
  for (int k = 0; k < St::WORDS; ++k) {
    uint32_t out[PW / 4];
    spread<PW>(st.w[k], out);
    uint8_t* to = mine ? dst : sm.spare;
    if constexpr (PW == 16) {
      uint4 v;
      v.x = out[0], v.y = out[1], v.z = out[2], v.w = out[3];
      *(uint4*)to = v;
    } else {
      const uint32_t m = row >= 0 ? valid : 0u;
      uint2 v;
      v.x = out[0] | m, v.y = out[1] | m;
      *(uint2*)to = v;
    }
    dst += St::STEP * ROW_BYTES;
    row += St::STEP;
  }
#pragma unroll
  for (int k = 0; k < ROWS / 32; ++k) sm.qw[buf][lane + 32 * k + 1] = st.q[k];
#pragma unroll
  for (int k = 0; k < COLS / 32 + 1; ++k)
    sm.sw[buf][PAD + lane + 32 * k] = st.s[k];
}

// The walker's loads: a byte of the windows at a shared-memory address
// (the card), or at an offset from win[0][0] (the host emulation). asm
// volatile keeps them in order with the unpacks' stores and the syncs.
__device__ __forceinline__ uint32_t win_address(Smem& sm) {
#ifdef ANYSEQ_HOST_EMU
  (void)sm;
  return 0u;
#else
  return (uint32_t)__cvta_generic_to_shared(&sm.win[0][0]);
#endif
}
__device__ __forceinline__ uint32_t win_byte(const Smem& sm, uint32_t a) {
#ifdef ANYSEQ_HOST_EMU
  return (&sm.win[0][0])[a];
#else
  (void)sm;
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
#endif
}

// Write out the n recorded steps of the window in buffer `buf`: lane l
// steps l and l + 32, from its entries x[0], x[1] (window offset | the
// move's bits << 16), at pos = i + j + 1 = r + c + base, base = top +
// jbase - PAD.
__device__ __forceinline__ void flush(const Smem& sm, const uint32_t* x,
                                      int n, int buf, int base, uint8_t* OQ,
                                      uint8_t* OS, int lane) {
#pragma unroll
  for (int h = 0; h < RING / 32; ++h) {
    const uint32_t e = x[h];
    if (lane + 32 * h < n && e >> 16) {  // a move: bit 16 left, bit 23 up
      const int r = (int)((e & 0xffffu) / ROW_BYTES);
      const int c = (int)(e % ROW_BYTES);
      OQ[r + c + base] = e >> 23 & 1 ? sm.qw[buf][r] : (uint8_t)GAP_SYM;
      OS[r + c + base] = e >> 16 & 1 ? sm.sw[buf][c] : (uint8_t)GAP_SYM;
    }
  }
}

// Walk one problem from (i, j) in `state` (affine: 0 H, STATE_E) to its
// start; every lane of the warp calls it. P: the problem's codes, rows of
// row_words words; Q, S: its sequences; OQ, OS: its output rows; start:
// its two start ints.
template <bool AFFINE>
__device__ void walk(Smem& sm, const uint32_t* P, int row_words,
                     const uint8_t* Q, const uint8_t* S, int i, int j,
                     uint32_t state, bool global_halo, uint8_t* OQ,
                     uint8_t* OS, int* start) {
  constexpr int PW = AFFINE ? 8 : 16;
  const int lane = (int)(threadIdx.x & 31);
  if (i >= 0 && j >= 0) {
    Stage<PW> st;
    stage(st, P, row_words, Q, S, i, j, lane);
    // the bytes no unpack writes: row 0 and each row's pad, both windows
    for (int r = lane; r < 2 * (ROWS + 1 + ROW_BYTES / 16); r += 32) {
      const int w = r / (ROWS + 1 + ROW_BYTES / 16);
      const int k = r % (ROWS + 1 + ROW_BYTES / 16);
      const int at = k <= ROWS ? k * ROW_BYTES : (k - ROWS) * 16;
      *(uint4*)(sm.win[w] + at) = uint4{0u, 0u, 0u, 0u};
    }
    __syncwarp();
    int cur = 0;
    unpack(st, sm, cur, lane);
    __syncwarp();
    const uint32_t base = win_address(sm);
    uint32_t wb = base;  // the current window's first byte
    int top = st.top, jbase = st.jbase;
    // the walker's byte
    uint32_t at = wb + (uint32_t)((i - top + 1) * ROW_BYTES + PAD + j -
                                  jbase);
    uint32_t hmask = state ? 0u : 3u;  // affine: PH is the move in H
    // the next window: 0 none, 2 its loads in flight, 1 the next block
    // unpacks it, 0 with `ready` once unpacked
    int lag = 0;
    bool ready = false;
    // the steps recorded since the last flush; lane l keeps the entries
    // of steps l and l + 32 in registers (a store to shared memory
    // between two of the walker's loads would hold the second behind it)
    int n = 0;
    uint32_t mine[RING / 32] = {};
    // BLOCK steps without a branch; a zero byte stops the walker, which
    // then records moves of 0
    auto steps = [&]() {
      uint32_t moved = 0;
      const int slot = lane - n;
      auto keep = [&](uint32_t e, int k) {
#pragma unroll
        for (int h = 0; h < RING / 32; ++h)
          mine[h] = slot + 32 * h == k ? e : mine[h];
      };
#pragma unroll
      for (int k = 0; k < BLOCK; ++k) {
        const uint32_t c = win_byte(sm, at);
        if constexpr (AFFINE) {
          // the state's move, or PH in H; 0 on a zero byte. The state
          // goes on in E (F) while PE (PF) says so; a zero byte keeps it.
          const uint32_t data = c >> 4;
          const uint32_t mv = (state | (c & hmask)) & data;
          const uint32_t next = mv == 3 ? 0u : mv & (c >> 2);
          state = data ? next : state;
          hmask = state ? 0u : 3u;
          const uint32_t e = (at - wb) | (mv & 1) << 16 | (mv & 2) << 22;
          keep(e, k);
          // left 1 (GAP_Q), up a row (GAP_S), both (NO_GAP): at - mv
          // beside mv & 2, then one multiply-add
          at = at - mv - (ROW_BYTES / 2 - 1) * (mv & 2);
          moved = mv;
        } else {
          // the byte is the move's offset: one subtraction on the chain
          const uint32_t e = (at - wb) | c << 16;
          keep(e, k);
          at -= c;
          moved = c;
        }
      }
      n += BLOCK;
      return moved;
    };
    for (;;) {
      uint32_t moved;
      if (lag == 1) {
        // the block whose idle issue slots unpack the next window
        moved = steps();
        unpack(st, sm, cur ^ 1, lane);
        ready = true;
        lag = 0;
      } else {
        moved = steps();
        lag -= lag > 0;
      }
      const uint32_t off = at - wb;
      const bool near = off < (uint32_t)((AHEAD + 1) * ROW_BYTES) ||
                        off % ROW_BYTES < (uint32_t)(PAD + AHEAD);
      if (moved && n < RING && (lag || ready || !near)) continue;
      const int ci = top + (int)(off / ROW_BYTES) - 1;
      const int cj = jbase + (int)(off % ROW_BYTES) - PAD;
      if (moved) {
        if (n == RING) {
          flush(sm, mine, n, cur, top + jbase - PAD, OQ, OS, lane);
          n = 0;
        }
        if (!lag && !ready && near) {
          stage(st, P, row_words, Q, S, ci, cj, lane);
          lag = 2;
        }
        continue;
      }
      // stopped: in the halo, on the window's edge, or on PRED_NONE
      flush(sm, mine, n, cur, top + jbase - PAD, OQ, OS, lane);
      n = 0;
      if (ci < 0 || cj < 0) break;
      if (off >= ROW_BYTES && off % ROW_BYTES >= PAD) break;
      // the next window holds the walker unless it moved further than
      // the trigger's distance since its loads
      const bool held = (lag || ready) && ci >= st.top && cj >= st.jbase;
      if (!held) stage(st, P, row_words, Q, S, ci, cj, lane);
      if (!held || !ready) unpack(st, sm, cur ^ 1, lane);
      __syncwarp();
      lag = 0;
      ready = false;
      cur ^= 1;
      wb = base + cur * WIN;
      top = st.top;
      jbase = st.jbase;
      at = wb + (uint32_t)((ci - top + 1) * ROW_BYTES + PAD + cj - jbase);
    }
    const uint32_t off = at - wb;
    i = top + (int)(off / ROW_BYTES) - 1;
    j = jbase + (int)(off % ROW_BYTES) - PAD;
  }
  // The GLOBAL halo: along row -1 every move is GAP_Q (PH = GAP_Q, and E
  // moves left too), down column -1 every move GAP_S, until both are
  // negative; only an F step on row -1 or an E step on column -1 (one,
  // then H) leaves the run. sgaps sets PE on row -1, which keeps the
  // state E or H there: both move left, so it changes no output.
  while (global_halo && (i < 0) != (j < 0)) {
    if (i < 0 && state != STATE_F) {
      for (int k = lane; k <= j; k += 32) {
        const int pos = i + (j - k) + 1;
        OQ[pos] = (uint8_t)GAP_SYM;
        OS[pos] = S[j - k];
      }
      j = -1;
      break;
    }
    if (j < 0 && state != STATE_E) {
      for (int k = lane; k <= i; k += 32) {
        const int pos = (i - k) + j + 1;
        OQ[pos] = Q[i - k];
        OS[pos] = (uint8_t)GAP_SYM;
      }
      i = -1;
      break;
    }
    const int pos = i + j + 1;
    if (lane == 0) {
      OQ[pos] = state == STATE_F ? Q[imax(i, 0)] : (uint8_t)GAP_SYM;
      OS[pos] = state == STATE_F ? (uint8_t)GAP_SYM : S[imax(j, 0)];
    }
    if (state == STATE_F)
      --i;
    else
      --j;
    state = 0;
  }
  if (lane == 0) {
    start[0] = i + 1;
    start[1] = j + 1;
  }
}

}  // namespace walk_core
}  // namespace anyseq
