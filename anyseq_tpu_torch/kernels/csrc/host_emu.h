// Host emulation of the few CUDA features the kernels use, so that their
// sources compile as C++20 with g++ and run on a CPU (see common.cuh).
//
// A launch runs its CTAs one after another; each CTA runs its threads as
// host threads, with a std::barrier for __syncthreads() and one for each
// warp of 32 threads: __syncwarp() waits on the warp's, and a shuffle
// writes the thread's value into the warp's slot array, waits, and
// reads its source lane's slot (two slot arrays used in turn, so one
// barrier a shuffle keeps a fast lane from overwriting a slot that a
// slow lane has yet to read). Every lane must reach each of them, as on
// the card with a full mask. The DPX intrinsics are their formulas in
// plain C++, with the 32-bit add wrapping as the card's does, and so is
// the byte permute __byte_perm (PRMT). __shared__
// variables become function statics, which is right while one CTA runs
// at a time. Because CTAs run in order, a strip's left neighbour has
// always finished before the strip starts: wait_for() checks that the
// flag it would spin on is already raised, and aborts if it is not. The
// warps of one CTA of K8/K10 (band_sweep.cuh) sweep neighbouring strips
// at once, so there a warp spins until its neighbour's flag is raised
// (emu_wait_published). The collective sweep's ranks (K10) are launched
// in rank order, so a rank's left neighbour has finished its band before
// the rank starts.
#pragma once

#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx;
inline thread_local emu_dim3 blockIdx;
inline emu_dim3 blockDim;
inline emu_dim3 gridDim;
inline std::barrier<>* emu_cta_barrier = nullptr;

typedef void* cudaStream_t;
enum { cudaDevAttrMultiProcessorCount = 16 };

inline void __syncthreads() { emu_cta_barrier->arrive_and_wait(); }

// One warp's barrier and shuffle slots; emu_launch makes one a warp.
struct EmuWarp {
  explicit EmuWarp(int lanes) : bar(lanes) {}
  std::barrier<> bar;
  long long slot[2][32] = {};
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local int emu_slot_turn = 0;

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar.arrive_and_wait(); }

// Every lane offers `v` and takes the value lane `src` offered (its own
// where `src` lies outside the warp).
template <class T>
T emu_exchange(T v, int src) {
  static_assert(sizeof(T) <= sizeof(long long));
  const int lane = (int)(threadIdx.x & 31);
  long long* slots = emu_warp->slot[emu_slot_turn];
  emu_slot_turn ^= 1;
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  slots[lane] = bits;
  emu_warp->bar.arrive_and_wait();
  if (src < 0 || src > 31) return v;
  T out;
  std::memcpy(&out, &slots[src], sizeof(T));
  return out;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src & 31); }
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return emu_exchange(v, (int)(threadIdx.x & 31) - (int)delta);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_exchange(v, (int)(threadIdx.x & 31) ^ mask);
}
// DPX (sm_90): max(a + b, c), its clamp at 0, and a three-way max.
inline int emu_add_wrap(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
inline int __viaddmax_s32(int a, int b, int c) {
  const int s = emu_add_wrap(a, b);
  return s > c ? s : c;
}
inline int __viaddmax_s32_relu(int a, int b, int c) {
  const int m = __viaddmax_s32(a, b, c);
  return m > 0 ? m : 0;
}
inline int __vimax3_s32(int a, int b, int c) {
  const int m = a > b ? a : b;
  return m > c ? m : c;
}
// PRMT: byte n of the result is byte (s >> 4n) & 7 of the pair y:x
// (the walk cores' unpack of codes to bytes; no sign replication).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (unsigned long long)y << 32 | x;
  unsigned out = 0;
  for (int n = 0; n < 4; ++n)
    out |= (unsigned)(v >> (8 * ((s >> (4 * n)) & 7)) & 0xff) << (8 * n);
  return out;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence_system() { __threadfence(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline int __ldcg(const int* p) { return *(const volatile int*)p; }

inline void emu_check_published(int flag, int value) {
  if (flag < value) {
    std::fprintf(stderr, "host emulation: waited on flag %d < %d\n", flag, value);
    std::abort();
  }
}

// A flag that another warp of the running CTA may still raise (the warps
// of a CTA run at once): spin, and abort after a minute, as the card
// traps a wait that never ends.
inline void emu_wait_published(const int* flag, int value) {
  const auto start = std::chrono::steady_clock::now();
  while (*(const volatile int*)flag < value) {
    if (std::chrono::steady_clock::now() - start > std::chrono::seconds(60))
      emu_check_published(*(const volatile int*)flag, value);
    std::this_thread::yield();
  }
  __threadfence();
}

// The emulated card: one SM that holds one CTA, unless a test sets
// another (band.cu's anyseq_emu_set_card) to check a grid rule.
inline int emu_card_sms = 1;
inline int emu_card_ctas_per_sm = 1;

inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = emu_card_sms; return 0; }
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
  *n = emu_card_ctas_per_sm;
  return 0;
}
inline int cudaGetLastError() { return 0; }
enum { cudaErrorInvalidValue = 1, cudaErrorPeerAccessAlreadyEnabled = 704 };
inline int cudaSetDevice(int) { return 0; }
inline int cudaDeviceEnablePeerAccess(int, unsigned) { return 0; }

template <class F>
void emu_launch(int grid, int block, F body) {
  gridDim.x = grid;
  blockDim.x = block;
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_cta_barrier = &bar;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < block; w += 32)
      warps.push_back(std::make_unique<EmuWarp>(block - w < 32 ? block - w : 32));
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        emu_warp = warps[t / 32].get();
        emu_slot_turn = 0;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}

#define ANYSEQ_LAUNCH(kernel, grid, block, stream, ...) \
  emu_launch((grid), (block), [&] { kernel(__VA_ARGS__); })
