// Host emulation of the few CUDA features the kernels use, so that their
// sources compile as C++20 with g++ and run on a CPU (see common.cuh).
//
// A launch runs its CTAs one after another; each CTA runs its threads as
// host threads, with a std::barrier for __syncthreads(). __shared__
// variables become function statics, which is right while one CTA runs
// at a time. Because CTAs run in order, a strip's left neighbour has
// always finished before the strip starts: wait_for() checks that the
// flag it would spin on is already raised, and aborts if it is not. The
// collective sweep's ranks (K10) are launched in rank order, so a rank's
// left neighbour has likewise finished its band before the rank starts.
#pragma once

#include <atomic>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

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

inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
enum { cudaErrorPeerAccessAlreadyEnabled = 704 };
inline int cudaSetDevice(int) { return 0; }
inline int cudaDeviceEnablePeerAccess(int, unsigned) { return 0; }

template <class F>
void emu_launch(int grid, int block, F body) {
  gridDim.x = grid;
  blockDim.x = block;
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_cta_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}

#define ANYSEQ_LAUNCH(kernel, grid, block, stream, ...) \
  emu_launch((grid), (block), [&] { kernel(__VA_ARGS__); })
