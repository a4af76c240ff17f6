// K4: the last columns of a batch of independent GLOBAL linear-gap DP
// problems -- every half of one Hirschberg divide level in one launch.
//
// Replaces the JAX package's Pallas kernels anyseq_tpu/kernels/band.py
// _score_slotted_padded (slotted _make_kernel body, reached from
// score_level_parts / score_levels_fused / score_pairs_batched) and
// _score_batched_padded (the plain (B, GP) grid of score_pairs_batched).
//
// Contract (that of engine/batch.py last_cols_batch, its plain version):
// cols[b][i] = H_b[i][ns[b] - 1] for i < ms[b], with H_b the GLOBAL DP of
// query q[b][0..ms[b]) against subject s[b][0..ns[b]).
//
// What bounds it on an H100: the same dependent max/add chains as K1, per
// problem; a level holds from 8 halves of tens of thousands of columns to
// hundreds of halves of a few hundred columns, so the bound is keeping
// all SMs busy across that range.
//
// Design: every problem is cut into the 1024-column strips of sweep.cuh
// and all strips of all problems form one list, in problem order. CTAs
// claim strips from a ticket counter in list order, so a strip's left
// neighbour is always claimed first and the wide halves of a shallow
// level spread over many CTAs just as K1's single problem does, while a
// deep level runs one CTA per narrow half.
#include "sweep.cuh"

using namespace anyseq;

__global__ void __launch_bounds__(SWEEP_THREADS)
    lastcols_kernel(const uint8_t* q, int q_stride, const uint8_t* s,
                    int s_stride, const int* ms, const int* ns,
                    const int* strip_start, int B, int total, Scoring sc,
                    int* ticket, int* bcols, int bcol_stride, int* flags,
                    int* cols, int col_stride) {
  __shared__ SweepShared sh;
  __shared__ int slot;
  for (;;) {
    const int k = claim(ticket, &slot);
    if (k >= total) return;
    // the problem whose strips contain k: the last b with strip_start[b] <= k
    int lo = 0, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (strip_start[mid] <= k)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int b = lo;
    const int kk = k - strip_start[b];
    const int count = strip_start[b + 1] - strip_start[b];
    Strip S;
    S.q = q + (size_t)b * q_stride;
    S.m = ms[b];
    S.s = s + (size_t)b * s_stride;
    S.n = ns[b];
    S.col0 = kk * STRIP;
    S.global_init = true;
    S.left = kk > 0 ? bcols + (size_t)(k - 1) * bcol_stride : nullptr;
    S.left_flag = kk > 0 ? flags + (k - 1) : nullptr;
    S.right = kk + 1 < count ? bcols + (size_t)k * bcol_stride : nullptr;
    S.right_flag = flags + k;
    S.last_col = cols + (size_t)b * col_stride;
    S.last_row = nullptr;
    S.preds = nullptr;
    S.pred_stride = 0;
    S.best = nullptr;
    sweep_strip<false, false, false>(S, sc, sh);
  }
}

// strip_start: (B + 1) ints, the prefix sums of each problem's strip
// count ceil(ns[b] / 1024) (0 for an empty problem); total = strip_start[B].
// Scratch: ticket (1 int, zeroed), flags (total ints, zeroed), bcols
// (total * bcol_stride ints, bcol_stride >= max ms).
extern "C" int anyseq_lastcols(const void* q, int q_stride, const void* s,
                               int s_stride, const void* ms, const void* ns,
                               const void* strip_start, int B, int total,
                               int match, int mismatch, int gap, void* ticket,
                               void* bcols, int bcol_stride, void* flags,
                               void* cols, int col_stride, void* stream) {
  const Scoring sc{match, mismatch, gap};
  const int grid = imin(
      total, resident_ctas((const void*)lastcols_kernel, SWEEP_THREADS));
  if (grid <= 0) return 0;
  ANYSEQ_LAUNCH(lastcols_kernel, grid, SWEEP_THREADS, stream,
                (const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                (const int*)ms, (const int*)ns, (const int*)strip_start, B,
                total, sc, (int*)ticket, (int*)bcols, bcol_stride,
                (int*)flags, (int*)cols, col_stride);
  return (int)cudaGetLastError();
}
