// K5L: the H and E last columns of a batch of independent GLOBAL affine
// (Gotoh) DP problems, each with its own Myers-Miller start_gap flag --
// every half of one Myers-Miller divide level in one launch.
//
// Replaces the affine variant of the JAX package's Pallas kernels
// anyseq_tpu/kernels/band.py _score_slotted_padded (per-problem sgap in
// the dims rows, H and E last columns; reached from score_pairs_batched
// and the affine level functions) and _score_batched_padded (its plain
// (B, GP) grid).
//
// Contract (that of engine/batch.py last_cols_batch_affine, its plain
// version): cols[b][i] = H_b[i][ns[b] - 1] and cols_e[b][i] =
// E_b[i][ns[b] - 1] for i < ms[b], with H_b/E_b the GLOBAL Gotoh DP of
// query q[b][0..ms[b]) against subject s[b][0..ns[b]), its top row
// continuing a paid gap run where sgaps[b] (engine/affine.py start_gap).
//
// What bounds it on an H100: as K4 -- the dependent max/add chains of
// each problem, and keeping all SMs busy from a few wide halves to
// hundreds of narrow ones.
//
// Design: K4's (lastcols.cu). Every problem is cut into the 1024-column
// strips of sweep_affine.cuh and all strips of all problems form one
// ticket list in problem order, so a strip's left neighbour is always
// claimed first.
#include "sweep_affine.cuh"

using namespace anyseq;

__global__ void __launch_bounds__(SWEEP_THREADS)
    lastcols_affine_kernel(const uint8_t* q, int q_stride, const uint8_t* s,
                           int s_stride, const int* ms, const int* ns,
                           const uint8_t* sgaps, const int* strip_start, int B,
                           int total, AffineScoring sc, int* ticket,
                           int* bcols, int* bcols_e, int bcol_stride,
                           int* flags, int* cols, int* cols_e,
                           int col_stride) {
  __shared__ SweepAffineShared sh;
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
    StripAffine S;
    S.q = q + (size_t)b * q_stride;
    S.m = ms[b];
    S.s = s + (size_t)b * s_stride;
    S.n = ns[b];
    S.col0 = kk * STRIP;
    S.global_init = true;
    S.start_gap = sgaps[b] != 0;
    S.left_h = kk > 0 ? bcols + (size_t)(k - 1) * bcol_stride : nullptr;
    S.left_e = kk > 0 ? bcols_e + (size_t)(k - 1) * bcol_stride : nullptr;
    S.left_flag = kk > 0 ? flags + (k - 1) : nullptr;
    S.right_h = kk + 1 < count ? bcols + (size_t)k * bcol_stride : nullptr;
    S.right_e = kk + 1 < count ? bcols_e + (size_t)k * bcol_stride : nullptr;
    S.right_flag = flags + k;
    S.last_col = cols + (size_t)b * col_stride;
    S.last_col_e = cols_e + (size_t)b * col_stride;
    S.last_row = nullptr;
    S.preds = nullptr;
    S.pred_stride = 0;
    S.best = nullptr;
    sweep_strip_affine<false, false, false>(S, sc, sh);
  }
}

// strip_start: (B + 1) ints, the prefix sums of each problem's strip
// count ceil(ns[b] / 1024) (0 for an empty problem); total = strip_start[B];
// sgaps: B bytes, 0 or 1. Scratch: ticket (1 int, zeroed), flags (total
// ints, zeroed), bcols and bcols_e (total * bcol_stride ints each,
// bcol_stride >= max ms).
extern "C" int anyseq_lastcols_affine(
    const void* q, int q_stride, const void* s, int s_stride, const void* ms,
    const void* ns, const void* sgaps, const void* strip_start, int B,
    int total, int match, int mismatch, int gap_open, int gap_extend,
    void* ticket, void* bcols, void* bcols_e, int bcol_stride, void* flags,
    void* cols, void* cols_e, int col_stride, void* stream) {
  const AffineScoring sc{match, mismatch, gap_open, gap_extend};
  const int grid = imin(
      total, resident_ctas((const void*)lastcols_affine_kernel, SWEEP_THREADS));
  if (grid <= 0) return 0;
  ANYSEQ_LAUNCH(lastcols_affine_kernel, grid, SWEEP_THREADS, stream,
                (const uint8_t*)q, q_stride, (const uint8_t*)s, s_stride,
                (const int*)ms, (const int*)ns, (const uint8_t*)sgaps,
                (const int*)strip_start, B, total, sc, (int*)ticket,
                (int*)bcols, (int*)bcols_e, bcol_stride, (int*)flags,
                (int*)cols, (int*)cols_e, col_stride);
  return (int)cudaGetLastError();
}
