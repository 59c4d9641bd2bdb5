// Merge-absorb of two key-sorted aggregate states of unequal lengths.
//
// Replaces: merge_path_tiles (src/repro/kernels/merge_path.py:112), the
// Pallas merge-path merge with the segmented scan fused, together with the
// compaction its caller runs (ops.merge_absorb_sorted and ops._compact,
// src/repro/kernels/ops.py:174,127).
//
// What bounds it on the H100: memory.  The merge and the combine do O(1)
// work a row (plus a log2 binary search per output row) and must read both
// states and write the merged, compacted one: (8 + 4 + 4V) bytes a row each
// way.  At the main path's shapes, (M + 2B) + B = 1,179,648 + 65,536 rows in
// run generation and (M + P) + P = 1,064,960 + 16,384 rows per wide-merge
// page, that is about 20 MB in and 20 MB out, some 12 us at 3.35 TB/s.
//
// Design: (1) every output row finds its merge-path split on its diagonal by
// binary search (merge_split.cuh, A wins ties, duplicates allowed on either
// side) and copies its row into a merged scratch state; (2) the segmented
// combine of seg_combine.cuh combines the now-adjacent equal keys and
// compacts the groups to the front at capacity |A| + |B|.  Two kernels
// through device memory instead of one fused pass: simple first; fusing the
// combine into the merge is later work.  With duplicate-free inputs
// (assume_unique) the same combine is exact, so one path serves both.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_split.cuh"
#include "seg_combine.cuh"

namespace {

constexpr int MERGE_THREADS = 256;

struct Side {
  const int64_t* keys;
  const int32_t* cnt;
  const float* sum;
  const float* min;
  const float* max;
};

__device__ __forceinline__ void copy_row(const Side& src, long long r, long long k, int vs,
                                         int vm, int vx, int64_t* km, int32_t* cm, float* sm,
                                         float* mnm, float* mxm) {
  km[k] = src.keys[r];
  cm[k] = src.cnt[r];
  for (int v = 0; v < vs; ++v) sm[k * vs + v] = src.sum[r * vs + v];
  for (int v = 0; v < vm; ++v) mnm[k * vm + v] = src.min[r * vm + v];
  for (int v = 0; v < vx; ++v) mxm[k * vx + v] = src.max[r * vx + v];
}

__global__ void merge_rows(Side a, long long na, Side b, long long nb, int vs, int vm, int vx,
                           int64_t* km, int32_t* cm, float* sm, float* mnm, float* mxm) {
  const long long k = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (k >= na + nb) return;
  const int64_t* ka = a.keys;
  const int64_t* kb = b.keys;
  auto le = [&](long long x, long long y) { return ka[x] <= kb[y]; };
  const long long i = repro::merge_path_split(k, na, nb, le);
  const long long j = k - i;
  if (repro::merge_take_a(i, j, na, nb, le)) {
    copy_row(a, i, k, vs, vm, vx, km, cm, sm, mnm, mxm);
  } else {
    copy_row(b, j, k, vs, vm, vx, km, cm, sm, mnm, mxm);
  }
}

}  // namespace

extern "C" long long repro_merge_absorb_scratch_bytes(long long n, int ncols) {
  return repro::sc_scratch_bytes(n, ncols);
}

// merged_* is scratch of na + nb rows; *_out receives the result.
extern "C" int repro_merge_absorb(
    const int64_t* ka, const int32_t* ca, const float* sa, const float* mna, const float* mxa,
    long long na, const int64_t* kb, const int32_t* cb, const float* sb, const float* mnb,
    const float* mxb, long long nb, int vs, int vm, int vx, long long empty,
    int64_t* merged_keys, int32_t* merged_cnt, float* merged_sum, float* merged_min,
    float* merged_max, int64_t* keys_out, int32_t* cnt_out, float* sum_out, float* min_out,
    float* max_out, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = na + nb;
  if (n == 0) return (int)cudaGetLastError();
  repro::Cols cols;
  int err = repro::make_cols(cols, merged_cnt, cnt_out, merged_sum, sum_out, vs, merged_min,
                             min_out, vm, merged_max, max_out, vx);
  if (err) return err;
  Side a{ka, ca, sa, mna, mxa};
  Side b{kb, cb, sb, mnb, mxb};
  merge_rows<<<(unsigned)((n + MERGE_THREADS - 1) / MERGE_THREADS), MERGE_THREADS, 0, s>>>(
      a, na, b, nb, vs, vm, vx, merged_keys, merged_cnt, merged_sum, merged_min, merged_max);
  err = (int)cudaGetLastError();
  if (err) return err;
  return repro::seg_combine_launch(merged_keys, n, (int64_t)empty, cols, keys_out, scratch, s);
}
