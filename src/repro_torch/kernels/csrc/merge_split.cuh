// Merge-path diagonal split, shared by the argsort's merges (argsort.cu)
// and the merge-absorb pass (merge_absorb.cuh), and a warp's
// version of it for one diagonal of two sorted vectors in device memory.
//
// Output k of merge(A, B) lies on the k-th anti-diagonal of the |A| x |B|
// merge grid.  The split is the number i of A rows among the first k
// outputs, found by a binary search on the diagonal: taking i rows of A
// is feasible iff A[i-1] <= B[k-i] (A wins ties, so the merge is stable).
// That predicate falls monotonically in i, so the answer is the largest
// feasible i.  Counterpart of _merge_path_split in
// src/repro/kernels/merge_path.py, which searches every lane the same way.
#pragma once
#include <stdint.h>

namespace repro {

// le(x, y) answers "A[x] <= B[y]"; Idx is int for offsets in shared memory.
template <class Idx, class LessEq>
__device__ __forceinline__ Idx merge_path_split(Idx diag, Idx na, Idx nb, LessEq le) {
  Idx lo = diag > nb ? diag - nb : 0;
  Idx hi = diag < na ? diag : na;
  while (lo < hi) {
    // mid > lo >= max(0, diag - nb), so mid - 1 >= 0 and diag - mid < nb
    Idx mid = (lo + hi + 1) >> 1;
    if (le(mid - 1, diag - mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The split of `diag` by one warp (call with all 32 lanes; every lane
// returns it): each round the lanes test 32 evenly spaced candidates of
// the feasible interval at once, so the interval shrinks 32-fold a round
// (4 rounds of dependent loads for a million rows instead of 20).
template <class LessEq>
__device__ __forceinline__ long long warp_merge_path_split(long long diag, long long na,
                                                           long long nb, LessEq le) {
  const int lane = threadIdx.x & 31;
  long long lo = diag > nb ? diag - nb : 0;
  long long hi = diag < na ? diag : na;
  while (lo < hi) {
    // candidates in (lo, hi], the last one hi; feasibility falls with i, so
    // the feasible lanes are a prefix
    const long long c = lo + ((long long)(lane + 1) * (hi - lo) + 31) / 32;
    const unsigned ok = __ballot_sync(0xffffffffu, le(c - 1, diag - c));
    const int k = __popc(ok);
    const long long c_below = __shfl_sync(0xffffffffu, c, k > 0 ? k - 1 : 0);
    const long long c_above = __shfl_sync(0xffffffffu, c, k < 32 ? k : 31);
    const long long new_lo = k > 0 ? c_below : lo;
    hi = k < 32 ? c_above - 1 : hi;
    lo = new_lo;
  }
  return lo;
}

}  // namespace repro
