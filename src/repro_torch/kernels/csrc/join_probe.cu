// Merge-join probe: rank-align each key of a sorted left key vector against a
// sorted right key vector.
//
// Replaces: merge_path_probe_tiles (src/repro/kernels/merge_path.py:193, the
// kernel body is _make_probe_kernel at :163) together with its caller
// ops.join_probe (src/repro/kernels/ops.py:219).
//
// Computes, for each left row i: pos[i] = the lower bound of A[i] in B (the
// first j with A[i] <= B[j]) clipped into [0, m - 1], and hit[i] = (B[pos[i]]
// == A[i]) and A[i] is not EMPTY.  m == 0 gives pos 0 and no hit; n == 0
// launches nothing.  Keys are the port's int64 keys (u64 keys with the top
// bit flipped, which keeps their order), so the TPU's (hi, lo) uint32 lanes
// and the pow-2 padding of ops.join_probe have no counterpart here.
//
// What bounds it on the H100: memory.  It must read A and B once and write
// 4 + 1 bytes a left row: at n = m = 15 M rows (TPC-H SF-10 Q18, orders
// joined with the lineitem groups) that is about 315 MB, 94 us at 3.35 TB/s.
// Its operations (about log2(m) compares a row) are far below the card's
// rate.
//
// Design: simple first.  One thread per left row runs a binary search over B
// in global memory: ceil(log2(m + 1)) dependent loads a row, 24 at m = 15 M.
// A is sorted, so the threads of a warp search neighbouring keys and share
// the cache lines of the first levels (which stay in L2), but the last
// levels are scattered, latency-bound loads.  The faster design is later
// work: a merge-path partition of the two sorted inputs (each block takes an
// equal share of the |A| + |B| diagonal, found by one binary search per
// block, as merge_split.cuh does for the merge), so that a block walks its
// slices of A and B linearly in shared memory instead of doing ~24 dependent
// global loads a row, and reads each byte of B once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROBE_THREADS = 256;

__global__ void probe_rows(const int64_t* __restrict__ a, long long n,
                           const int64_t* __restrict__ b, long long m, int64_t empty,
                           int32_t* __restrict__ pos, uint8_t* __restrict__ hit) {
  const long long i = (long long)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t key = a[i];
  if (m == 0) {
    pos[i] = 0;
    hit[i] = 0;
    return;
  }
  long long lo = 0, hi = m;  // the lower bound lies in [lo, hi]
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (b[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long p = lo < m ? lo : m - 1;
  pos[i] = (int32_t)p;
  hit[i] = (b[p] == key && key != empty) ? 1 : 0;
}

}  // namespace

// a: n sorted keys, b: m sorted keys; pos (int32) and hit (one byte, 0 or 1)
// receive n rows each.
extern "C" int repro_join_probe(const int64_t* a, long long n, const int64_t* b, long long m,
                                long long empty, int32_t* pos, uint8_t* hit, void* stream) {
  if (n == 0) return 0;
  probe_rows<<<(unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS), PROBE_THREADS, 0,
               (cudaStream_t)stream>>>(a, n, b, m, (int64_t)empty, pos, hit);
  return (int)cudaGetLastError();
}
