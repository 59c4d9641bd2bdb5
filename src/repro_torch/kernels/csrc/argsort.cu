// Stable argsort of int64 keys: int32 permutation out.
//
// Replaces: bitonic_sort_multi (src/repro/kernels/bitonic_sort.py:91) as
// reached through ops.argsort_keys (src/repro/kernels/ops.py:78), which
// sorts one pow2 tile of uint32 key lanes with the row index as the lowest
// lane so that the unstable network becomes a stable argsort.
//
// What bounds it on the H100: for the main path's 65,536 keys the work is
// latency and launches, not bytes — the input is 512 KB and the output
// 256 KB, which the card moves in well under a microsecond.  A whole vector
// does not fit one block's shared memory, as it fit one TPU tile in VMEM.
//
// Design: compare (key, row index) pairs, which are all distinct, so any
// sorting network gives the stable order — including for interior EMPTY
// rows, which tie on the key.  (1) Each block bitonic-sorts a 2048-pair tile
// in shared memory (24 KB); the pow2 padding of the last tile carries key
// INT64_MAX and an index >= n, so it sorts after every real row.  (2)
// log2(n / 2048) merge passes double the sorted run length; every output
// element finds its merge-path split on its diagonal by binary search
// (merge_split.cuh, shared with the merge-absorb kernel) and writes itself.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_split.cuh"

namespace {

constexpr int TILE = 2048;
constexpr int TILE_THREADS = 1024;
constexpr int MERGE_THREADS = 256;
constexpr int64_t KEY_MAX = 0x7fffffffffffffffLL;

__device__ __forceinline__ bool pair_le(int64_t ka, int ia, int64_t kb, int ib) {
  return ka < kb || (ka == kb && ia <= ib);
}

__global__ void tile_sort(const int64_t* keys, long long n, int64_t* okeys, int* oidx) {
  __shared__ int64_t sk[TILE];
  __shared__ int si[TILE];
  const long long base = (long long)blockIdx.x * TILE;
  for (int t = threadIdx.x; t < TILE; t += TILE_THREADS) {
    const long long g = base + t;
    sk[t] = g < n ? keys[g] : KEY_MAX;
    si[t] = (int)g;
  }
  __syncthreads();
  for (int k = 2; k <= TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < TILE; t += TILE_THREADS) {
        const int p = t ^ j;
        if (p > t) {
          const bool ascending = (t & k) == 0;
          const int64_t ka = sk[t], kb = sk[p];
          const int ia = si[t], ib = si[p];
          const bool greater = !pair_le(ka, ia, kb, ib);  // pairs are distinct
          if (greater == ascending) {
            sk[t] = kb;
            sk[p] = ka;
            si[t] = ib;
            si[p] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < TILE; t += TILE_THREADS) {
    if (base + t < n) {
      okeys[base + t] = sk[t];
      oidx[base + t] = si[t];
    }
  }
}

// Merges adjacent sorted runs of length w into runs of length 2w.
__global__ void merge_pass(const int64_t* ik, const int* ii, long long n, long long w,
                           int64_t* ok, int* oi) {
  const long long k = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (k >= n) return;
  const long long a0 = (k / (2 * w)) * (2 * w);
  const long long na = min(w, n - a0);
  const long long b0 = a0 + na;
  const long long nb = max(0LL, min(w, n - b0));
  const int64_t* ka = ik + a0;
  const int* ia = ii + a0;
  const int64_t* kb = ik + b0;
  const int* ib = ii + b0;
  auto le = [&](long long x, long long y) { return pair_le(ka[x], ia[x], kb[y], ib[y]); };
  const long long diag = k - a0;
  const long long i = repro::merge_path_split(diag, na, nb, le);
  const long long j = diag - i;
  if (repro::merge_take_a(i, j, na, nb, le)) {
    ok[k] = ka[i];
    oi[k] = ia[i];
  } else {
    ok[k] = kb[j];
    oi[k] = ib[j];
  }
}

}  // namespace

extern "C" int repro_argsort(const int64_t* keys, long long n, int64_t* kbuf0, int* ibuf0,
                             int64_t* kbuf1, int* ibuf1, int* perm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  tile_sort<<<(unsigned)((n + TILE - 1) / TILE), TILE_THREADS, 0, s>>>(keys, n, kbuf0, ibuf0);
  int64_t* ck = kbuf0;
  int* ci = ibuf0;
  int64_t* nk = kbuf1;
  int* ni = ibuf1;
  for (long long w = TILE; w < n; w *= 2) {
    merge_pass<<<(unsigned)((n + MERGE_THREADS - 1) / MERGE_THREADS), MERGE_THREADS, 0, s>>>(
        ck, ci, n, w, nk, ni);
    int64_t* tk = ck;
    ck = nk;
    nk = tk;
    int* ti = ci;
    ci = ni;
    ni = ti;
  }
  cudaMemcpyAsync(perm, ci, n * sizeof(int), cudaMemcpyDeviceToDevice, s);
  return (int)cudaGetLastError();
}
