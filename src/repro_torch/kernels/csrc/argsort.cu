// Stable argsort of int64 keys: int32 permutation out.
//
// Replaces: bitonic_sort_multi (src/repro/kernels/bitonic_sort.py:91) as
// reached through ops.argsort_keys (src/repro/kernels/ops.py:78), which
// sorts one pow2 tile of uint32 key lanes with the row index as the lowest
// lane so that the unstable network becomes a stable argsort.
//
// What bounds it on the H100: for the paths' sizes (32 keys at decode,
// 8,192 at prefill, 65,536 a batch of the aggregate) latency and launches,
// not bytes: 65,536 keys are 512 KB in and 256 KB out, which the card
// moves in well under a microsecond.  So a call is one launch with no
// memcpy up to 65,536 keys, and the data stays in shared memory from the
// first load to the last store.  Within a CTA the merge rounds are bound
// by shared-memory wavefronts (8-byte keys, scattered split searches and
// serial loads), so the CTAs are kept small and many: a cluster of 8 CTAs
// of 1,024 pairs sorts 8,192 keys faster than one CTA does.
//
// Design: order (key, row index) pairs, which are all distinct, so the
// order is the stable one, interior EMPTY rows (which tie on the key)
// included.  Padding pairs carry key INT64_MAX and an index >= n, so they
// sort after every real row.  Every merge path below takes run A's rows
// from before run B's, so comparing keys with A winning ties is the pair
// order; only the bitonic networks compare indices.  The size class and
// its shape are chosen by one rule in Python (bitonic_sort.plan), which
// depends on n alone; repro_argsort refuses a plan its input does not
// allow.
//   warp     n <= 32: one warp, one pair a lane, a bitonic network through
//            shuffles;
//   block    n <= 1,024: one block; the tile is padded to the next power of
//            two (tile / 8 threads).  Each thread sorts 8 pairs in
//            registers, a warp merges its threads' runs by bitonic merges
//            through shuffles, then merge rounds in shared memory double
//            the sorted runs: each thread finds the merge-path split of its
//            8 outputs (merge_split.cuh) and merges them serially;
//   cluster  n <= 65,536: one thread-block cluster of 2-16 CTAs of 1,024 to
//            4,096 pairs (above 8 CTAs a non-portable size).  Each CTA
//            sorts its tile as a block does, then log2(CTAs) rounds merge
//            pairs of runs that span CTAs: a CTA finds the splits of its
//            outputs with one warp each in its partners' shared memory
//            (distributed shared memory), copies its slices into a buffer
//            of its own shared memory, and merges there into the other of
//            its two run buffers;
//   large    n above: clusters sort chunks into device memory, then merge
//            passes double the runs; each block of 2,048 outputs finds its
//            two splits once with one warp each, loads its slices coalesced
//            into shared memory and merges there.  The last pass writes the
//            permutation.
// Every class writes the permutation coalesced: the warp from registers, the
// others from shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_split.cuh"

namespace cg = cooperative_groups;

namespace {

enum Variant : int { WARP = 0, BLOCK = 1, CLUSTER = 2, LARGE = 3 };

constexpr int IPT = 8;              // pairs a thread holds
constexpr int MAX_TILE = 4096;      // pairs a CTA sorts: 54 KB padded, thrice in a cluster
constexpr int MAX_CLUSTER = 16;     // CTAs of a cluster (above 8 a non-portable size)
constexpr int PASS_TILE = 2048;     // outputs of a block of the large class's merge passes
constexpr int PASS_THREADS = PASS_TILE / IPT;
constexpr size_t PAIR_BYTES = sizeof(int64_t) + sizeof(int);
constexpr int64_t KEY_MAX = 0x7fffffffffffffffLL;

__device__ __forceinline__ bool pair_le(int64_t ka, int ia, int64_t kb, int ib) {
  return ka < kb || (ka == kb && ia <= ib);
}

// Pairs lie in shared memory as a key and an index array, padded one slot
// in every 8: a thread's 8 consecutive pairs and a warp's 32 consecutive
// pairs then fall in distinct banks (unpadded, a thread-blocked store of
// int64 keys is a 16-way bank conflict).
__host__ __device__ constexpr int slot(int p) { return p + (p >> 3); }
static_assert(IPT == 8, "a thread's pairs fill the 8 slots between two pads");

// Odd-even transposition sort of a thread's pairs by key, in registers:
// it swaps only a greater key, so it is stable, and a thread's pairs come
// in row order.
__device__ __forceinline__ void reg_sort(int64_t (&k)[IPT], int (&x)[IPT]) {
#pragma unroll
  for (int r = 0; r < IPT; ++r) {
#pragma unroll
    for (int a = r & 1; a + 1 < IPT; a += 2) {
      if (k[a] > k[a + 1]) {
        const int64_t tk = k[a];
        k[a] = k[a + 1];
        k[a + 1] = tk;
        const int tx = x[a];
        x[a] = x[a + 1];
        x[a + 1] = tx;
      }
    }
  }
}

// Outputs [d, d + IPT) of merge(A, B) into k/x, where A is the na pairs
// from pair a0 of sk/si and B the nb pairs from pair b0.  Every merge of
// this file takes A's rows from before B's, so A winning ties on the key
// is the (key, row index) order.  The indices are gathered after the
// keys' merge, off its chain of dependent loads.  Outputs past na + nb
// are left unspecified.
__device__ __forceinline__ void merge_serial(const int64_t* sk, const int* si, int a0, int na,
                                             int b0, int nb, int d, int64_t (&k)[IPT],
                                             int (&x)[IPT]) {
  d = min(d, na + nb);
  int i = repro::merge_path_split(
      d, na, nb, [&](int p, int q) { return sk[slot(a0 + p)] <= sk[slot(b0 + q)]; });
  int j = d - i;
  int64_t a_k = i < na ? sk[slot(a0 + i)] : KEY_MAX, b_k = j < nb ? sk[slot(b0 + j)] : KEY_MAX;
  int src[IPT];
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    if (j >= nb || (i < na && a_k <= b_k)) {
      k[u] = a_k;
      src[u] = a0 + i;
      if (++i < na) a_k = sk[slot(a0 + i)];
    } else {
      k[u] = b_k;
      src[u] = b0 + j;
      if (++j < nb) b_k = sk[slot(b0 + j)];
    }
  }
#pragma unroll
  for (int u = 0; u < IPT; ++u) x[u] = si[slot(src[u])];
}

// This thread's pairs to slots [p0, p0 + IPT) (p0 a multiple of IPT).
__device__ __forceinline__ void store_pairs(int64_t* sk, int* si, int p0, const int64_t (&k)[IPT],
                                            const int (&x)[IPT]) {
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    sk[slot(p0) + u] = k[u];
    si[slot(p0) + u] = x[u];
  }
}

// Rows [base, base + blockDim.x * IPT) of keys into sk/si (key INT64_MAX
// past n), striped: all loads in flight before the first store.
__device__ __forceinline__ void load_tile(const int64_t* __restrict__ keys, int n, int base,
                                          int64_t* sk, int* si) {
  int64_t k[IPT];
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const int p = threadIdx.x + u * blockDim.x;
    k[u] = base + p < n ? keys[base + p] : KEY_MAX;
  }
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const int p = threadIdx.x + u * blockDim.x;
    sk[slot(p)] = k[u];
    si[slot(p)] = base + p;
  }
}

// The compare-exchange of a bitonic network across lanes: this lane keeps
// the smaller of its pair and its partner's when `low`, else the larger.
__device__ __forceinline__ void keep(bool low, int64_t& k, int& x, int64_t pk, int px) {
  if (pair_le(k, x, pk, px) != low) {
    k = pk;
    x = px;
  }
}

// Merges, in each warp, the sorted runs of IPT pairs its lanes hold (lane
// l: positions [l * IPT, l * IPT + IPT) of the warp's) into one sorted run
// of nlanes * IPT, pairs in registers: each doubling is a bitonic merge,
// the first stage against the mirrored run, the stages of a stride of IPT
// and more through shuffles, the rest within the lane.  No shared memory
// and no barrier.  `lanes` are the warp's nlanes (a power of two) threads.
// A network orders the distinct (key, row index) pairs, so the result is
// the stable order.
__device__ __forceinline__ void warp_merge_runs(int64_t (&k)[IPT], int (&x)[IPT], int nlanes,
                                                unsigned lanes) {
  const int lane = threadIdx.x & 31;
  for (int group = 2; group <= nlanes; group *= 2) {  // lanes of the two runs
    int64_t pk[IPT];
    int px[IPT];
#pragma unroll
    for (int u = 0; u < IPT; ++u) {  // the mirror lane's pairs, reversed
      pk[u] = __shfl_xor_sync(lanes, k[IPT - 1 - u], group - 1);
      px[u] = __shfl_xor_sync(lanes, x[IPT - 1 - u], group - 1);
    }
    const bool low = (lane & (group / 2)) == 0;
#pragma unroll
    for (int u = 0; u < IPT; ++u) keep(low, k[u], x[u], pk[u], px[u]);
    for (int d = group / 4; d >= 1; d /= 2) {
      const bool low_d = (lane & d) == 0;
#pragma unroll
      for (int u = 0; u < IPT; ++u) {
        const int64_t ok = __shfl_xor_sync(lanes, k[u], d);
        const int ox = __shfl_xor_sync(lanes, x[u], d);
        keep(low_d, k[u], x[u], ok, ox);
      }
    }
#pragma unroll
    for (int j = IPT / 2; j >= 1; j /= 2) {
#pragma unroll
      for (int u = 0; u < IPT; ++u) {
        if ((u & j) == 0 && !pair_le(k[u], x[u], k[u + j], x[u + j])) {
          const int64_t tk = k[u];
          k[u] = k[u + j];
          k[u + j] = tk;
          const int tx = x[u];
          x[u] = x[u + j];
          x[u + j] = tx;
        }
      }
    }
  }
}

// Sorts the block's tile of blockDim.x * IPT pairs (a power of two) in
// sk/si; every thread calls it after the tile is loaded and visible.  A
// thread sorts its pairs, a warp merges its threads' runs by shuffles,
// then each merge round in shared memory doubles the runs.  Returns with
// the sorted tile in sk/si, visible to the block, and this thread's
// outputs [tid * IPT, tid * IPT + IPT) in k/x.
__device__ void block_sort(int64_t* sk, int* si, int64_t (&k)[IPT], int (&x)[IPT]) {
  const int tile = blockDim.x * IPT, p0 = threadIdx.x * IPT;
  const int nlanes = blockDim.x < 32 ? blockDim.x : 32;
  const unsigned lanes = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1;
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    k[u] = sk[slot(p0) + u];
    x[u] = si[slot(p0) + u];
  }
  reg_sort(k, x);
  warp_merge_runs(k, x, nlanes, lanes);
  store_pairs(sk, si, p0, k, x);
  for (int run = nlanes * IPT; run < tile; run *= 2) {
    __syncthreads();
    const int g = p0 & ~(2 * run - 1);  // the first pair of the two runs this thread merges
    merge_serial(sk, si, g, run, g + run, run, p0 - g, k, x);
    __syncthreads();
    store_pairs(sk, si, p0, k, x);
  }
  __syncthreads();
}

__global__ void sort_warp(const int64_t* keys, int n, int* perm) {
  const int lane = threadIdx.x;
  int64_t k = lane < n ? keys[lane] : KEY_MAX;
  int x = lane;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const int64_t ok = __shfl_xor_sync(0xffffffffu, k, j);
      const int ox = __shfl_xor_sync(0xffffffffu, x, j);
      // the lower lane of a pair keeps the smaller pair in an ascending run
      const bool keep_smaller = ((lane & j) == 0) == ((lane & size) == 0);
      if (pair_le(k, x, ok, ox) != keep_smaller) {
        k = ok;
        x = ox;
      }
    }
  }
  if (lane < n) perm[lane] = x;
}

__global__ void __launch_bounds__(MAX_TILE / IPT) sort_block(const int64_t* keys, int n, int* perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockDim.x * IPT;
  int64_t* sk = (int64_t*)smem;
  int* si = (int*)(sk + slot(tile));
  load_tile(keys, n, 0, sk, si);
  __syncthreads();
  int64_t k[IPT];
  int x[IPT];
  block_sort(sk, si, k, x);
  for (int p = threadIdx.x; p < n; p += blockDim.x) perm[p] = si[slot(p)];
}

// One cluster sorts the chunk of its CTAs' tiles (blockDim.x * IPT pairs
// each, a power of two); the result goes to perm (okeys null) or, as
// pairs, to okeys/oidx (rows < n only).  A CTA's runs alternate between
// two buffers, so a round reads its partners' runs from one while it
// writes its own to the other: one cluster barrier a round.
__global__ void __launch_bounds__(MAX_TILE / IPT, 1)
sort_cluster(const int64_t* keys, int n, int* perm, int64_t* okeys, int* oidx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockDim.x * IPT, shift = __ffs(tile) - 1;
  // the CTA's run (keys, indices) in one buffer, the next round's in the
  // other, and its slices of the partners' runs
  int64_t* rk = (int64_t*)smem;
  int64_t* nk = rk + slot(tile);
  int64_t* tk = nk + slot(tile);
  int* ri = (int*)(tk + slot(tile));
  int* ni = ri + slot(tile);
  int* ti = ni + slot(tile);
  __shared__ int s_split[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * tile;
  load_tile(keys, n, base, rk, ri);
  __syncthreads();
  int64_t k[IPT];
  int x[IPT];
  block_sort(rk, ri, k, x);

  for (int w = 1; w < ctas; w *= 2) {  // runs of w CTAs merge in pairs
    // the partners' runs are complete, and their reads of the other
    // buffer, which this round writes, are done
    cluster.sync();
    const int first = rank & ~(2 * w - 1);  // the group's first CTA: run A, then run B
    const int run = w * tile, d0 = (rank - first) * tile;
    // key or index of pair p of run A (b = 0) or B (b = 1), in the shared
    // memory of the CTA that holds it
    auto at_k = [&](int b, int p) {
      return *cluster.map_shared_rank(rk + slot(p & (tile - 1)), first + b * w + (p >> shift));
    };
    auto at_i = [&](int b, int p) {
      return *cluster.map_shared_rank(ri + slot(p & (tile - 1)), first + b * w + (p >> shift));
    };
    if (warp < 2) {
      const int i = (int)repro::warp_merge_path_split(
          (long long)(d0 + warp * tile), (long long)run, (long long)run,
          [&](long long p, long long q) { return at_k(0, (int)p) <= at_k(1, (int)q); });
      if (lane == 0) s_split[warp] = i;
    }
    __syncthreads();
    // the CTA's slices, A's [i0, i0 + la) then B's [j0, j0 + lb): all loads
    // in flight before the first store
    const int i0 = s_split[0], la = s_split[1] - i0, j0 = d0 - i0;
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int p = tid + u * blockDim.x;
      const int b = p < la ? 0 : 1, q = p < la ? i0 + p : j0 + p - la;
      k[u] = at_k(b, q);
      x[u] = at_i(b, q);
    }
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      tk[slot(tid + u * blockDim.x)] = k[u];
      ti[slot(tid + u * blockDim.x)] = x[u];
    }
    __syncthreads();
    merge_serial(tk, ti, 0, la, la, tile - la, tid * IPT, k, x);
    store_pairs(nk, ni, tid * IPT, k, x);
    int64_t* t64 = rk;
    rk = nk;
    nk = t64;
    int* t32 = ri;
    ri = ni;
    ni = t32;
  }
  // no CTA leaves while a partner may still read its runs
  if (ctas > 1) cluster.sync();
  for (int p = tid; p < tile && base + p < n; p += blockDim.x) {
    if (okeys) {
      okeys[base + p] = rk[slot(p)];
      oidx[base + p] = ri[slot(p)];
    } else {
      perm[base + p] = ri[slot(p)];
    }
  }
}

// Merges adjacent sorted runs of w pairs (w a multiple of PASS_TILE / 2)
// into runs of 2w: block b writes outputs [b * PASS_TILE, ...), to ok/oi,
// or only the permutation when perm is given.
__global__ void __launch_bounds__(PASS_THREADS)
merge_pass(const int64_t* ik, const int* ii, long long n, long long w, int64_t* ok, int* oi,
           int* perm) {
  __shared__ int64_t sk[slot(PASS_TILE)];
  __shared__ int si[slot(PASS_TILE)];
  __shared__ long long s_split[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d0 = (long long)blockIdx.x * PASS_TILE;
  const long long g = d0 / (2 * w) * (2 * w);  // the first pair of the two runs
  const long long na = min(w, n - g), nb = max(0LL, min(w, n - g - na));
  const long long e0 = d0 - g, e1 = min(e0 + PASS_TILE, na + nb);
  const int64_t* ak = ik + g;
  const int* ai = ii + g;
  const int64_t* bk = ak + na;
  const int* bi = ai + na;
  if (warp < 2) {
    const long long i = repro::warp_merge_path_split(
        warp == 0 ? e0 : e1, na, nb,
        [&](long long p, long long q) { return ak[p] <= bk[q]; });
    if (lane == 0) s_split[warp] = i;
  }
  __syncthreads();
  const long long i0 = s_split[0], j0 = e0 - i0;
  const int cnt = (int)(e1 - e0), la = (int)(s_split[1] - i0), lb = cnt - la;
  for (int p = tid; p < la; p += PASS_THREADS) {
    sk[slot(p)] = ak[i0 + p];
    si[slot(p)] = ai[i0 + p];
  }
  for (int p = tid; p < lb; p += PASS_THREADS) {
    sk[slot(la + p)] = bk[j0 + p];
    si[slot(la + p)] = bi[j0 + p];
  }
  __syncthreads();
  int64_t k[IPT];
  int x[IPT];
  merge_serial(sk, si, 0, la, la, lb, tid * IPT, k, x);
  __syncthreads();
  store_pairs(sk, si, tid * IPT, k, x);
  __syncthreads();
  for (int p = tid; p < cnt; p += PASS_THREADS) {
    if (perm) {
      perm[d0 + p] = si[slot(p)];
    } else {
      ok[d0 + p] = sk[slot(p)];
      oi[d0 + p] = si[slot(p)];
    }
  }
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

int launch_cluster(int tile, int ctas, int clusters, cudaStream_t s, const int64_t* keys, int n,
                   int* perm, int64_t* okeys, int* oidx) {
  const size_t smem = 3 * slot(tile) * PAIR_BYTES;
  int err = (int)cudaFuncSetAttribute(sort_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (!err && ctas > 8)
    err = (int)cudaFuncSetAttribute(sort_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                    1);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ctas * clusters));
  cfg.blockDim = dim3(tile / IPT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, sort_cluster, keys, n, perm, okeys, oidx);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// The plan (variant, tile, cluster) is bitonic_sort.plan(n); the call is
// refused (cudaErrorInvalidValue) where the input does not fit it.
// kbuf/ibuf (n pairs each) are read only by the large class.
extern "C" int repro_argsort(const int64_t* keys, long long n, int variant, int tile,
                             int cluster, int64_t* kbuf0, int* ibuf0, int64_t* kbuf1,
                             int* ibuf1, int* perm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunk = (long long)tile * cluster;  // what one cluster sorts
  // 32-bit row indices, a cluster's padding included
  if (n < 0 || n > 0x7fffffffLL - (long long)MAX_TILE * MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  // a cluster's CTAs: at least two warps (the splits), at most MAX_TILE pairs
  const bool ctas_ok = pow2(tile) && tile >= 64 * IPT && tile <= MAX_TILE && pow2(cluster) &&
                       cluster >= 2 && cluster <= MAX_CLUSTER;
  bool ok;
  switch (variant) {
    case WARP: ok = tile == 32 && cluster == 1 && n <= 32; break;
    case BLOCK: ok = pow2(tile) && tile >= 64 && tile <= MAX_TILE && cluster == 1 && n <= tile;
      break;
    case CLUSTER: ok = ctas_ok && n <= chunk; break;
    case LARGE: ok = ctas_ok && n > chunk && kbuf0 && ibuf0 && kbuf1 && ibuf1; break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int ni = (int)n;
  if (variant == WARP) {
    sort_warp<<<1, 32, 0, s>>>(keys, ni, perm);
    return (int)cudaGetLastError();
  }
  if (variant == BLOCK) {
    const size_t smem = slot(tile) * PAIR_BYTES;
    int err = (int)cudaFuncSetAttribute(sort_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (err) return err;
    sort_block<<<1, tile / IPT, smem, s>>>(keys, ni, perm);
    return (int)cudaGetLastError();
  }
  if (variant == CLUSTER)
    return launch_cluster(tile, cluster, 1, s, keys, ni, perm, nullptr, nullptr);
  int err = launch_cluster(tile, cluster, (int)((n + chunk - 1) / chunk), s, keys, ni, nullptr,
                           kbuf0, ibuf0);
  if (err) return err;
  int64_t* ck = kbuf0;
  int* ci = ibuf0;
  int64_t* nk = kbuf1;
  int* nx = ibuf1;
  for (long long w = chunk; w < n; w *= 2) {
    const bool last = 2 * w >= n;
    merge_pass<<<(unsigned)((n + PASS_TILE - 1) / PASS_TILE), PASS_THREADS, 0, s>>>(
        ck, ci, n, w, nk, nx, last ? perm : nullptr);
    err = (int)cudaGetLastError();
    if (err) return err;
    int64_t* tk = ck;
    ck = nk;
    nk = tk;
    int* tx = ci;
    ci = nx;
    nx = tx;
  }
  return 0;
}
