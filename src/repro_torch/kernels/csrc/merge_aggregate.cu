// Bitonic merge-absorb of two key-sorted aggregate states (u32-domain keys
// in int64, EMPTY padding), the foil of the merge-path kernel.
//
// Replaces: merge_absorb_tiles (src/repro/kernels/merge_aggregate.py:75),
// the Pallas bitonic merge of A ++ reverse(B) with the segmented scan
// fused, together with the compaction its caller runs
// (ops.merge_absorb_sorted_bitonic and ops._compact,
// src/repro/kernels/ops.py:202,127).
//
// What bounds it on the H100: memory.  It computes the same function as
// merge_path.cu, so its least time is the same: read both states and write
// the merged, compacted one, (8 + 4 + 4V) bytes a row each way.  The foil's
// own costs come on top: both sides are padded to n, the next power of two
// of the larger side (at the wide merge's 1,064,960 + 16,384 rows, n = 2^21
// and 2n = 4,194,304 rows are merged, 3.9x the real rows), and a bitonic
// merge of 2n rows takes log2(2n) compare-exchange stages where the merge
// path reads each row once.
//
// Design: the network sorts (key, source position) pairs, not whole rows.
// Position p < n of A ++ reverse(B) is A's row p, p >= n is B's row
// 2n - 1 - p; rows past a side's length are virtual EMPTY rows, never
// stored.  A stage of stride j compare-exchanges p and p + j (p's bit j
// clear) and swaps only if key[p] > key[p + j]: at equal keys each side
// keeps its own element, as the reference's take_self, so the permutation
// is the reference network's.  Stages whose stride is at least a tile of
// 2048 pairs run as global passes, one launch a stage, in place on a key
// and a position buffer (the first reads the two sides directly); the last
// 11 stages run in shared memory, one block a tile, which then gathers each
// merged row's count and planes from its side into the merged state.  The
// segmented combine (the B-less fused pass of merge_absorb.cuh, as
// segmented_combine.cu runs it) absorbs the duplicates and compacts the
// groups to the front: the reference fuses that scan into the merge
// kernel, here it is two more launches and a memset through device
// memory.  Left for later: several global stages a pass (registers hold
// 2^r elements a thread), and the combine fused into the last
// shared-memory phase.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_absorb.cuh"

namespace {

constexpr int BT_TILE = 2048;     // elements of a shared-memory tile
constexpr int BT_THREADS = 1024;  // one pair a thread per stage
constexpr int BT_STAGE_THREADS = 256;

struct Sides {
  const int64_t* ka;
  long long na;
  const int64_t* kb;
  long long nb;
  long long n;  // padded side length (a power of two)
  int64_t empty;
};

struct Rows {
  const int32_t* cnt;
  const float* sum;
  const float* min;
  const float* max;
};

__device__ __forceinline__ int64_t side_key(const Sides& s, long long p) {
  if (p < s.n) return p < s.na ? s.ka[p] : s.empty;
  const long long q = 2 * s.n - 1 - p;
  return q < s.nb ? s.kb[q] : s.empty;
}

// One compare-exchange stage of stride j = 2^lj >= BT_TILE over all 2n
// positions; thread t handles the pair (lo, lo + j).
__global__ void bitonic_global_stage(Sides s, int64_t* keys, int32_t* pos, int lj,
                                     int from_sides) {
  const long long t = (long long)blockIdx.x * BT_STAGE_THREADS + threadIdx.x;
  if (t >= s.n) return;
  const long long j = 1LL << lj;
  const long long lo = ((t >> lj) << (lj + 1)) | (t & (j - 1));
  const long long hi = lo + j;
  int64_t klo, khi;
  int32_t plo, phi;
  if (from_sides) {
    klo = side_key(s, lo);
    khi = side_key(s, hi);
    plo = (int32_t)lo;
    phi = (int32_t)hi;
  } else {
    klo = keys[lo];
    khi = keys[hi];
    plo = pos[lo];
    phi = pos[hi];
  }
  if (klo > khi) {
    keys[lo] = khi;
    keys[hi] = klo;
    pos[lo] = phi;
    pos[hi] = plo;
  } else {
    keys[lo] = klo;
    keys[hi] = khi;
    pos[lo] = plo;
    pos[hi] = phi;
  }
}

// The stages of stride tile/2 .. 1 of one tile in shared memory, then the
// merged rows of the tile: key, count and planes gathered from their side.
__global__ void __launch_bounds__(BT_THREADS)
bitonic_tile(Sides s, const int64_t* keys, const int32_t* pos, int tile, int from_sides,
             Rows a, Rows b, int vs, int vm, int vx, int64_t* km, int32_t* cm, float* sm,
             float* mnm, float* mxm) {
  __shared__ int64_t sk[BT_TILE];
  __shared__ int32_t sp[BT_TILE];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += BT_THREADS) {
    const long long p = base + i;
    sk[i] = from_sides ? side_key(s, p) : keys[p];
    sp[i] = from_sides ? (int32_t)p : pos[p];
  }
  __syncthreads();
  for (int j = tile / 2; j >= 1; j >>= 1) {
    for (int t = threadIdx.x; t < tile / 2; t += BT_THREADS) {
      const int lo = (t / j) * 2 * j + (t % j), hi = lo + j;
      const int64_t klo = sk[lo], khi = sk[hi];
      if (klo > khi) {
        sk[lo] = khi;
        sk[hi] = klo;
        const int32_t p = sp[lo];
        sp[lo] = sp[hi];
        sp[hi] = p;
      }
    }
    __syncthreads();
  }
  const float inf = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < tile; i += BT_THREADS) {
    const long long k = base + i;
    const long long p = sp[i];
    const bool from_a = p < s.n;
    const long long r = from_a ? p : 2 * s.n - 1 - p;
    const bool real = r < (from_a ? s.na : s.nb);
    const Rows& src = from_a ? a : b;
    km[k] = sk[i];
    cm[k] = real ? src.cnt[r] : 0;  // a padding row: EMPTY with neutral values
    for (int v = 0; v < vs; ++v) sm[k * vs + v] = real ? src.sum[r * vs + v] : 0.f;
    for (int v = 0; v < vm; ++v) mnm[k * vm + v] = real ? src.min[r * vm + v] : inf;
    for (int v = 0; v < vx; ++v) mxm[k * vx + v] = real ? src.max[r * vx + v] : -inf;
  }
}

}  // namespace

extern "C" long long repro_merge_absorb_bitonic_scratch_bytes(long long n, int ncols) {
  return repro::merge_absorb_scratch_bytes(n, ncols);
}

// n: the padded side length, a power of two >= max(na, nb), n >= 2.
// kbuf/pbuf: 2n keys and positions; merged_*: 2n rows of scratch; *_out:
// 2n rows of result (groups compacted to the front, EMPTY after).
extern "C" int repro_merge_absorb_bitonic(
    const int64_t* ka, const int32_t* ca, const float* sa, const float* mna, const float* mxa,
    long long na, const int64_t* kb, const int32_t* cb, const float* sb, const float* mnb,
    const float* mxb, long long nb, long long n, int vs, int vm, int vx, long long empty,
    int64_t* kbuf, int32_t* pbuf, int64_t* merged_keys, int32_t* merged_cnt,
    float* merged_sum, float* merged_min, float* merged_max, int64_t* keys_out,
    int32_t* cnt_out, float* sum_out, float* min_out, float* max_out, void* scratch,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 2 || (n & (n - 1)) || n < na || n < nb || 2 * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  repro::Cols cols;
  int err = repro::make_cols(cols, merged_cnt, cnt_out, merged_sum, sum_out, vs, merged_min,
                             min_out, vm, merged_max, max_out, vx);
  if (err) return err;
  Sides s{ka, na, kb, nb, n, (int64_t)empty};
  const long long n2 = 2 * n;
  const int tile = n2 < BT_TILE ? (int)n2 : BT_TILE;
  int lj = 0;
  while ((1LL << (lj + 1)) < n2) ++lj;  // the first stage's stride n = 2^lj
  bool from_sides = true;
  for (; (1LL << lj) >= tile; --lj) {  // strides that leave a tile
    bitonic_global_stage<<<(unsigned)((n + BT_STAGE_THREADS - 1) / BT_STAGE_THREADS),
                           BT_STAGE_THREADS, 0, st>>>(s, kbuf, pbuf, lj, from_sides);
    from_sides = false;
  }
  bitonic_tile<<<(unsigned)(n2 / tile), BT_THREADS, 0, st>>>(
      s, kbuf, pbuf, tile, from_sides, Rows{ca, sa, mna, mxa}, Rows{cb, sb, mnb, mxb}, vs,
      vm, vx, merged_keys, merged_cnt, merged_sum, merged_min, merged_max);
  err = (int)cudaGetLastError();
  if (err) return err;
  return repro::merge_absorb_launch<false>(merged_keys, n2, nullptr, 0, (int64_t)empty, cols,
                                           cols, keys_out, cnt_out, sum_out, vs, min_out, vm,
                                           max_out, vx, scratch, st);
}
