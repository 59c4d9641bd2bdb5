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
// own costs come on top: a bitonic merge of m positions takes log2(m)
// compare-exchange stages where the merge path reads each row once, and
// its stages with strides of a tile or more pass every position through
// device memory (at the wide merge's 1,064,960 + 16,384 rows, m = 2^21:
// two passes of 16.8 MB read and written, the first reading the sides).
//
// The network sorts 64-bit words (key << 32) | src, one a position, on m =
// next_pow2(|A| + |B|) positions (at least 2): position p < |A| holds A's
// row p with src p; position p >= |A| holds row q = m - 1 - p of B
// virtually padded with EMPTY rows to m - |A| rows, with src m + q (B's
// rows are q < |B|; the padding is virtual, never stored).  A's words rise
// with p (its keys are sorted, its srcs rise) and B's fall, so the
// sequence is bitonic, and no two words are equal (their srcs differ).  A
// bitonic merge of distinct words has one result, the sorted order, with
// no tie rule: by key, then A's rows before B's (every A src is below
// every B src), each side in its own order, which is the plain version's
// stable argsort of A ++ B.  The padding words are the largest (key EMPTY,
// src >= m + |B|), so the first |A| + |B| sorted words are the real rows.
//
// Design: one launch a global pass, then one fused kernel a tile, then the
// fill; one memset of the look-back's scratch.  merge_aggregate.plan (the
// Python wrapper's) groups the strides m/2 .. BT_TILE into passes of up to
// MAX_R stages; the entry point refuses a plan it cannot run.
//   * A global pass of R stages: each thread holds 2^R words strided by the
//     pass's smallest stride, so a warp's loads and stores are coalesced,
//     and runs the R stages in registers.  The first pass builds its words
//     from the two sides (the padding costs no load); each pass rewrites
//     the m-word buffer in place.
//   * A tile of BT_TILE = 8,192 words, 1,024 threads: its 13 stages in
//     dynamic shared memory, padded one slot in 8 (a thread's 8 consecutive
//     words and a warp's 32 are then free of bank conflicts): the first
//     stage as the words load, then four passes of 3 stages in registers,
//     the last of which leaves each thread its 8 consecutive merged rows.
//     A network of fewer than BT_TILE words runs in the one tile with the
//     largest word above position m, so the extra stages exchange nothing.
//   * The combine runs in the same kernel: merge_absorb.cuh's tiles
//     (their MA_SRC_NETWORK source: block scan, decoupled look-back, groups
//     staged in shared memory and written compacted), the tile's slices
//     of A's and B's columns loaded coalesced and each row picking its
//     values by its src.  Only tiles holding real rows run: ceil((|A| +
//     |B|) / BT_TILE) of them.  No merged state is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_absorb.cuh"

namespace {

constexpr int BT_THREADS = 1024;
constexpr int BT_TILE = BT_THREADS * repro::MA_ITEMS;  // 8,192 words
constexpr int BT_LOG_TILE = 13;
constexpr int BT_SLOTS = BT_TILE + BT_TILE / 8;         // padded one slot in 8
constexpr int BT_SMEM = BT_SLOTS * 8 + 3 * BT_TILE * 4;  // words + three 32-bit columns
constexpr int PASS_THREADS = 256;
constexpr int MAX_R = 5;  // stages a global pass keeps in registers (2^R words a thread)
static_assert(BT_TILE == 1 << BT_LOG_TILE, "the tile's stages");
static_assert(repro::MA_ITEMS == 8, "a tile pass keeps 8 words a thread: 3 stages");

struct Sides {
  const int64_t* ka;
  long long na;
  const int64_t* kb;
  long long nb;
  long long m;  // network positions, a power of two
  int64_t empty;
};

// The word of network position p < m.
__device__ __forceinline__ uint64_t side_word(const Sides& s, long long p) {
  if (p < s.na) return (uint64_t)s.ka[p] << 32 | (uint64_t)p;
  const long long q = s.m - 1 - p;
  const uint64_t key = q < s.nb ? (uint64_t)s.kb[q] : (uint64_t)s.empty;
  return key << 32 | (uint64_t)(s.m + q);
}

__device__ __forceinline__ void compare_exchange(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// R stages on 2^R words strided by the stage's smallest stride: strides
// 2^(R-1) .. 1 in word index, each keeping the smaller word below.
template <int R>
__device__ __forceinline__ void stages(uint64_t (&w)[1 << R]) {
#pragma unroll
  for (int h = R - 1; h >= 0; --h) {
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (!(k >> h & 1)) compare_exchange(w[k], w[k | 1 << h]);
    }
  }
}

// Stages of strides 2^(lo + R - 1) .. 2^lo over all m positions; thread t
// holds the positions whose bits [lo, lo + R) vary and whose other bits
// are t's.
template <int R>
__global__ void __launch_bounds__(PASS_THREADS)
bitonic_pass(Sides s, uint64_t* __restrict__ words, int lo, int from_sides) {
  const long long t = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (t >= s.m >> R) return;
  const long long low = (1LL << lo) - 1;
  const long long base = (t & ~low) << R | (t & low);
  uint64_t w[1 << R];
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) {
    const long long p = base + ((long long)k << lo);
    w[k] = from_sides ? side_word(s, p) : words[p];
  }
  stages<R>(w);
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) words[base + ((long long)k << lo)] = w[k];
}

__device__ __forceinline__ int slot(int p) { return p + (p >> 3); }

// The network of one tile in shared memory, the source of
// merge_absorb_tiles' rows (MA_SRC_NETWORK).
struct TileNetwork {
  Sides s;
  const uint64_t* words;  // the global passes' output; null: build the words from the sides
  uint64_t* keys;         // BT_SLOTS words of shared memory
  uint32_t* cols;         // then three columns of BT_TILE values

  __device__ __forceinline__ void bind(unsigned char* smem) {
    keys = reinterpret_cast<uint64_t*>(smem);
    cols = reinterpret_cast<uint32_t*>(keys + BT_SLOTS);
  }

  __device__ __forceinline__ uint64_t word(long long p) const {
    if (words) return words[p];
    return p < s.m ? side_word(s, p) : ~0ull;
  }

  // The tile's first stage (stride BT_TILE / 2) as its words load.
  __device__ __forceinline__ void load(int tile) {
    constexpr int H = BT_TILE / 2, PAIRS = H / BT_THREADS;
    const long long base = (long long)tile * BT_TILE;
    uint64_t lo[PAIRS], hi[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = threadIdx.x + i * BT_THREADS;
      lo[i] = word(base + p);
      hi[i] = word(base + p + H);
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = threadIdx.x + i * BT_THREADS;
      compare_exchange(lo[i], hi[i]);
      keys[slot(p)] = lo[i];
      keys[slot(p + H)] = hi[i];
    }
  }

  // Stages of strides 2^(LO + 2) .. 2^LO: thread t's 8 words, in place.
  template <int LO>
  __device__ __forceinline__ void pass(uint64_t (&w)[8], bool store) const {
    const int t = threadIdx.x;
    const int base = (t >> LO) << (LO + 3) | (t & ((1 << LO) - 1));
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = keys[slot(base + (k << LO))];
    stages<3>(w);
    if (store) {
#pragma unroll
      for (int k = 0; k < 8; ++k) keys[slot(base + (k << LO))] = w[k];
      __syncthreads();
    }
  }

  // The tile's other 12 stages; thread t ends with merged rows [p0, p0 +
  // 8) of the tile (p0 = 8t), each as its key and its position in the
  // tile's slices: A's rows [i0, i0 + la), then B's from j0.
  __device__ __forceinline__ void rows(int p0, int cnt, long long i0, int la, long long j0,
                                       int64_t empty, int64_t (&key)[8], int (&src)[8]) const {
    uint64_t w[8];
    pass<9>(w, true);
    pass<6>(w, true);
    pass<3>(w, true);
    pass<0>(w, false);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      key[u] = empty;
      src[u] = 0;
      if (p0 + u < cnt) {
        const long long r = (uint32_t)w[u];
        key[u] = (int64_t)(w[u] >> 32);
        src[u] = r < s.m ? (int)(r - i0) : la + (int)(r - s.m - j0);
      }
    }
  }
};

template <int R>
int launch_pass(const Sides& s, uint64_t* words, int lo, int from_sides, cudaStream_t st) {
  const long long threads = s.m >> R;
  bitonic_pass<R><<<(unsigned)((threads + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS, 0,
                    st>>>(s, words, lo, from_sides);
  return (int)cudaGetLastError();
}

long long bt_ntiles(long long n) { return (n + BT_TILE - 1) / BT_TILE; }

}  // namespace

// The look-back's scratch of a call over n = |A| + |B| rows and ncols
// columns: the counter (padded to 8 bytes), then one status word per tile
// for the tail count and for each column.
extern "C" long long repro_merge_absorb_bitonic_scratch_bytes(long long n, int ncols) {
  return 8 + 8LL * bt_ntiles(n) * (1 + ncols);
}

// The plan (merge_aggregate.plan): m = next_pow2(na + nb), at least 2;
// tile = min(m, BT_TILE); passes[0, npasses): the stages of each global
// pass, first to last, in 1..MAX_R, summing to log2(m / BT_TILE) above a
// tile.  words: m words of device memory where there is a global pass.
// *_out: na + nb rows of result (groups compacted to the front, EMPTY
// after); scratch: repro_merge_absorb_bitonic_scratch_bytes(na + nb,
// ncols) bytes.
extern "C" int repro_merge_absorb_bitonic(
    const int64_t* ka, const int32_t* ca, const float* sa, const float* mna, const float* mxa,
    long long na, const int64_t* kb, const int32_t* cb, const float* sb, const float* mnb,
    const float* mxb, long long nb, int vs, int vm, int vx, long long empty, long long m,
    int tile, const int* passes, int npasses, uint64_t* words, int64_t* keys_out,
    int32_t* cnt_out, float* sum_out, float* min_out, float* max_out, void* scratch,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = na + nb;
  if (na < 0 || nb < 0 || m < 2 || (m & (m - 1)) || m > (1LL << 31) || m < n ||
      (n > 1 && m >= 2 * n))
    return (int)cudaErrorInvalidValue;
  int log_m = 0;
  while ((1LL << log_m) < m) ++log_m;
  if (tile != (m < BT_TILE ? (int)m : BT_TILE) || npasses < 0 || (npasses > 0 && !words))
    return (int)cudaErrorInvalidValue;
  int planned = 0;
  for (int i = 0; i < npasses; ++i) {
    if (passes[i] < 1 || passes[i] > MAX_R) return (int)cudaErrorInvalidValue;
    planned += passes[i];
  }
  if (planned != (log_m > BT_LOG_TILE ? log_m - BT_LOG_TILE : 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  repro::Cols cols_a, cols_b;
  int err = repro::make_cols(cols_a, ca, cnt_out, sa, sum_out, vs, mna, min_out, vm, mxa,
                             max_out, vx);
  if (err) return err;
  err = repro::make_cols(cols_b, cb, cnt_out, sb, sum_out, vs, mnb, min_out, vm, mxb, max_out,
                         vx);
  if (err) return err;
  const int ntiles = (int)bt_ntiles(n);
  err = (int)cudaMemsetAsync(
      scratch, 0, (size_t)repro_merge_absorb_bitonic_scratch_bytes(n, cols_a.ncols), st);
  if (err) return err;
  int* counter = (int*)scratch;
  unsigned long long* status = (unsigned long long*)((char*)scratch + 8);
  Sides s{ka, na, kb, nb, m, (int64_t)empty};
  int top = log_m - 1;  // the next stage's stride is 2^top
  for (int i = 0; i < npasses; ++i) {
    const int lo = top - passes[i] + 1, first = i == 0;
    switch (passes[i]) {
      case 1: err = launch_pass<1>(s, words, lo, first, st); break;
      case 2: err = launch_pass<2>(s, words, lo, first, st); break;
      case 3: err = launch_pass<3>(s, words, lo, first, st); break;
      case 4: err = launch_pass<4>(s, words, lo, first, st); break;
      default: err = launch_pass<5>(s, words, lo, first, st); break;
    }
    if (err) return err;
    top = lo - 1;
  }
  // the tiles: the network's stages below BT_TILE, then the combine
  auto tiles = repro::merge_absorb_tiles<repro::MA_SRC_NETWORK, BT_THREADS, TileNetwork>;
  err = (int)cudaFuncSetAttribute(tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, BT_SMEM);
  if (err) return err;
  tiles<<<ntiles, BT_THREADS, BT_SMEM, st>>>(
      ka, na, kb, nb, (int64_t)empty, cols_a, cols_b, keys_out, status, ntiles, counter,
      TileNetwork{s, npasses ? words : nullptr, nullptr, nullptr});
  err = (int)cudaGetLastError();
  if (err) return err;
  return repro::merge_absorb_fill_launch<false>(n, (int64_t)empty, status + ntiles - 1, keys_out,
                                                cnt_out, sum_out, vs, min_out, vm, max_out, vx,
                                                st);
}
