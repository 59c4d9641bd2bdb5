// The fused merge-absorb pass: merge two key-sorted aggregate states (A
// wins ties, duplicates allowed on either side), combine adjacent equal
// keys (EMPTY never joins a group), and compact the groups to the front at
// capacity |A| + |B|, EMPTY and the neutral values after them.  With B
// empty it is the segmented combine of A.  One kernel template serves
// three sources of a tile's rows: a merge of its slices of A and B in
// shared memory (MA_SRC_MERGE: merge_path.cu, the merge-absorb), A's rows
// as they are (MA_SRC_A: segmented_combine.cu, the combine; no split
// search and no merge), and a sorting network its caller supplies
// (MA_SRC_NETWORK: merge_aggregate.cu, the bitonic foil, whose tiles are
// 1,024 threads x 8 rows in dynamic shared memory).
//
// Design: one kernel over tiles of 2,048 output rows (256 threads x 8),
// then a small kernel that fills the rows past the last group.
//   * A tile takes its index from an atomic counter (launch order, which
//     the look-back needs), finds the merge-path splits of its two
//     diagonals with one warp each (merge_split.cuh), loads its slices of
//     A's and B's keys into shared memory with coalesced loads, and each
//     thread merges its 8 outputs serially from a split it finds there.
//     The keys of the rows just before and after the tile give the group
//     flags at its edges.
//   * The combine runs in the same pass: one block scan (lookback.cuh) of
//     the tail count (each group's compacted slot) and the first two
//     columns (the main path's count and sum), then their single-pass
//     decoupled look-backs across tiles, one warp each and at once, give
//     each group's aggregate at its tail row; any further column takes a
//     scan and a look-back of its own.  A tile's groups take a contiguous
//     range of compacted slots, so they are staged in shared memory and
//     written out coalesced; a column's values are read once, as the
//     tile's slices of A and B, coalesced, and each output row picks its
//     own from shared memory: scattered 4-byte loads and stores, one a
//     row and column, are what a row-at-a-time design pays on the card.
//   * All tiles of a wide-merge page run at once, so a tile's look-backs
//     wait for the slowest tile before it; it publishes its own words
//     before it waits, so the waits of all tiles overlap.
//   * No merged scratch state and no single-block scan of carries: the
//     scratch is the tiles' status words and the counter, zeroed by one
//     memset a call.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "merge_split.cuh"
#include "seg_combine.cuh"

namespace repro {

constexpr int MA_THREADS = 256;
constexpr int MA_ITEMS = 8;
constexpr int MA_TILE = MA_THREADS * MA_ITEMS;
constexpr int FILL_THREADS = 256;

// Where a tile's rows come from (merge_absorb_tiles).
enum : int { MA_SRC_A = 0, MA_SRC_MERGE = 1, MA_SRC_NETWORK = 2 };

// The network of a source that has none.
struct NoNetwork {};

// A network source's tile arrays (its kernel's dynamic shared memory).
extern __shared__ __align__(16) unsigned char ma_network_smem[];

// Column `col` of A's rows [i0, i0 + la) and B's rows [j0, j0 + lb) into
// buf[0, la) and buf[la, la + lb): coalesced loads of the tile's slices.
template <int NT>
__device__ __forceinline__ void load_slices(const Cols& ca, const Cols& cb, int col,
                                            long long i0, int la, long long j0, int lb,
                                            uint32_t* buf) {
  const uint32_t* pa = ca.in[col];
  const uint32_t* pb = cb.in[col];
  const int stride = ca.stride[col], offset = ca.offset[col];
  for (int r = threadIdx.x; r < la; r += NT) buf[r] = pa[(i0 + r) * stride + offset];
  for (int r = threadIdx.x; r < lb; r += NT) buf[la + r] = pb[(j0 + r) * stride + offset];
}

// Tiles of NT x MA_ITEMS output rows, a block of NT threads each.  A merge
// or A alone: 4 blocks an SM (64 registers a thread), all 528 tiles of a
// wide-merge page resident at once; without B (MA_SRC_A) a tile's rows
// are A's rows [d0, d1): no split search and no merge.
//
// With MA_SRC_NETWORK the tile's rows are merged rows [d0, d1) of A and B
// as `net` orders them: net.bind(ma_network_smem) lays its tile arrays
// out in the dynamic shared memory (net.keys, net.cols, in place of the
// static arrays, which shrink to one entry), net.load(tile) starts the
// tile's sort (its shared-memory writes are published by the barrier
// after the split search), and net.rows(...) finishes it and gives each
// thread its MA_ITEMS consecutive rows as keys and positions in the tile's
// slices (barriers inside; every thread calls each).  The splits of the
// tile's diagonals still give its edge keys and its slices of A and B: a
// merge keeps each side's order, so the slices hold exactly the tile's
// rows of each side.
template <int SRC, int NT = MA_THREADS, class Network = NoNetwork>
__global__ void __launch_bounds__(NT, SRC == MA_SRC_NETWORK ? 1 : 4)
merge_absorb_tiles(const int64_t* __restrict__ ka, long long na, const int64_t* __restrict__ kb,
                   long long nb, int64_t empty, Cols ca, Cols cb,
                   int64_t* __restrict__ keys_out, unsigned long long* status, int ntiles,
                   int* counter, Network net) {
  constexpr int TILE = NT * MA_ITEMS;
  constexpr bool HAS_B = SRC != MA_SRC_A;  // the rows merge slices of A and B
  constexpr int STATIC = SRC == MA_SRC_NETWORK ? 1 : TILE;
  // the tile's keys, A's slice then B's; then its groups' keys, compacted
  __shared__ int64_t s_keys_static[STATIC];
  // the first two columns (the count and a one-wide plane: the main path's
  // state) are loaded with the keys, column 0 to s_in and column 1 to
  // s_aux, and their aggregates wait, compacted, in s_out and s_in for the
  // tile's first slot; any further column passes through s_in and s_out
  __shared__ uint32_t s_in_static[STATIC], s_aux_static[STATIC], s_out_static[STATIC];
  __shared__ int64_t s_first[NT], s_last[NT];
  __shared__ long long s_split[2];
  __shared__ int64_t s_edge[2];  // keys of the merged rows before and after the tile
  __shared__ int s_has_edge[2];
  __shared__ int s_tile, s_lead_start;
  __shared__ uint32_t s_carry[2], s_tile_slot;
  int64_t* s_keys = s_keys_static;
  uint32_t *s_in = s_in_static, *s_aux = s_aux_static, *s_out = s_out_static;
  if constexpr (SRC == MA_SRC_NETWORK) {
    net.bind(ma_network_smem);
    s_keys = reinterpret_cast<int64_t*>(net.keys);
    s_in = net.cols;
    s_aux = net.cols + TILE;
    s_out = net.cols + 2 * TILE;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  if constexpr (SRC == MA_SRC_NETWORK) net.load(tile);
  const long long n = na + nb;
  const long long d0 = (long long)tile * TILE;
  const long long d1 = d0 + TILE < n ? d0 + TILE : n;
  const int cnt = (int)(d1 - d0);
  const int ncols = ca.ncols;

  // the splits of the tile's two diagonals, one warp each
  if (warp < 2) {
    const long long diag = warp == 0 ? d0 : d1;
    long long i = diag;
    if constexpr (HAS_B) {
      i = warp_merge_path_split(diag, na, nb,
                                [&](long long x, long long y) { return ka[x] <= kb[y]; });
    }
    if (lane == 0) {
      const long long j = diag - i;
      s_split[warp] = i;
      if (warp == 0) {  // merged row d0 - 1 holds the larger of A[i-1] and B[j-1]
        int64_t k = i > 0 ? ka[i - 1] : INT64_MIN;
        if (j > 0 && kb[j - 1] > k) k = kb[j - 1];
        s_edge[0] = k;
        s_has_edge[0] = d0 > 0;
      } else {  // merged row d1 holds the smaller of A[i] and B[j]
        int64_t k = i < na ? ka[i] : INT64_MAX;
        if (j < nb && kb[j] < k) k = kb[j];
        s_edge[1] = k;
        s_has_edge[1] = d1 < n;
      }
    }
  }
  // without B the slices are known: the edges load with them
  if constexpr (HAS_B) __syncthreads();
  const long long i0 = HAS_B ? s_split[0] : d0, j0 = d0 - i0;
  const int la = HAS_B ? (int)(s_split[1] - i0) : cnt, lb = cnt - la;
  // the keys and first two columns of the tile's rows: with B, each
  // thread's loads all in flight before its first store; without B, whose
  // registers then spill, in order (each the faster on the card); the
  // network's keys are its words, already loading
  if constexpr (SRC == MA_SRC_NETWORK) {
    if (ncols > 0) load_slices<NT>(ca, cb, 0, i0, la, j0, lb, s_in);
    if (ncols > 1) load_slices<NT>(ca, cb, 1, i0, la, j0, lb, s_aux);
  } else if constexpr (HAS_B) {
    int64_t k[MA_ITEMS];
    uint32_t v0[MA_ITEMS], v1[MA_ITEMS];
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      const int r = tid + u * NT;
      const bool from_a = r < la;
      const long long row = from_a ? i0 + r : j0 + (r - la);
      if (r < cnt) {
        k[u] = from_a ? ka[row] : kb[row];
        if (ncols > 0) v0[u] = (from_a ? ca : cb).in[0][row * ca.stride[0] + ca.offset[0]];
        if (ncols > 1) v1[u] = (from_a ? ca : cb).in[1][row * ca.stride[1] + ca.offset[1]];
      }
    }
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      const int r = tid + u * NT;
      if (r < cnt) {
        s_keys[r] = k[u];
        if (ncols > 0) s_in[r] = v0[u];
        if (ncols > 1) s_aux[r] = v1[u];
      }
    }
  } else {
    for (int r = tid; r < cnt; r += NT) s_keys[r] = ka[i0 + r];
    if (ncols > 0) load_slices<NT>(ca, cb, 0, i0, la, j0, lb, s_in);
    if (ncols > 1) load_slices<NT>(ca, cb, 1, i0, la, j0, lb, s_aux);
  }
  __syncthreads();

  // this thread's outputs: tile rows [p0, p0 + MA_ITEMS), each from its
  // source at src[u] in the tile's slices (A's first)
  const int p0 = tid * MA_ITEMS;
  int64_t key[MA_ITEMS];
  int src[MA_ITEMS];
  if constexpr (SRC == MA_SRC_NETWORK) {
    net.rows(p0, cnt, i0, la, j0, empty, key, src);
  } else {
    const int dp = p0 < cnt ? p0 : cnt;
    const int64_t* sa = s_keys;
    const int64_t* sb = s_keys + la;
    int ia = dp;
    if constexpr (HAS_B) {
      ia = merge_path_split(dp, la, lb, [&](int x, int y) { return sa[x] <= sb[y]; });
    }
    int ib = dp - ia;
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      src[u] = 0;
      key[u] = empty;
      if (p0 + u < cnt) {
        if (!HAS_B || (ia < la && (ib >= lb || sa[ia] <= sb[ib]))) {
          key[u] = sa[ia];
          src[u] = ia++;
        } else {
          key[u] = sb[ib];
          src[u] = la + ib++;
        }
      }
    }
  }
  s_first[tid] = key[0];
  s_last[tid] = key[MA_ITEMS - 1];
  __syncthreads();

  // group flags: start = a segment begins (EMPTY rows always begin one);
  // tail = the last row of a valid group.  Rows past cnt start, never end.
  uint32_t start = 0, tail = 0;
#pragma unroll
  for (int u = 0; u < MA_ITEMS; ++u) {
    const int p = p0 + u;
    if (p >= cnt) {
      start |= 1u << u;
      continue;
    }
    const bool valid = key[u] != empty;
    bool has_prev = true, has_next = true;
    int64_t prev, next;
    if (u > 0) {
      prev = key[u - 1];
    } else if (tid > 0) {
      prev = s_last[tid - 1];
    } else {
      prev = s_edge[0];
      has_prev = s_has_edge[0] != 0;
    }
    if (p + 1 < cnt) {
      next = u + 1 < MA_ITEMS ? key[u + 1 < MA_ITEMS ? u + 1 : u] : s_first[tid + 1];
    } else {
      next = s_edge[1];
      has_next = s_has_edge[1] != 0;
    }
    if (!valid || !has_prev || prev != key[u]) start |= 1u << u;
    if (valid && (!has_next || next != key[u])) tail |= 1u << u;
  }
  if (tid == 0) s_lead_start = start & 1u;  // the tile's first row begins a segment

  // this thread's rows of column c (neutral for EMPTY rows and rows past
  // the tile), combined from its last segment start
  auto local = [&](int c, const uint32_t* in) {
    const int op = ca.op[c];
    const uint32_t id = identity_bits(op);
    uint32_t v = id;
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      const uint32_t x = key[u] != empty ? in[src[u]] : id;
      v = (start >> u & 1u) ? x : combine_bits(op, v, x);
    }
    return v;
  };
  // one scan for the tail count (each group's slot within the tile) and
  // the first two columns (the main path's count and sum); their
  // look-backs then run at once, one warp each
  const int nf = ncols < 2 ? ncols : 2;
  const int ops[3] = {OP_ADD_I32, nf > 0 ? ca.op[0] : OP_ADD_I32, nf > 1 ? ca.op[1] : OP_ADD_I32};
  uint32_t v[3] = {(uint32_t)__popc(tail), nf > 0 ? local(0, s_in) : 0u,
                   nf > 1 ? local(1, s_aux) : 0u};
  bool ef, tf;
  uint32_t ev[3], tv[3];
  block_scan_exclusive<NT, 3>(ops, 1u, start != 0, v, ef, ev, tf, tv);
  const uint32_t my_slot = ev[0], groups = tv[0];
  const bool need_carry = tile > 0 && !s_lead_start;  // the tile opens inside a segment
  auto words = [&](int c) { return status + (long long)(c + 1) * ntiles; };
  // a tile holding a segment start knows its trailing segment in full
  const unsigned long long col_state = tile == 0 || tf ? LB_INCLUSIVE : LB_LOCAL;
  if (tid == 0) {
    lb_publish(status + tile, tile == 0 ? LB_INCLUSIVE : LB_LOCAL, groups);
    for (int c = 0; c < nf; ++c) lb_publish(words(c) + tile, col_state, tv[c + 1]);
  }
  uint32_t slot = my_slot;
#pragma unroll
  for (int u = 0; u < MA_ITEMS; ++u) {
    if (tail >> u & 1u) s_keys[slot++] = key[u];  // the groups' keys, staged
  }
  // the carry of column c into the tile's leading segment (warp `warp`
  // looks it back, publishes the tile's INCLUSIVE word, and leaves the
  // carry in s_carry[cs])
  auto carry_in = [&](int c, bool tile_has_start, uint32_t total, int cs) {
    const uint32_t before = lb_warp_lookback(words(c), tile, ca.op[c]);
    if (lane == 0) {
      s_carry[cs] = before;
      if (!tile_has_start) {
        lb_publish(words(c) + tile, LB_INCLUSIVE, combine_bits(ca.op[c], before, total));
      }
    }
  };
  if (warp == 0 && tile > 0) {
    const uint32_t before = lb_warp_lookback(status, tile, OP_ADD_I32);
    if (lane == 0) {
      s_tile_slot = before;
      lb_publish(status + tile, LB_INCLUSIVE, before + groups);
    }
  }
  if (warp >= 1 && warp <= nf && need_carry) carry_in(warp - 1, tf, tv[warp], warp - 1);
  __syncthreads();
  const uint32_t tile_slot = tile > 0 ? s_tile_slot : 0;

  // column c's aggregate of each group at its tail, staged at the group's
  // slot within the tile, from what the rows before this thread's hold
  auto stage_column = [&](int c, const uint32_t* in, bool f_before, uint32_t v_before,
                          uint32_t carry, uint32_t* stage) {
    const int op = ca.op[c];
    const uint32_t id = identity_bits(op);
    uint32_t run = (f_before || !need_carry) ? v_before : combine_bits(op, carry, v_before);
    uint32_t at = my_slot;
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      const uint32_t x = key[u] != empty ? in[src[u]] : id;
      run = (start >> u & 1u) ? x : combine_bits(op, run, x);
      if (tail >> u & 1u) stage[at++] = run;
    }
  };
  auto write_out = [&](int c, const uint32_t* stage) {
    uint32_t* out = ca.out[c];
    const int stride = ca.stride[c], offset = ca.offset[c];
    for (uint32_t i = tid; i < groups; i += NT)
      out[(long long)(tile_slot + i) * stride + offset] = stage[i];
  };
  if (nf > 0) stage_column(0, s_in, ef, ev[1], s_carry[0], s_out);
  if (nf > 1) {
    __syncthreads();  // column 0's reads of s_in are done
    stage_column(1, s_aux, ef, ev[2], s_carry[1], s_in);
  }
  __syncthreads();
  for (uint32_t i = tid; i < groups; i += NT) keys_out[tile_slot + i] = s_keys[i];
  if (nf > 0) write_out(0, s_out);
  if (nf > 1) write_out(1, s_in);
  for (int c = 2; c < ncols; ++c) {  // wider planes: one column at a time
    __syncthreads();
    load_slices<NT>(ca, cb, c, i0, la, j0, lb, s_in);
    __syncthreads();
    const int op1[1] = {ca.op[c]};
    uint32_t v1[1] = {local(c, s_in)}, ev1[1], tv1[1];
    block_scan_exclusive<NT, 1>(op1, 0u, start != 0, v1, ef, ev1, tf, tv1);
    if (tid == 0) lb_publish(words(c) + tile, tile == 0 || tf ? LB_INCLUSIVE : LB_LOCAL, tv1[0]);
    if (warp == 0 && need_carry) carry_in(c, tf, tv1[0], 0);
    __syncthreads();
    stage_column(c, s_in, ef, ev1[0], s_carry[0], s_out);
    __syncthreads();
    write_out(c, s_out);
  }
}

// One array's rows [groups, n) of width w get `value`: the flat range
// [groups * w, n * w), written coalesced.
template <typename T>
__device__ __forceinline__ void fill_rows(T* a, long long groups, long long n, int w, T value) {
  for (long long i = groups * w + (long long)blockIdx.x * FILL_THREADS + threadIdx.x; i < n * w;
       i += (long long)gridDim.x * FILL_THREADS)
    a[i] = value;
}

// Rows [groups, n) get EMPTY and the neutral values; the group count is
// the last tile's inclusive tail count.  (HAS_B only names the kernel as
// its tiles' pass is named, so that a trace tells the merge-absorb's fill
// from the combine's.)
template <bool HAS_B>
__global__ void merge_absorb_fill(long long n, int64_t empty,
                                  const unsigned long long* last_tail_word, int64_t* keys_out,
                                  int32_t* cnt_out, float* sum_out, int vs, float* min_out,
                                  int vm, float* max_out, int vx) {
  const long long groups = (uint32_t)*last_tail_word;
  fill_rows(keys_out, groups, n, 1, empty);
  fill_rows(cnt_out, groups, n, 1, 0);
  fill_rows(sum_out, groups, n, vs, 0.f);
  fill_rows(min_out, groups, n, vm, __uint_as_float(0x7f800000u));   // +inf
  fill_rows(max_out, groups, n, vx, __uint_as_float(0xff800000u));   // -inf
}

// The fill of rows [groups, n) after the tiles of n rows, the last of
// which published its inclusive tail count in *last_tail_word.
template <bool HAS_B>
int merge_absorb_fill_launch(long long n, int64_t empty, const unsigned long long* last_tail_word,
                             int64_t* keys_out, int32_t* cnt_out, float* sum_out, int vs,
                             float* min_out, int vm, float* max_out, int vx, cudaStream_t s) {
  long long fill_blocks = (n + FILL_THREADS - 1) / FILL_THREADS;
  if (fill_blocks > 528) fill_blocks = 528;  // 4 an SM
  merge_absorb_fill<HAS_B><<<(unsigned)fill_blocks, FILL_THREADS, 0, s>>>(
      n, empty, last_tail_word, keys_out, cnt_out, sum_out, vs, min_out, vm, max_out, vx);
  return (int)cudaGetLastError();
}

inline int ntiles_of(long long n) { return (int)((n + MA_TILE - 1) / MA_TILE); }

// The scratch of a call over n rows and ncols columns: the counter (padded
// to 8 bytes), then one status word per tile for the tail count and for
// each column.
inline long long merge_absorb_scratch_bytes(long long n, int ncols) {
  return 8 + 8LL * ntiles_of(n) * (1 + ncols);
}

// On `stream`: one memset of the scratch (merge_absorb_scratch_bytes(na +
// nb, ca.ncols) bytes), the tiles and the fill.  The result, na + nb rows,
// goes to *_out, which ca's and cb's out columns must name; HAS_B false
// combines A alone (kb, nb = 0 and cb unused).
template <bool HAS_B>
int merge_absorb_launch(const int64_t* ka, long long na, const int64_t* kb, long long nb,
                        int64_t empty, const Cols& ca, const Cols& cb, int64_t* keys_out,
                        int32_t* cnt_out, float* sum_out, int vs, float* min_out, int vm,
                        float* max_out, int vx, void* scratch, cudaStream_t s) {
  const long long n = na + nb;
  if (n == 0) return (int)cudaGetLastError();
  if (n >= (1LL << 32)) return (int)cudaErrorInvalidValue;  // slots are 32-bit
  const int ntiles = ntiles_of(n);
  int err = (int)cudaMemsetAsync(scratch, 0, (size_t)merge_absorb_scratch_bytes(n, ca.ncols), s);
  if (err) return err;
  int* counter = (int*)scratch;
  unsigned long long* status = (unsigned long long*)((char*)scratch + 8);
  merge_absorb_tiles<HAS_B ? MA_SRC_MERGE : MA_SRC_A><<<ntiles, MA_THREADS, 0, s>>>(
      ka, na, kb, nb, empty, ca, cb, keys_out, status, ntiles, counter, NoNetwork{});
  err = (int)cudaGetLastError();
  if (err) return err;
  return merge_absorb_fill_launch<HAS_B>(n, empty, status + ntiles - 1, keys_out, cnt_out,
                                         sum_out, vs, min_out, vm, max_out, vx, s);
}

}  // namespace repro
