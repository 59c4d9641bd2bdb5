// Merge-absorb of two key-sorted aggregate states of unequal lengths, in
// one fused pass.
//
// Replaces: merge_path_tiles (src/repro/kernels/merge_path.py:112), the
// Pallas merge-path merge with the segmented scan fused, together with the
// compaction its caller runs (ops.merge_absorb_sorted and ops._compact,
// src/repro/kernels/ops.py:174,127).
//
// Function: merge A and B (A wins ties, duplicates allowed on either
// side), combine adjacent equal keys (EMPTY never joins a group), compact
// the groups to the front at capacity |A| + |B|, EMPTY and the neutral
// values after them.  With duplicate-free inputs (assume_unique) the same
// combine is exact, so one path serves both.
//
// What bounds it on the H100: memory.  The merge and the combine do O(1)
// work a row and must read both states and write the merged, compacted
// one: (8 + 4 + 4V) bytes a row each way.  At the main path's shapes,
// (M + 2B) + B = 1,179,648 + 65,536 rows in run generation and (M + P) + P
// = 1,064,960 + 16,384 rows per wide-merge page, that is about 17-20 MB in
// and as much out, some 10-12 us at 3.35 TB/s.
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
//   * The combine runs in the same pass: per column (the tail count first,
//     then the count and every plane column) a block segmented scan
//     (seg_combine.cuh) and a single-pass decoupled look-back across tiles
//     (lookback.cuh) give each group's aggregate at its tail row.  A
//     tile's groups take a contiguous range of compacted slots, so they
//     are staged in shared memory and written out coalesced; a column's
//     values are read once, as the tile's slices of A and B, coalesced,
//     and each output row picks its own from shared memory: scattered
//     4-byte loads and stores, one a row and column, are what a
//     row-at-a-time design pays on the card.
//   * All tiles of a wide-merge page run at once, so a tile's look-back
//     for its first slot waits for the slowest tile before it.  The first
//     two columns (the main path's count and sum) are loaded with the keys
//     and combined before that look-back, their aggregates waiting in
//     shared memory, so the wait overlaps their work.
//   * No merged scratch state and no single-block scan of carries: the
//     scratch is the tiles' status words and the counter, zeroed by one
//     memset a call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "merge_split.cuh"
#include "seg_combine.cuh"

namespace {

constexpr int MA_THREADS = 256;
constexpr int MA_ITEMS = 8;
constexpr int MA_TILE = MA_THREADS * MA_ITEMS;
constexpr int FILL_THREADS = 256;

// Column `col` of A's rows [i0, i0 + la) and B's rows [j0, j0 + lb) into
// buf[0, la) and buf[la, la + lb): coalesced loads of the tile's slices.
__device__ __forceinline__ void load_slices(const repro::Cols& ca, const repro::Cols& cb, int col,
                                            long long i0, int la, long long j0, int lb,
                                            uint32_t* buf) {
  const uint32_t* pa = ca.in[col];
  const uint32_t* pb = cb.in[col];
  const int stride = ca.stride[col], offset = ca.offset[col];
  for (int r = threadIdx.x; r < la; r += MA_THREADS) buf[r] = pa[(i0 + r) * stride + offset];
  for (int r = threadIdx.x; r < lb; r += MA_THREADS) buf[la + r] = pb[(j0 + r) * stride + offset];
}

// 4 blocks an SM (64 registers a thread): all 528 tiles of a wide-merge
// page resident at once
__global__ void __launch_bounds__(MA_THREADS, 4)
merge_absorb_tiles(const int64_t* __restrict__ ka, long long na, const int64_t* __restrict__ kb,
                   long long nb, int64_t empty, repro::Cols ca, repro::Cols cb,
                   int64_t* __restrict__ keys_out, unsigned long long* status, int ntiles,
                   int* counter) {
  // the tile's keys, A's slice then B's; then its groups' keys, compacted
  __shared__ int64_t s_keys[MA_TILE];
  // the first two columns (the count and a one-wide plane: the main path's
  // state) are loaded with the keys, column 0 to s_in and column 1 to
  // s_aux, and their aggregates wait, compacted, in s_out and s_in for the
  // tile's first slot; any further column passes through s_in and s_out
  __shared__ uint32_t s_in[MA_TILE], s_aux[MA_TILE], s_out[MA_TILE];
  __shared__ int64_t s_first[MA_THREADS], s_last[MA_THREADS];
  __shared__ long long s_split[2];
  __shared__ int64_t s_edge[2];  // keys of the merged rows before and after the tile
  __shared__ int s_has_edge[2];
  __shared__ int s_tile, s_lead_start;
  __shared__ uint32_t s_carry, s_tile_slot;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long n = na + nb;
  const long long d0 = (long long)tile * MA_TILE;
  const long long d1 = d0 + MA_TILE < n ? d0 + MA_TILE : n;
  const int cnt = (int)(d1 - d0);
  const int ncols = ca.ncols;

  // the splits of the tile's two diagonals, one warp each
  if (warp < 2) {
    const long long diag = warp == 0 ? d0 : d1;
    const long long i = repro::warp_merge_path_split(
        diag, na, nb, [&](long long x, long long y) { return ka[x] <= kb[y]; });
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
  __syncthreads();
  const long long i0 = s_split[0], j0 = d0 - i0;
  const int la = (int)(s_split[1] - i0), lb = cnt - la;
  for (int r = tid; r < la; r += MA_THREADS) s_keys[r] = ka[i0 + r];
  for (int r = tid; r < lb; r += MA_THREADS) s_keys[la + r] = kb[j0 + r];
  if (ncols > 0) load_slices(ca, cb, 0, i0, la, j0, lb, s_in);
  if (ncols > 1) load_slices(ca, cb, 1, i0, la, j0, lb, s_aux);
  __syncthreads();

  // this thread's outputs: tile rows [p0, p0 + MA_ITEMS), each from its
  // source at src[u] in the tile's slices (A's first)
  const int p0 = tid * MA_ITEMS;
  const int dp = p0 < cnt ? p0 : cnt;
  const int64_t* sa = s_keys;
  const int64_t* sb = s_keys + la;
  int ia = (int)repro::merge_path_split(dp, la, lb,
                                        [&](long long x, long long y) { return sa[x] <= sb[y]; });
  int ib = dp - ia;
  int64_t key[MA_ITEMS];
  int src[MA_ITEMS];
#pragma unroll
  for (int u = 0; u < MA_ITEMS; ++u) {
    src[u] = 0;
    key[u] = empty;
    if (p0 + u < cnt) {
      if (ia < la && (ib >= lb || sa[ia] <= sb[ib])) {
        key[u] = sa[ia];
        src[u] = ia++;
      } else {
        key[u] = sb[ib];
        src[u] = la + ib++;
      }
    }
  }
  // the values of a column: neutral for EMPTY rows and rows past the tile
  uint32_t val[MA_ITEMS];
  auto gather = [&](int col, const uint32_t* in) {
    const uint32_t id = repro::identity_bits(ca.op[col]);
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) val[u] = key[u] != empty ? in[src[u]] : id;
  };
  if (ncols > 0) gather(0, s_in);
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

  // the tail count: each group's slot within the tile; the tile's LOCAL
  // word goes out now, its look-back waits until the first columns are done
  bool ef, tf;
  uint32_t ev, tv;
  repro::block_seg_scan_exclusive<MA_THREADS>(repro::OP_ADD_I32, false, __popc(tail), ef, ev,
                                              tf, tv);
  const uint32_t my_slot = ev, groups = tv;
  if (tid == 0) {
    repro::lb_publish(status + tile, tile == 0 ? repro::LB_INCLUSIVE : repro::LB_LOCAL, groups);
  }
  uint32_t slot = my_slot;
#pragma unroll
  for (int u = 0; u < MA_ITEMS; ++u) {
    if (tail >> u & 1u) s_keys[slot++] = key[u];  // the groups' keys, staged
  }

  // column c (its values gathered from `in`, or already in val when in is
  // null): the aggregate of each group at its tail, staged at the group's
  // slot within the tile
  const bool lead_start = s_lead_start != 0;
  auto column = [&](int c, const uint32_t* in, uint32_t* stage) {
    const int op = ca.op[c];
    if (in) gather(c, in);
    bool f = false;
    uint32_t v = repro::identity_bits(op);
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      if (start >> u & 1u) {
        f = true;
        v = val[u];
      } else {
        v = repro::combine_bits(op, v, val[u]);
      }
    }
    // (its barriers also end every thread's reads of `in`)
    repro::block_seg_scan_exclusive<MA_THREADS>(op, f, v, ef, ev, tf, tv);
    unsigned long long* words = status + (long long)(c + 1) * ntiles;
    // a tile holding a segment start knows its trailing segment in full
    if (tid == 0) {
      repro::lb_publish(words + tile, tile == 0 || tf ? repro::LB_INCLUSIVE : repro::LB_LOCAL,
                        tv);
    }
    uint32_t carry = repro::identity_bits(op);
    const bool need_carry = tile > 0 && !lead_start;  // the tile opens inside a segment
    if (need_carry) {
      if (warp == 0) {
        const uint32_t before = repro::lb_warp_lookback(words, tile, op);
        if (lane == 0) {
          s_carry = before;
          if (!tf) {
            repro::lb_publish(words + tile, repro::LB_INCLUSIVE,
                              repro::combine_bits(op, before, tv));
          }
        }
      }
      __syncthreads();
      carry = s_carry;
    }
    uint32_t run = (ef || !need_carry) ? ev : repro::combine_bits(op, carry, ev);
    uint32_t at = my_slot;
#pragma unroll
    for (int u = 0; u < MA_ITEMS; ++u) {
      run = (start >> u & 1u) ? val[u] : repro::combine_bits(op, run, val[u]);
      if (tail >> u & 1u) stage[at++] = run;
    }
  };
  auto write_out = [&](int c, const uint32_t* stage, uint32_t first) {
    uint32_t* out = ca.out[c];
    const int stride = ca.stride[c], offset = ca.offset[c];
    for (uint32_t i = tid; i < groups; i += MA_THREADS)
      out[(long long)(first + i) * stride + offset] = stage[i];
  };
  if (ncols > 0) column(0, nullptr, s_out);
  if (ncols > 1) column(1, s_aux, s_in);

  // the tail count's look-back gives the tile's first slot; then every
  // staged row goes out coalesced
  if (tile > 0 && warp == 0) {
    const uint32_t before = repro::lb_warp_lookback(status, tile, repro::OP_ADD_I32);
    if (lane == 0) {
      s_tile_slot = before;
      repro::lb_publish(status + tile, repro::LB_INCLUSIVE, before + groups);
    }
  }
  __syncthreads();
  const uint32_t tile_slot = tile > 0 ? s_tile_slot : 0;
  for (uint32_t i = tid; i < groups; i += MA_THREADS) keys_out[tile_slot + i] = s_keys[i];
  if (ncols > 0) write_out(0, s_out, tile_slot);
  if (ncols > 1) write_out(1, s_in, tile_slot);
  for (int c = 2; c < ncols; ++c) {  // wider planes: one column at a time
    __syncthreads();
    load_slices(ca, cb, c, i0, la, j0, lb, s_in);
    __syncthreads();
    column(c, s_in, s_out);
    __syncthreads();
    write_out(c, s_out, tile_slot);
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
// the last tile's inclusive tail count.
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

int ntiles_of(long long n) { return (int)((n + MA_TILE - 1) / MA_TILE); }

}  // namespace

// The scratch of a call over n rows and ncols columns: the counter (padded
// to 8 bytes), then one status word per tile for the tail count and for
// each column.
extern "C" long long repro_merge_absorb_scratch_bytes(long long n, int ncols) {
  return 8 + 8LL * ntiles_of(n) * (1 + ncols);
}

// *_out receives the result (na + nb rows); scratch is
// repro_merge_absorb_scratch_bytes(na + nb, ncols) bytes.
extern "C" int repro_merge_absorb(
    const int64_t* ka, const int32_t* ca, const float* sa, const float* mna, const float* mxa,
    long long na, const int64_t* kb, const int32_t* cb, const float* sb, const float* mnb,
    const float* mxb, long long nb, int vs, int vm, int vx, long long empty,
    int64_t* keys_out, int32_t* cnt_out, float* sum_out, float* min_out, float* max_out,
    void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = na + nb;
  if (n == 0) return (int)cudaGetLastError();
  if (n >= (1LL << 32)) return (int)cudaErrorInvalidValue;  // slots are 32-bit
  repro::Cols cols_a, cols_b;
  int err = repro::make_cols(cols_a, ca, cnt_out, sa, sum_out, vs, mna, min_out, vm, mxa,
                             max_out, vx);
  if (err) return err;
  err = repro::make_cols(cols_b, cb, cnt_out, sb, sum_out, vs, mnb, min_out, vm, mxb, max_out,
                         vx);
  if (err) return err;
  const int ntiles = ntiles_of(n);
  const long long bytes = repro_merge_absorb_scratch_bytes(n, cols_a.ncols);
  err = (int)cudaMemsetAsync(scratch, 0, (size_t)bytes, s);
  if (err) return err;
  int* counter = (int*)scratch;
  unsigned long long* status = (unsigned long long*)((char*)scratch + 8);
  merge_absorb_tiles<<<ntiles, MA_THREADS, 0, s>>>(ka, na, kb, nb, (int64_t)empty, cols_a,
                                                   cols_b, keys_out, status, ntiles, counter);
  err = (int)cudaGetLastError();
  if (err) return err;
  long long fill_blocks = (n + FILL_THREADS - 1) / FILL_THREADS;
  if (fill_blocks > 528) fill_blocks = 528;  // 4 an SM
  merge_absorb_fill<<<(unsigned)fill_blocks, FILL_THREADS, 0, s>>>(
      n, (int64_t)empty, status + ntiles - 1, keys_out, cnt_out, sum_out, vs, min_out, vm,
      max_out, vx);
  return (int)cudaGetLastError();
}
