// Single-pass decoupled look-back across the tiles of one launch, for
// the fused merge-absorb (merge_path.cu).
//
// Each tile publishes, for each scanned column, one 64-bit status word:
// bits 62-63 its state (0 nothing yet, 1 LOCAL: the tile's own aggregate,
// 2 INCLUSIVE: the aggregate through this tile from the start), bits 0-31
// the 32-bit value.  The word is written and read whole, so no fence
// orders a payload behind a flag.  A tile looks back over its
// predecessors a warp at a time: 32 words at once, each lane waits until
// its tile has published, and the window's values are combined up to the
// nearest INCLUSIVE word.  Tiles take their index from an atomic counter
// in launch order, so every predecessor is already running and publishes
// its LOCAL word without waiting on anyone: the look-back cannot wait on
// a block that has not been scheduled.
//
// For a segmented column (a group's count, sum, min or max) the value is
// that of the tile's trailing open segment.  A tile that holds a segment
// start publishes it as INCLUSIVE at once (what lies before the start
// cannot change it); only a tile with no start publishes LOCAL and looks
// back, so the look-back combines exactly the tiles the open segment
// spans.  For the tail count (the compacted slot of each group) every
// tile but the first looks back.
#pragma once
#include <stdint.h>

#include "seg_combine.cuh"

namespace repro {

constexpr unsigned long long LB_LOCAL = 1ull << 62;
constexpr unsigned long long LB_INCLUSIVE = 2ull << 62;

__device__ __forceinline__ void lb_publish(unsigned long long* word, unsigned long long state,
                                           uint32_t v) {
  atomicExch(word, state | v);
}

__device__ __forceinline__ unsigned long long lb_read(const unsigned long long* word) {
  return *(const volatile unsigned long long*)word;
}

// The combined value of the tiles before `tile` back to the nearest
// INCLUSIVE word: call with all 32 lanes of one warp; every lane returns
// it.  `words` holds one status word per tile of this column.
__device__ __forceinline__ uint32_t lb_warp_lookback(const unsigned long long* words, int tile,
                                                     int op) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = identity_bits(op);
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;  // tile 0 is INCLUSIVE, so no window reaches past it
    unsigned long long w = q >= 0 ? lb_read(words + q) : LB_INCLUSIVE | identity_bits(op);
    while (__any_sync(0xffffffffu, (w >> 62) == 0)) {
      if ((w >> 62) == 0) w = lb_read(words + q);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int nearest = incl ? __ffs(incl) - 1 : 31;
    uint32_t v = lane <= nearest ? (uint32_t)w : identity_bits(op);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = combine_bits(op, __shfl_xor_sync(0xffffffffu, v, o), v);
    carry = combine_bits(op, v, carry);  // v covers the tiles before carry's
    if (incl) return carry;
  }
}

// Exclusive segmented scan over the block, one (flag, value) per thread
// (the operator of block_seg_scan): (ef, ev) is what the threads before
// this one hold, (tf, tv) the whole block's.  Every thread must call it.
template <int NT>
__device__ __forceinline__ void block_seg_scan_exclusive(int op, bool f, uint32_t v, bool& ef,
                                                         uint32_t& ev, bool& tf, uint32_t& tv) {
  __shared__ uint32_t s_v[NT];
  __shared__ int s_f[NT];
  block_seg_scan<NT>(op, f, v);
  s_v[threadIdx.x] = v;
  s_f[threadIdx.x] = f;
  __syncthreads();
  ef = threadIdx.x > 0 && s_f[threadIdx.x - 1] != 0;
  ev = threadIdx.x > 0 ? s_v[threadIdx.x - 1] : identity_bits(op);
  tf = s_f[NT - 1] != 0;
  tv = s_v[NT - 1];
  __syncthreads();  // the shared values may be reused by the next call
}

}  // namespace repro
