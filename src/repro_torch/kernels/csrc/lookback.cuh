// Single-pass decoupled look-back across the tiles of one launch, and the
// block scan before it, for the fused merge-absorb pass (merge_absorb.cuh).
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

// Exclusive scan over the block of NV columns that share one segment flag,
// one (flag, values) per thread: (fl, vl) . (fr, vr) = (fl | fr, fr ? vr :
// op(vl, vr)) for a segmented column, op(vl, vr) for the columns whose bit
// is set in `unsegmented`.  (ef, ev) is what the threads before this one
// hold, (tf, tv) the whole block's.  A warp scans by shuffles; after one
// barrier every warp scans the warps' totals by shuffles too (no second
// barrier).  Every thread must call it; a barrier must separate two calls.
template <int NT, int NV>
__device__ __forceinline__ void block_scan_exclusive(const int (&op)[NV], unsigned unsegmented,
                                                     bool f, uint32_t (&v)[NV], bool& ef,
                                                     uint32_t (&ev)[NV], bool& tf,
                                                     uint32_t (&tv)[NV]) {
  constexpr int NW = NT / 32;
  __shared__ uint32_t s_v[NV][NW];
  __shared__ int s_f[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the value of (fl, l) . (fr, r) in column k
  auto apply = [&](int k, bool fr, uint32_t l, uint32_t r) {
    return fr && !(unsegmented >> k & 1u) ? r : combine_bits(op[k], l, r);
  };
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {  // inclusive within the warp
    const bool fu = __shfl_up_sync(0xffffffffu, (int)f, d) != 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const uint32_t vu = __shfl_up_sync(0xffffffffu, v[k], d);
      if (lane >= d) v[k] = apply(k, f, vu, v[k]);
    }
    if (lane >= d) f = f || fu;
  }
  const bool xf = (__shfl_up_sync(0xffffffffu, (int)f, 1) != 0) && lane > 0;
  uint32_t xv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v[k], 1);
    xv[k] = lane > 0 ? up : identity_bits(op[k]);
  }
  if (lane == 31) {
    s_f[warp] = f;
#pragma unroll
    for (int k = 0; k < NV; ++k) s_v[k][warp] = v[k];
  }
  __syncthreads();
  bool wf = lane < NW ? s_f[lane] != 0 : false;
  uint32_t wv[NV], pv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) wv[k] = lane < NW ? s_v[k][lane] : identity_bits(op[k]);
#pragma unroll
  for (int d = 1; d < NW; d <<= 1) {
    const bool fu = __shfl_up_sync(0xffffffffu, (int)wf, d) != 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const uint32_t vu = __shfl_up_sync(0xffffffffu, wv[k], d);
      if (lane >= d) wv[k] = apply(k, wf, vu, wv[k]);
    }
    if (lane >= d) wf = wf || fu;
  }
  const int before = warp > 0 ? warp - 1 : 0;
  const bool pf = (__shfl_sync(0xffffffffu, (int)wf, before) != 0) && warp > 0;
  tf = __shfl_sync(0xffffffffu, (int)wf, NW - 1) != 0;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const uint32_t x = __shfl_sync(0xffffffffu, wv[k], before);
    pv[k] = warp > 0 ? x : identity_bits(op[k]);
    tv[k] = __shfl_sync(0xffffffffu, wv[k], NW - 1);
  }
  ef = pf || xf;
#pragma unroll
  for (int k = 0; k < NV; ++k) ev[k] = apply(k, xf, pv[k], xv[k]);
}

}  // namespace repro
