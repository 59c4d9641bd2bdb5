// The columns of an aggregate state and their operators, shared by the
// fused merge-absorb pass (merge_absorb.cuh) and its scans and look-back
// (lookback.cuh).
//
// Rows: int64 keys (EMPTY marks invalid rows), an int32 count and float32
// (n, V) sum/min/max planes of independent widths (0 or V).  Every column
// (count, then each plane column) is a scalar scan with its own operator
// sharing the segmentation, so any plane widths work.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int SC_MAX_COLS = 25;  // count + three planes of width <= 8

enum ColOp : int { OP_ADD_I32 = 0, OP_ADD_F32 = 1, OP_MIN_F32 = 2, OP_MAX_F32 = 3 };

// One scalar column per entry: element (row, offset) of a row-major
// (n, stride) array of 32-bit values, input and output alike.
struct Cols {
  int ncols;
  const uint32_t* in[SC_MAX_COLS];
  uint32_t* out[SC_MAX_COLS];
  int stride[SC_MAX_COLS];
  int offset[SC_MAX_COLS];
  int op[SC_MAX_COLS];
};

__device__ __forceinline__ uint32_t identity_bits(int op) {
  switch (op) {
    case OP_ADD_I32: return 0u;
    case OP_ADD_F32: return 0u;           // +0.0f
    case OP_MIN_F32: return 0x7f800000u;  // +inf
    default: return 0xff800000u;          // -inf
  }
}

// op(a, b), with a the earlier rows
__device__ __forceinline__ uint32_t combine_bits(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case OP_ADD_I32: return (uint32_t)((int)a + (int)b);
    case OP_ADD_F32: return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
    case OP_MIN_F32: return __float_as_uint(fminf(__uint_as_float(a), __uint_as_float(b)));
    default: return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
}

// Columns of a state: the count, then every column of each non-empty plane.
inline int make_cols(Cols& c, const int32_t* cnt, int32_t* cnt_out, const float* s,
                     float* s_out, int vs, const float* mn, float* mn_out, int vm,
                     const float* mx, float* mx_out, int vx) {
  if (1 + vs + vm + vx > SC_MAX_COLS) return (int)cudaErrorInvalidValue;
  c.ncols = 0;
  auto add = [&](const void* in, void* out, int stride, int offset, int op) {
    c.in[c.ncols] = (const uint32_t*)in;
    c.out[c.ncols] = (uint32_t*)out;
    c.stride[c.ncols] = stride;
    c.offset[c.ncols] = offset;
    c.op[c.ncols] = op;
    ++c.ncols;
  };
  add(cnt, cnt_out, 1, 0, OP_ADD_I32);
  for (int v = 0; v < vs; ++v) add(s, s_out, vs, v, OP_ADD_F32);
  for (int v = 0; v < vm; ++v) add(mn, mn_out, vm, v, OP_MIN_F32);
  for (int v = 0; v < vx; ++v) add(mx, mx_out, vx, v, OP_MAX_F32);
  return 0;
}

}  // namespace repro
