// Segmented combine of a key-sorted aggregate state, compacted to the
// front — shared by segmented_combine.cu and merge_path.cu.
//
// Rows: int64 keys (EMPTY marks invalid rows), an int32 count and float32
// (n, V) sum/min/max planes of independent widths (0 or V).  Equal keys
// are adjacent; each group's aggregate is written to its compacted slot
// (the rank of its tail row among all tails), rows past the last group
// become EMPTY with neutral values.  EMPTY rows never join a group.
//
// Design: a group may span many blocks (under key skew one group spans the
// whole input), so no thread ever walks from a tail back to its head.
// Instead, three passes of a flag-based segmented scan, one row per
// thread:
//   pass 1  each block scans its rows and stores its carry: the tail count
//           and, per column, the aggregate of its trailing open segment;
//   pass 2  one block scans the block carries (inclusive, segmented);
//   pass 3  each block rescans its rows, prepends the carry of the blocks
//           before it to rows whose segment began there, and writes every
//           tail's aggregate to its slot;
//   fill    rows past the last group get EMPTY and the neutral values.
// Every column (count, then each plane column) is a scalar scan with its
// own operator sharing the segmentation, so any plane widths work.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int SC_THREADS = 512;        // rows per block in passes 1 and 3
constexpr int SC_SCAN_THREADS = 1024;  // the single block of pass 2
constexpr int SC_MAX_COLS = 25;        // count + three planes of width <= 8

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

// Inclusive segmented scan over the block, one (flag, value) per thread:
// (fl, vl) . (fr, vr) = (fl | fr, fr ? vr : op(vl, vr)).  Every thread of
// the block must call it.
template <int NT>
__device__ void block_seg_scan(int op, bool& f, uint32_t& v) {
  constexpr int NW = NT / 32;
  __shared__ uint32_t s_v[NW];
  __shared__ int s_f[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t vu = __shfl_up_sync(0xffffffffu, v, d);
    int fu = __shfl_up_sync(0xffffffffu, (int)f, d);
    if (lane >= d) {
      if (!f) v = combine_bits(op, vu, v);
      f = f || fu;
    }
  }
  if (lane == 31) {
    s_v[warp] = v;
    s_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t wv = lane < NW ? s_v[lane] : identity_bits(op);
    bool wf = lane < NW ? s_f[lane] != 0 : false;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t vu = __shfl_up_sync(0xffffffffu, wv, d);
      int fu = __shfl_up_sync(0xffffffffu, (int)wf, d);
      if (lane >= d) {
        if (!wf) wv = combine_bits(op, vu, wv);
        wf = wf || fu;
      }
    }
    if (lane < NW) {
      s_v[lane] = wv;
      s_f[lane] = wf;
    }
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v = combine_bits(op, s_v[warp - 1], v);
    f = f || s_f[warp - 1];
  }
  __syncthreads();  // the shared carries may be reused by the next call
}

// start: row i begins a segment (EMPTY rows always do); tail: row i is the
// last row of a valid group.
__device__ __forceinline__ void row_flags(const int64_t* keys, long long n, long long i,
                                          int64_t empty, bool& valid, bool& start,
                                          bool& tail) {
  if (i >= n) {
    valid = false;
    start = true;
    tail = false;
    return;
  }
  const int64_t k = keys[i];
  valid = k != empty;
  start = !valid || i == 0 || keys[i - 1] != k;
  tail = valid && (i == n - 1 || keys[i + 1] != k);
}

__device__ __forceinline__ uint32_t load_col(const Cols& c, int col, long long row) {
  return c.in[col][row * c.stride[col] + c.offset[col]];
}

__device__ __forceinline__ void store_col(const Cols& c, int col, long long row, uint32_t v) {
  c.out[col][row * c.stride[col] + c.offset[col]] = v;
}

template <int NT>
__global__ void sc_pass1(const int64_t* keys, long long n, int64_t empty, Cols cols,
                         int nblocks, int* blk_tails, int* blk_flag, uint32_t* blk_val) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  bool valid, start, tail;
  row_flags(keys, n, i, empty, valid, start, tail);
  bool f = false;
  uint32_t t = tail ? 1u : 0u;
  block_seg_scan<NT>(OP_ADD_I32, f, t);
  if (threadIdx.x == NT - 1) blk_tails[blockIdx.x] = (int)t;
  for (int c = 0; c < cols.ncols; ++c) {
    const int op = cols.op[c];
    bool fc = start;
    uint32_t v = valid ? load_col(cols, c, i) : identity_bits(op);
    block_seg_scan<NT>(op, fc, v);
    if (threadIdx.x == NT - 1) {
      blk_val[(long long)c * nblocks + blockIdx.x] = v;
      blk_flag[blockIdx.x] = fc;
    }
  }
}

// Replaces each block carry by the inclusive scan through that block:
// the tail counts unsegmented, the column carries segmented.
template <int NT>
__global__ void sc_pass2(Cols cols, int nblocks, int* blk_tails, const int* blk_flag,
                         uint32_t* blk_val) {
  __shared__ uint32_t s_carry_v;
  __shared__ int s_carry_f;
  for (int c = -1; c < cols.ncols; ++c) {
    const int op = c < 0 ? OP_ADD_I32 : cols.op[c];
    uint32_t* vals = c < 0 ? (uint32_t*)blk_tails : blk_val + (long long)c * nblocks;
    uint32_t carry_v = identity_bits(op);
    bool carry_f = false;
    for (int s = 0; s < nblocks; s += NT) {
      const int b = s + threadIdx.x;
      bool f = (c >= 0 && b < nblocks) ? blk_flag[b] != 0 : false;
      uint32_t v = b < nblocks ? vals[b] : identity_bits(op);
      block_seg_scan<NT>(op, f, v);
      if (!f) v = combine_bits(op, carry_v, v);
      f = f || carry_f;
      if (b < nblocks) vals[b] = v;
      if (threadIdx.x == NT - 1) {
        s_carry_v = v;
        s_carry_f = f;
      }
      __syncthreads();
      carry_v = s_carry_v;
      carry_f = s_carry_f != 0;
      __syncthreads();
    }
  }
}

template <int NT>
__global__ void sc_pass3(const int64_t* keys, long long n, int64_t empty, Cols cols,
                         int nblocks, const int* blk_tails, const uint32_t* blk_val,
                         int64_t* keys_out) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  bool valid, start, tail;
  row_flags(keys, n, i, empty, valid, start, tail);
  bool f = false;
  uint32_t t = tail ? 1u : 0u;
  block_seg_scan<NT>(OP_ADD_I32, f, t);
  const long long base = blockIdx.x > 0 ? blk_tails[blockIdx.x - 1] : 0;
  const long long slot = base + (long long)t - 1;  // meaningful on tails only
  if (tail) keys_out[slot] = keys[i];
  for (int c = 0; c < cols.ncols; ++c) {
    const int op = cols.op[c];
    bool fc = start;
    uint32_t v = valid ? load_col(cols, c, i) : identity_bits(op);
    block_seg_scan<NT>(op, fc, v);
    // no start in this block up to row i: the segment began in an earlier
    // block (never the case in block 0, whose first row always starts)
    if (!fc && blockIdx.x > 0) {
      v = combine_bits(op, blk_val[(long long)c * nblocks + blockIdx.x - 1], v);
    }
    if (tail) store_col(cols, c, slot, v);
  }
}

__global__ void sc_fill(long long n, int64_t empty, Cols cols, const int* blk_tails,
                        int nblocks, int64_t* keys_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || i < blk_tails[nblocks - 1]) return;
  keys_out[i] = empty;
  for (int c = 0; c < cols.ncols; ++c) store_col(cols, c, i, identity_bits(cols.op[c]));
}

inline int sc_nblocks(long long n) { return (int)((n + SC_THREADS - 1) / SC_THREADS); }

inline long long sc_scratch_bytes(long long n, int ncols) {
  return 4LL * sc_nblocks(n) * (2 + ncols);
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

// The four launches on `stream`; keys_out and the out columns must not
// alias the inputs.  Returns cudaGetLastError().
inline int seg_combine_launch(const int64_t* keys, long long n, int64_t empty,
                              const Cols& cols, int64_t* keys_out, void* scratch,
                              cudaStream_t stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int nb = sc_nblocks(n);
  int* blk_tails = (int*)scratch;
  int* blk_flag = blk_tails + nb;
  uint32_t* blk_val = (uint32_t*)(blk_flag + nb);
  sc_pass1<SC_THREADS><<<nb, SC_THREADS, 0, stream>>>(keys, n, empty, cols, nb, blk_tails,
                                                      blk_flag, blk_val);
  sc_pass2<SC_SCAN_THREADS><<<1, SC_SCAN_THREADS, 0, stream>>>(cols, nb, blk_tails,
                                                               blk_flag, blk_val);
  sc_pass3<SC_THREADS><<<nb, SC_THREADS, 0, stream>>>(keys, n, empty, cols, nb, blk_tails,
                                                      blk_val, keys_out);
  sc_fill<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(n, empty, cols, blk_tails, nb,
                                                           keys_out);
  return (int)cudaGetLastError();
}

}  // namespace repro
