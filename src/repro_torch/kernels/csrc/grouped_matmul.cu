// Expert-blocked (grouped) matmul of the sorted MoE dispatch:
// out[e*C + i, :] = x[e*C + i, :] @ w[e] for x (E*C, D), w (E, D, F), both
// bfloat16 or both float32, float32 accumulation, the output in x's dtype.
//
// Replaces: grouped_matmul (src/repro/kernels/grouped_matmul.py:46), the
// Pallas kernel reached through ops.moe_grouped_matmul: MXU tiles over
// (row block, column block, k) with the expert picked from the row block.
//
// What bounds it on the H100: memory at the serve path's shapes.  Every
// expert's weights are read once per call: at qwen3-moe-30b-a3b's widths
// (E = 128, D = 2048, F = 768) that is 403 MB of bfloat16, 0.12 ms at
// 3.35 TB/s, while the products are 2*E*C*D*F = 3.2 GFLOP at decode (C = 8)
// and 25.8 GFLOP at a prefill of 4 x 256 tokens (C = 64), 0.003 and
// 0.026 ms at the tensor cores' 989 TFLOP/s.
//
// Design: a tile never straddles two experts.  The grid is (column tile,
// row tile within the expert's C rows, expert), so any C works: the TPU
// kernel's C % block_m rule is a TPU tiling rule.  A block of 256 threads
// computes a BM x 128 output tile on the CUDA cores in float32: per k step
// of 32 it stages x's BM x 32 tile and w[e]'s 32 x 128 tile in shared
// memory as float32, and each thread accumulates BM/8 x 4 outputs in
// registers.  The row tile BM (8, 16, 32 or 64) is the smallest that covers
// C up to 64, so at decode (C = 8) no thread computes padding rows, and the
// weights of an expert are read once for C <= 64.  Ragged D, F and C are
// masked.  Left for later: the tensor cores (wgmma on bfloat16), TMA loads
// into a ring of shared-memory stages, 16-byte vector loads, and skipping
// experts whose capacity rows are all padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GM_THREADS = 256;
constexpr int GM_BN = 128;  // output columns of a tile
constexpr int GM_BK = 32;   // depth of a k step
constexpr int GM_TN = 4;    // columns per thread: GM_BN / GM_TN = 32 threads across

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int BM>
__global__ void __launch_bounds__(GM_THREADS)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      long long C, long long D, long long F) {
  constexpr int TM = BM / 8;  // rows per thread: 8 thread rows of 32 threads
  __shared__ float xs[GM_BK][BM + 1];  // +1: the transposing store hits distinct banks
  __shared__ float ws[GM_BK][GM_BN];
  const long long e = blockIdx.z;
  const long long m0 = (long long)blockIdx.y * BM;  // first row of the tile within expert e
  const long long n0 = (long long)blockIdx.x * GM_BN;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const T* xe = x + (e * C) * D;
  const T* we = w + e * D * F;
  float acc[TM][GM_TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < GM_TN; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < D; k0 += GM_BK) {
    // x tile: BM rows x GM_BK depth, consecutive threads on consecutive k
    for (int t = threadIdx.x; t < BM * GM_BK; t += GM_THREADS) {
      const int i = t / GM_BK, kk = t % GM_BK;
      const long long m = m0 + i, k = k0 + kk;
      xs[kk][i] = (m < C && k < D) ? load_f(xe + m * D + k) : 0.f;
    }
    // w tile: GM_BK rows x GM_BN columns, consecutive threads on consecutive columns
    for (int t = threadIdx.x; t < GM_BK * GM_BN; t += GM_THREADS) {
      const int kk = t / GM_BN, j = t % GM_BN;
      const long long k = k0 + kk, n = n0 + j;
      ws[kk][j] = (k < D && n < F) ? load_f(we + k * F + n) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[TM], b[GM_TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < GM_TN; ++j) b[j] = ws[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < GM_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 8 * i;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < GM_TN; ++j) {
      const long long n = n0 + tx + 32 * j;
      if (n < F) store_f(out + (e * C + m) * F + n, acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch(const void* x, const void* w, void* out, long long E, long long C, long long D,
           long long F, cudaStream_t s) {
  const long long row_tiles = (C + BM - 1) / BM;
  const long long col_tiles = (F + GM_BN - 1) / GM_BN;
  if (E > 65535 || row_tiles > 65535 || col_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)col_tiles, (unsigned)row_tiles, (unsigned)E);
  grouped_matmul_kernel<T, BM><<<grid, GM_THREADS, 0, s>>>(
      (const T*)x, (const T*)w, (T*)out, C, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_capacity(const void* x, const void* w, void* out, long long E, long long C,
                        long long D, long long F, cudaStream_t s) {
  if (C <= 8) return launch<T, 8>(x, w, out, E, C, D, F, s);
  if (C <= 16) return launch<T, 16>(x, w, out, E, C, D, F, s);
  if (C <= 32) return launch<T, 32>(x, w, out, E, C, D, F, s);
  return launch<T, 64>(x, w, out, E, C, D, F, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  Returns a CUDA
// error code; the caller skips empty outputs (E*C*F == 0).
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, long long E,
                                    long long C, long long D, long long F, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || C <= 0 || F <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_for_capacity<float>(x, w, out, E, C, D, F, s);
  if (dtype == 1) return launch_for_capacity<__nv_bfloat16>(x, w, out, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}
