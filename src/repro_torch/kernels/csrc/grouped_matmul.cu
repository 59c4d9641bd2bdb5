// Expert-blocked (grouped) matmul of the sorted MoE dispatch:
// out[e*C + i, :] = x[e*C + i, :] @ w[e] for x (E*C, D), w (E, D, F), both
// bfloat16 or both float32, float32 accumulation, the output in x's dtype
// rounded once.
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
// Two variants; grouped_matmul.variant in Python picks one from the dtype
// and the shape, and the C entry point launches the one it is given,
// refusing a choice whose preconditions do not hold:
//
// * tensor cores (bfloat16, D and F multiples of 8, 16-byte aligned
//   tensors): the product is computed transposed, out_e^T = w_e^T x_e^T,
//   so that 64 of an expert's F columns fill wgmma's 64-row M and its C
//   token rows become N (8 at decode, 64 at prefill; up to 256 a tile, more
//   in several tiles): with x as M, decode's C = 8 would leave 7/8 of every
//   64-row tile padding.  w[e] is (D, F), so as the A operand it is
//   MN-major (wgmma's transposed A from shared memory); x is a K-major B.
//   A block owns 128 of F (two consumer warpgroups of 64) for one expert
//   and one N tile; one producer warp streams 64-deep slices of w[e] and
//   x_e with TMA into a ring of four shared-memory stages, 128-byte
//   swizzled, each with a full and an empty mbarrier, so some 64 KB of
//   every block is in flight while the tensor cores work.  TMA's
//   three-dimensional maps, (F, D, E) for w and (D, C, E) for x, fill
//   whatever lies past D or past an expert's C rows with zeros, so any C
//   works.  The accumulators stay in registers; the epilogue writes the
//   (F tile x C) accumulator transposed into rows e*C + i, masked at C
//   and F.  The tensor maps are cached by (pointer, shape, tile): a
//   decode step makes 144 calls on the same weights.
// * CUDA cores (float32, which wgmma does not take, and bfloat16 widths
//   that are no multiple of 8, which TMA does not take): a tile never
//   straddles two experts.  The grid is (column tile, row tile within the
//   expert's C rows, expert).  A block of 256 threads computes a BM x 128
//   output tile in float32: per k step of 32 it stages x's BM x 32 tile and
//   w[e]'s 32 x 128 tile in shared memory as float32, and each thread
//   accumulates BM/8 x 4 outputs in registers.  The row tile BM is 8, 16, 32
//   or 64 (grouped_matmul.variant picks it from C).
//
// Left for later: skipping experts whose capacity rows are all padding
// (per-expert counts would have to reach the kernel), fusing wg and wi
// into one call, and a persistent grid.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core variant
// ---------------------------------------------------------------------------

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
int launch_simt(const void* x, const void* w, void* out, long long E, long long C, long long D,
                long long F, int tile, cudaStream_t s) {
  switch (tile) {
    case 8: return launch<T, 8>(x, w, out, E, C, D, F, s);
    case 16: return launch<T, 16>(x, w, out, E, C, D, F, s);
    case 32: return launch<T, 32>(x, w, out, E, C, D, F, s);
    case 64: return launch<T, 64>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// tensor-core variant
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;      // F columns a block: two consumer warpgroups of 64
constexpr int TC_BK = 64;       // D depth a stage: one 128-byte swizzle row of bfloat16
constexpr int TC_STAGES = 4;
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // + one producer warp
constexpr uint32_t TC_A_BYTES = TC_BK * 64 * 2;  // one 64-column half of w's slice

template <int BN>
struct TcShape {
  static constexpr uint32_t B_BYTES = BN * TC_BK * 2;
  static constexpr uint32_t STAGE_BYTES = 2 * TC_A_BYTES + B_BYTES;  // a multiple of 1024
  // stages, 2 x TC_STAGES mbarriers, and slack to align the base to 1024
  static constexpr uint32_t SMEM_BYTES = TC_STAGES * STAGE_BYTES + 16 * TC_STAGES + 1024;
  static constexpr int MIN_BLOCKS = BN <= 64 ? 2 : 1;  // what shared memory lets an SM hold
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand tile:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D(64 x N, f32) += A(64 x 16, bf16, MN-major: imm-trans-a 1) *
// B(16 x N, bf16, K-major: imm-trans-b 0), both from shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
        "%122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// One block: F columns [f0, f0 + 128) of expert e, token rows [n0, n0 + BN)
// of its C.  Warps 0-7 are two consumer warpgroups (64 columns each), warp
// 8 the producer.
template <int BN>
__global__ void __launch_bounds__(TC_THREADS, TcShape<BN>::MIN_BLOCKS)
grouped_matmul_wgmma(const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_x, __nv_bfloat16* __restrict__ out,
                     int C, int D, int F) {
  using S = TcShape<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle: 1024-aligned
  const uint32_t bars = base + TC_STAGES * S::STAGE_BYTES;
  auto a_tile = [&](int s, int h) { return base + s * S::STAGE_BYTES + h * TC_A_BYTES; };
  auto b_tile = [&](int s) { return base + s * S::STAGE_BYTES + 2 * TC_A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (TC_STAGES + s); };

  const int f0 = blockIdx.x * TC_BM, e = blockIdx.y, n0 = blockIdx.z * BN;
  const int ktiles = (D + TC_BK - 1) / TC_BK;
  const bool second_half = f0 + 64 < F;  // the second 64 columns hold a real column
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {  // producer
    if (threadIdx.x % 32 == 0) {
      const uint32_t bytes = (second_half ? 2 : 1) * TC_A_BYTES + S::B_BYTES;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % TC_STAGES;
        if (kt >= TC_STAGES) mbar_wait(empty(s), ((kt / TC_STAGES) - 1) & 1);
        mbar_expect_tx(full(s), bytes);
        tma_load_3d(a_tile(s, 0), &map_w, full(s), f0, kt * TC_BK, e);
        if (second_half) tma_load_3d(a_tile(s, 1), &map_w, full(s), f0 + 64, kt * TC_BK, e);
        tma_load_3d(b_tile(s), &map_x, full(s), kt * TC_BK, n0, e);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const bool active = wg == 0 || second_half;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % TC_STAGES;
    mbar_wait(full(s), (kt / TC_STAGES) & 1);
    if (active) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        // A: 16 rows of 128 bytes a k step, 8-row groups 1024 bytes apart;
        // B: 32 bytes a k step inside the swizzled 128-byte rows, 8-row
        // groups 1024 bytes apart
        const uint64_t da = sw128_desc(a_tile(s, wg) + kk * 2048, TC_A_BYTES, 1024);
        const uint64_t db = sw128_desc(b_tile(s) + kk * 32, 16, 1024);
        Wgmma<BN>::mma(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    mbar_arrive(empty(s));
  }
  if (!active) return;
  // accumulator element j of thread t: M row 16*(t/32) + (t%32)/4 + 8*((j/2)%2),
  // N column 8*(j/4) + 2*(t%4) + j%2
  const int t = threadIdx.x % 128;
  const int fbase = f0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int cbase = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int f = fbase + 8 * ((j >> 1) & 1);
    const int c = cbase + 8 * (j >> 2) + (j & 1);
    if (f < F && c < C) out[((long long)e * C + c) * F + f] = __float2bfloat16(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// host side of the tensor-core variant
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  });
  return fn;
}

struct MapKey {
  uint64_t ptr, d0, d1, d2, box1;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && box1 == o.box1;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {k.d0, k.d1, k.d2, k.box1}) h = (h ^ v) * 0x100000001b3ULL;
    return (size_t)h;
  }
};

// A bfloat16 tensor map of a contiguous (d2, d1, d0) tensor, boxes of
// (1, box1, 64) with 128-byte swizzle and zeros past its edges.  A map
// depends only on (pointer, shape, box), so it is cached under them.
int tensor_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t box1) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{(uint64_t)ptr, d0, d1, d2, box1};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, void* out, long long E, long long C, long long D,
                 long long F, cudaStream_t s) {
  using S = TcShape<BN>;
  const long long ftiles = (F + TC_BM - 1) / TC_BM, ntiles = (C + BN - 1) / BN;
  if (E > 65535 || ntiles > 65535 || ftiles > 0x7fffffffLL || D > 0x7fffffffLL ||
      C > 0x7fffffffLL || F > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_w, map_x;
  int err = tensor_map(&map_w, w, (uint64_t)F, (uint64_t)D, (uint64_t)E, TC_BK);
  if (err) return err;
  err = tensor_map(&map_x, x, (uint64_t)D, (uint64_t)C, (uint64_t)E, BN);
  if (err) return err;
  static std::once_flag attr_once;
  static cudaError_t attr_err = cudaSuccess;
  std::call_once(attr_once, [] {
    attr_err = cudaFuncSetAttribute(grouped_matmul_wgmma<BN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)S::SMEM_BYTES);
  });
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((unsigned)ftiles, (unsigned)E, (unsigned)ntiles);
  grouped_matmul_wgmma<BN><<<grid, TC_THREADS, S::SMEM_BYTES, s>>>(
      map_w, map_x, (__nv_bfloat16*)out, (int)C, (int)D, (int)F);
  return (int)cudaGetLastError();
}

int launch_wgmma_tile(const void* x, const void* w, void* out, long long E, long long C,
                      long long D, long long F, int tile, cudaStream_t s) {
  switch (tile) {
    case 8: return launch_wgmma<8>(x, w, out, E, C, D, F, s);
    case 16: return launch_wgmma<16>(x, w, out, E, C, D, F, s);
    case 32: return launch_wgmma<32>(x, w, out, E, C, D, F, s);
    case 64: return launch_wgmma<64>(x, w, out, E, C, D, F, s);
    case 128: return launch_wgmma<128>(x, w, out, E, C, D, F, s);
    case 256: return launch_wgmma<256>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  variant: 0 = the
// CUDA cores with row tile `tile` (8, 16, 32 or 64), 1 = the tensor cores
// with N tile `tile` (8 to 256), as grouped_matmul.variant chooses; the
// tensor cores refuse a dtype, width or alignment TMA cannot take.
// Returns a CUDA error code; the caller skips empty outputs (E*C*F == 0).
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, long long E,
                                    long long C, long long D, long long F, int dtype,
                                    int variant, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || C <= 0 || F <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
    if (dtype != 1 || D <= 0 || D % 8 != 0 || F % 8 != 0 || !aligned)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma_tile(x, w, out, E, C, D, F, tile, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_simt<float>(x, w, out, E, C, D, F, tile, s);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(x, w, out, E, C, D, F, tile, s);
  return (int)cudaErrorInvalidValue;
}
