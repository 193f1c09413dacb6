// Device code of the L-layer pre-LN token transformer, shared by the two
// kernels that run it: token_transformer.cu (K1, tokens in, tokens out) and
// gpt_merge.cu (K4, which pools the tokens itself and merges the result
// back into the streams).  Both include this header, so the layer arithmetic
// and its rounding points stay in lockstep, as transformer_layer keeps the
// two Pallas kernels (mmidet_tpu/nn/transformer_pallas.py:64-144).
//
// Each layer:
//   y   = bf16(LN1(a))                           (f32 statistics, eps 1e-5)
//   qkv = bf16(y @ [wq|wk|wv]^T + b)             (f32 accumulate)
//   P   = bf16(softmax_f32(q k^T / sqrt(dk)))    per (image, head)
//   ctx = bf16(P v)
//   a   = bf16(a + (ctx @ wo^T + bo))
//   y   = bf16(LN2(a))
//   h   = bf16(gelu_erf(y @ w1^T + b1))
//   a   = bf16(a + (h @ w2^T + b2))
// with the rounding points of the Pallas kernel, so that the plain PyTorch
// version (nn/transformer_cuda.py) holds it tightly.  The final ln_f is the
// caller's.  Weights use torch's Linear layout (out, in), stacked over L.
//
// What bounds it on the H100: operations.  At the main paths' shapes
// (B = 16, L = 8, d = 64 to 1024) one call does 2.1 to 421 GFLOP on 1.3 to
// 210 MB, 0.002 to 0.43 ms at the bf16 tensor-core peak; the four products
// are all but 4 n^2 d of each layer's 24 n d^2 + 4 n^2 d operations (n =
// 128 tokens per image).  So the design is built around the product:
//   * gemm_kernel, one templated kernel for qkv (one product against the
//     concatenated weight), wo, w1 and w2.  A (M, K) row-major and the
//     weight W (N, K), torch's Linear layout, are both K-major, as wgmma
//     takes bf16 operands without a transpose.  One producer warp issues TMA
//     copies (64-wide K tiles: 128-byte rows, 128-byte swizzle) into a ring
//     of 3 or 4 shared-memory stages with an mbarrier pair per stage; one or
//     two consumer warpgroups run wgmma.mma_async m64nNk16 on each stage
//     with the f32 accumulators in registers, keeping one stage's products
//     in flight while they release the previous stage.  The host picks the
//     tile (64 or 128 rows x 64, 128 or 256 columns, and the ring's depth)
//     per product so that the grid fills the SMs (pick_tile).  TMA fills
//     columns past K and rows past M or N with zeros; the epilogue masks N
//     and M.  The epilogue works from the registers: a shuffle within each
//     quad of lanes gives every thread 8 neighbouring columns of two rows,
//     so the bias is loaded once per column and the residual read and the
//     result stored 16 bytes at a time; it adds the bias in f32, applies
//     erf-GELU or adds the bf16 residual (R may alias C: each element is
//     read and written by one thread), and rounds to bf16 once.  Any M, N
//     and K that are multiples of 8 (d = 16 .. 1024 and wider).
//   * a LayerNorm kernel, one warp per token row: each lane reads its part
//     of the row once, 16 bytes at a time, into registers (d <= 1024), and
//     takes two-pass f32 statistics from them.
//   * an attention kernel, one block per (image, head): Q, K, V (128 x dk,
//     dk zero-padded to a multiple of 16) in shared memory, 128x128 f32
//     scores, row softmax in f32, P in bf16, P V in f32, all with wmma.
//     Attention is a small share of the time (PERF.md) and keeps the first
//     design.
// The host loop (tt_run_layers) launches 7 kernels per layer on the
// caller's stream, each a programmatic dependent launch (launch_pdl), and
// checks each launch.  LayerNorm fused into the GEMM that reads it, and
// fewer launches per call, are later work (ROADMAP.md).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime (cudaGetDriverEntryPoint), so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// return the first error from a host function that returns int
#define TT_CHECK(expr)          \
  do {                          \
    const int e_ = (int)(expr); \
    if (e_ != 0) return e_;     \
  } while (0)

namespace {

constexpr int kTok = 128;  // tokens per image

// errors of the layer code's own, beside cudaError_t's codes
enum {
  kErrNoEncoder = 20001,  // no cuTensorMapEncodeTiled entry point found
  kErrTensorMap = 20002,  // cuTensorMapEncodeTiled refused an operand
  kErrShape = 20003,      // GEMM shape, epilogue or tile out of range
};

const char* tt_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "no cuTensorMapEncodeTiled entry point found";
    case kErrTensorMap:
      return "cuTensorMapEncodeTiled refused an operand (its address must "
             "be 16-byte aligned and K a multiple of 8)";
    case kErrShape:
      return "GEMM shape out of range (M >= 1, N and K multiples of 8), "
             "or unknown epilogue or tile";
  }
  return cudaGetErrorString((cudaError_t)err);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Programmatic dependent launch.  Every layer kernel is launched with
// launch_pdl, so that it may be scheduled while the kernel before it on the
// stream drains; each one first waits for that kernel's grid to finish and
// its writes to be visible (griddepcontrol.wait), then lets the next kernel
// be scheduled (launch_dependents).  What overlaps is the launch, the block
// scheduling and the set-up before the wait, not the work.
__device__ __forceinline__ void pdl_wait_then_release() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
               cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------- LayerNorm
// One warp per row.  NC > 0: lane l holds the 16-byte chunks l, l + 32, ...
// (NC of them, d <= 256 NC) in registers and reads the row once.
template <int NC>
__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M,
                 int d, float eps) {
  pdl_wait_then_release();
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int chunks = d >> 3;
  const bf16* xr = x + (size_t)row * d;
  float v[NC][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int ch = lane + 32 * i;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (ch < chunks) u = *reinterpret_cast<const uint4*>(xr + 8 * ch);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[i][2 * e] = f.x;
      v[i][2 * e + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float t = v[i][e] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  bf16* yr = y + (size_t)row * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= d) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + c + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      oh[e] = __floats2bfloat162_rn(
          (v[i][2 * e] - mean) * rstd * sc[2 * e] + bi[2 * e],
          (v[i][2 * e + 1] - mean) * rstd * sc[2 * e + 1] + bi[2 * e + 1]);
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

// rows wider than 1024: the same statistics, the row read three times
__global__ void layernorm_kernel_wide(const bf16* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      bf16* __restrict__ y, int M, int d,
                                      float eps) {
  pdl_wait_then_release();
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += __bfloat162float(xr[c]);
  const float mean = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = __bfloat162float(xr[c]) - mean;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / d + eps);
  bf16* yr = y + (size_t)row * d;
  for (int c = lane; c < d; c += 32)
    yr[c] = __float2bfloat16(
        (__bfloat162float(xr[c]) - mean) * rstd * scale[c] + bias[c]);
}

// y (M, d) = bf16(LN(x)); d % 8 == 0, scale and bias 16-byte aligned
int launch_layernorm(const bf16* x, const float* scale, const float* bias,
                     bf16* y, int M, int d, float eps, cudaStream_t st) {
  const dim3 grid((M * 32 + 255) / 256), block(256);
  switch ((d + 255) / 256) {
    case 1:
      return launch_pdl(layernorm_kernel<1>, grid, block, 0, st, x, scale,
                        bias, y, M, d, eps);
    case 2:
      return launch_pdl(layernorm_kernel<2>, grid, block, 0, st, x, scale,
                        bias, y, M, d, eps);
    case 3:
      return launch_pdl(layernorm_kernel<3>, grid, block, 0, st, x, scale,
                        bias, y, M, d, eps);
    case 4:
      return launch_pdl(layernorm_kernel<4>, grid, block, 0, st, x, scale,
                        bias, y, M, d, eps);
    default:
      return launch_pdl(layernorm_kernel_wide, grid, block, 0, st, x, scale,
                        bias, y, M, d, eps);
  }
}

// --------------------------------------------------------------------- GEMM
// C (M, N) = epilogue(A (M, K) @ W (N, K)^T + bias), bf16 in and out, f32
// accumulate and bias.
enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

constexpr int kBK = 64;  // K tile: 64 bf16, one 128-byte swizzled row

template <int BN, int WG, int STAGES>
struct GemmTraits {
  static constexpr int kBM = 64 * WG;        // one warpgroup per 64 rows
  static constexpr int kStages = STAGES;     // shared-memory ring
  static constexpr int kA = kBM * kBK * 2;   // bytes of one A stage
  static constexpr int kW = BN * kBK * 2;    // bytes of one W stage
  static constexpr int kTx = kA + kW;        // bytes TMA lands per stage
  // stages, two mbarriers per stage, and room to align the ring to 1024
  // bytes (the 128-byte swizzle repeats every 8 rows of 128 bytes)
  static constexpr size_t kBytes = kStages * (size_t)kTx +
                                   2 * kStages * sizeof(uint64_t) + 1024;
  // blocks that fit on an SM by shared memory (232448 bytes): ptxas keeps
  // the registers low enough for as many
  static constexpr int kMinBlocks = 232448 / kBytes;
};

// bias, epilogue and one rounding for 8 neighbouring columns of one row;
// R is read and C written 16 bytes at a time
template <int EPI>
__device__ __forceinline__ void store8(const float (&v)[8],
                                       const float (&b)[8], const bf16* R,
                                       bf16* C, size_t off) {
  float o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = v[i] + b[i];
    if (EPI == kBiasGelu)
      o[i] = 0.5f * o[i] * (1.f + erff(o[i] * 0.70710678118654752f));
  }
  if (EPI == kBiasResidual) {
    const uint4 ru = *reinterpret_cast<const uint4*>(R + off);
    const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&ru);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 r = __bfloat1622float2(rh[e]);
      o[2 * e] = r.x + o[2 * e];
      o[2 * e + 1] = r.y + o[2 * e + 1];
    }
  }
  uint4 out;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    oh[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
  *reinterpret_cast<uint4*>(C + off) = out;
}

// Block: WG consumer warpgroups (warps 0 .. 4 WG - 1, 64 rows each), then
// one producer warp.  Tile (64 WG) x BN of C at (blockIdx.y, blockIdx.x),
// a ring of STAGES K tiles.
template <int BN, int WG, int STAGES, int EPI>
__global__ void __launch_bounds__(128 * WG + 32,
                                  GemmTraits<BN, WG, STAGES>::kMinBlocks)
gemm_kernel(const __grid_constant__ CUtensorMap tmA,
            const __grid_constant__ CUtensorMap tmW,
            const float* __restrict__ bias, const bf16* R, bf16* C, int M,
            int N, int K) {
  using S = GemmTraits<BN, WG, STAGES>;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  unsigned char* sm =
      gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  constexpr int kStages = S::kStages;
  unsigned char* a_ring = sm;                    // kStages x kA
  unsigned char* w_ring = sm + kStages * S::kA;  // kStages x kW
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * S::kTx);
  uint64_t* empty = full + kStages;
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * S::kBM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_wait_then_release();  // A, R and C belong to the kernel before

  if (threadIdx.x >= 128 * WG) {  // producer: one thread issues the copies
    if (threadIdx.x == 128 * WG) {
      for (int k = 0; k < nk; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], (k / kStages - 1) & 1);
        mbar_expect_tx(&full[s], S::kTx);
        tma_load_2d(a_ring + s * S::kA, &tmA, &full[s], k * kBK, m0);
        tma_load_2d(w_ring + s * S::kW, &tmW, &full[s], k * kBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = threadIdx.x >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int k = 0; k < nk; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    const uint32_t a = smem_u32(a_ring + s * S::kA) + wg * 64 * 128;
    const uint32_t w = smem_u32(w_ring + s * S::kW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16<BN>(acc, wgmma_desc(a + 32 * kk), wgmma_desc(w + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // step k - 1's products are done: release its stage
    if (k > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(&empty[(k - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue from the registers.  In each group of 4 column blocks (32
  // columns), lane q of a quad ends up with all 8 columns of block q in
  // both its rows: in round r it sends its part of block q ^ r and
  // receives lane (q ^ r)'s part of block q, columns 2 (q ^ r) and
  // 2 (q ^ r) + 1 of it.
  const int t = threadIdx.x & 127, lane = t & 31, q = lane & 3;
  const int row = m0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int g = 0; g < BN / 32; ++g) {
    float top[8], bot[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = q ^ r;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc[16 * g + e];
        x = j == 1 ? acc[16 * g + 4 + e] : x;
        x = j == 2 ? acc[16 * g + 8 + e] : x;
        x = j == 3 ? acc[16 * g + 12 + e] : x;
        v[e] = r ? __shfl_xor_sync(0xffffffffu, x, r) : x;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p == j) {
          top[2 * p] = v[0];
          top[2 * p + 1] = v[1];
          bot[2 * p] = v[2];
          bot[2 * p + 1] = v[3];
        }
      }
    }
    const int col = n0 + 32 * g + 8 * q;
    if (col < N) {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if (row < M) store8<EPI>(top, b, R, C, (size_t)row * N + col);
      if (row + 8 < M) store8<EPI>(bot, b, R, C, (size_t)(row + 8) * N + col);
    }
  }
}

// ------------------------------------------------------------ GEMM (host)
// tensor map of a (rows, K) row-major bf16 operand, box kBK x box_rows,
// 128-byte swizzle, zeros outside the operand
int encode_operand(CUtensorMap* map, const bf16* p, int rows, int K,
                   int box_rows) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<bf16*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BN, int WG, int STAGES, int EPI>
int launch_gemm_tile(const bf16* A, const bf16* W, const float* bias,
                     const bf16* R, bf16* C, int M, int N, int K,
                     cudaStream_t st) {
  using S = GemmTraits<BN, WG, STAGES>;
  CUtensorMap ta, tw;
  TT_CHECK(encode_operand(&ta, A, M, K, S::kBM));
  TT_CHECK(encode_operand(&tw, W, N, K, BN));
  static unsigned smem_set = 0;  // devices that took the attribute
  int dev = 0;
  TT_CHECK(cudaGetDevice(&dev));
  if (dev >= 32 || !(smem_set >> dev & 1u)) {
    TT_CHECK(cudaFuncSetAttribute(gemm_kernel<BN, WG, STAGES, EPI>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::kBytes));
    if (dev < 32) smem_set |= 1u << dev;
  }
  return launch_pdl(gemm_kernel<BN, WG, STAGES, EPI>,
                    dim3((N + BN - 1) / BN, (M + S::kBM - 1) / S::kBM),
                    dim3(128 * WG + 32), S::kBytes, st, ta, tw, bias, R, C,
                    M, N, K);
}

// The tiles on offer: columns, consumer warpgroups (rows / 64) and stages,
// with each one's share of the SM's tensor-core rate, rounded from what
// chip_profile.py's layer_gemm_tiles measures at the main paths' shapes
// (PERF.md).  The 128x128 tile comes
// twice: 4 stages, one block per SM, for a grid of one wave; 3 stages, two
// blocks per SM, where one block's epilogue then overlaps the other's
// products, for grids of more than one wave.
struct GemmTile {
  int bn, wg, stages;
  float rate;        // a grid of one wave at most
  float rate_waves;  // a grid of more than one wave
};
constexpr GemmTile kTiles[] = {{256, 2, 4, 1.0f, 1.0f},
                               {128, 2, 4, 0.85f, 0.85f},
                               {128, 2, 3, 0.75f, 0.95f},
                               {64, 2, 4, 0.6f, 0.6f},
                               {64, 1, 4, 0.4f, 0.4f}};

// the tile with the least modelled time: each SM's share of the tiles at
// that tile's rate (ties: the earlier)
int pick_tile(int M, int N) {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < (int)(sizeof(kTiles) / sizeof(kTiles[0])); ++i) {
    const GemmTile& t = kTiles[i];
    const int bm = 64 * t.wg;
    const long tiles = (long)((M + bm - 1) / bm) * ((N + t.bn - 1) / t.bn);
    const long per_sm = (tiles + sms - 1) / sms;
    const double cost = (double)per_sm * bm * t.bn /
                        (per_sm > 1 ? t.rate_waves : t.rate);
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

// C = epilogue(A W^T + bias) on the caller's stream.  A (M, K), W (N, K),
// R and C (M, N), all bf16 row-major, 16-byte aligned; bias (N,) f32.
// tile: an index into kTiles, or -1 for pick_tile's choice.
template <int EPI>
int launch_gemm(const bf16* A, const bf16* W, const float* bias,
                const bf16* R, bf16* C, int M, int N, int K,
                cudaStream_t st, int tile = -1) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || tile < -1 ||
      tile >= (int)(sizeof(kTiles) / sizeof(kTiles[0])))
    return kErrShape;
  switch (tile < 0 ? pick_tile(M, N) : tile) {
    case 0:
      return launch_gemm_tile<256, 2, 4, EPI>(A, W, bias, R, C, M, N, K, st);
    case 1:
      return launch_gemm_tile<128, 2, 4, EPI>(A, W, bias, R, C, M, N, K, st);
    case 2:
      return launch_gemm_tile<128, 2, 3, EPI>(A, W, bias, R, C, M, N, K, st);
    case 3:
      return launch_gemm_tile<64, 2, 4, EPI>(A, W, bias, R, C, M, N, K, st);
    default:
      return launch_gemm_tile<64, 1, 4, EPI>(A, W, bias, R, C, M, N, K, st);
  }
}

// ---------------------------------------------------------------- Attention
// qkv (B*128, 3d) bf16 -> ctx (B*128, d) bf16 for head blockIdx.x % heads
// of image blockIdx.x / heads.  256 threads: warp w owns query rows
// 16w..16w+15 from the scores on, so only the load needs a block barrier.
template <int DKP>
struct AttnSmem {
  static constexpr int kLdQ = DKP + 8;     // bf16 pitch of Q, K, V
  static constexpr int kLdS = kTok + 4;    // f32 pitch of S (and then O)
  static constexpr int kLdP = kTok + 8;    // bf16 pitch of P
  static constexpr size_t kBytes = 3 * kTok * kLdQ * sizeof(bf16) +
                                   kTok * kLdS * sizeof(float) +
                                   kTok * kLdP * sizeof(bf16);
};

template <int DKP>
__global__ void __launch_bounds__(256)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int d,
                 int heads, int dk, float inv_sqrt_dk) {
  using S = AttnSmem<DKP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kTok * S::kLdQ;
  bf16* Vs = Ks + kTok * S::kLdQ;
  float* Ss = reinterpret_cast<float*>(Vs + kTok * S::kLdQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kTok * S::kLdS);

  pdl_wait_then_release();
  const int img = blockIdx.x / heads, h = blockIdx.x % heads;
  const bf16* base = qkv + (size_t)img * kTok * 3 * d + h * dk;
  if ((dk & 7) == 0) {  // 16-byte loads; columns dk..DKP are zero padding
    for (int i = threadIdx.x; i < kTok * (DKP / 8); i += blockDim.x) {
      const int r = i / (DKP / 8), c = (i % (DKP / 8)) * 8;
      uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
      if (c < dk) {
        const bf16* row = base + (size_t)r * 3 * d + c;
        q = *reinterpret_cast<const uint4*>(row);
        k = *reinterpret_cast<const uint4*>(row + d);
        v = *reinterpret_cast<const uint4*>(row + 2 * d);
      }
      *reinterpret_cast<uint4*>(&Qs[r * S::kLdQ + c]) = q;
      *reinterpret_cast<uint4*>(&Ks[r * S::kLdQ + c]) = k;
      *reinterpret_cast<uint4*>(&Vs[r * S::kLdQ + c]) = v;
    }
  } else {  // narrow heads (dk not a multiple of 8): one element per load
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kTok * DKP; i += blockDim.x) {
      const int r = i / DKP, c = i % DKP;
      const bf16* row = base + (size_t)r * 3 * d + c;
      Qs[r * S::kLdQ + c] = c < dk ? row[0] : zero;
      Ks[r * S::kLdQ + c] = c < dk ? row[d] : zero;
      Vs[r * S::kLdQ + c] = c < dk ? row[2 * d] : zero;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp;
  {  // S = Q K^T for rows r0..r0+15
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTok / 16];
#pragma unroll
    for (int j = 0; j < kTok / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < DKP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &Qs[r0 * S::kLdQ + kk], S::kLdQ);
#pragma unroll
      for (int j = 0; j < kTok / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, &Ks[16 * j * S::kLdQ + kk], S::kLdQ);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTok / 16; ++j)
      wmma::store_matrix_sync(&Ss[r0 * S::kLdS + 16 * j], acc[j], S::kLdS,
                              wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = r0; r < r0 + 16; ++r) {  // row softmax in f32, P -> bf16
    float v[kTok / 32];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kTok / 32; ++t) {
      v[t] = Ss[r * S::kLdS + lane + 32 * t] * inv_sqrt_dk;
      mx = fmaxf(mx, v[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTok / 32; ++t) {
      v[t] = expf(v[t] - mx);
      sum += v[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kTok / 32; ++t)
      Ps[r * S::kLdP + lane + 32 * t] = __float2bfloat16(v[t] / sum);
  }
  __syncwarp();
  {  // O = P V for rows r0..r0+15, into this warp's rows of S
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DKP / 16];
#pragma unroll
    for (int j = 0; j < DKP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kTok; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &Ps[r0 * S::kLdP + kk], S::kLdP);
#pragma unroll
      for (int j = 0; j < DKP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Vs[kk * S::kLdQ + 16 * j], S::kLdQ);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < DKP / 16; ++j)
      wmma::store_matrix_sync(&Ss[r0 * S::kLdS + 16 * j], acc[j], S::kLdS,
                              wmma::mem_row_major);
  }
  __syncwarp();
  bf16* out = ctx + (size_t)img * kTok * d + h * dk;
  for (int i = lane; i < 16 * dk; i += 32) {
    const int r = r0 + i / dk, c = i % dk;
    out[(size_t)r * d + c] = __float2bfloat16(Ss[r * S::kLdS + c]);
  }
}

template <int DKP>
cudaError_t launch_attention(const bf16* qkv, bf16* ctx, int B, int d,
                             int heads, int dk, cudaStream_t st) {
  const size_t smem = AttnSmem<DKP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  return (cudaError_t)launch_pdl(attention_kernel<DKP>, dim3(B * heads),
                                 dim3(256), smem, st, qkv, ctx, d, heads, dk,
                                 1.0f / sqrtf((float)dk));
}

// The L layers, in place on a (B*128, d) bf16.  Per-layer stacks (L first):
// ln1s/ln1b/ln2s/ln2b (L, d) f32; wqkv (L, 3d, d) bf16, bqkv (L, 3d) f32;
// wo (L, d, d) bf16, bo (L, d) f32; w1 (L, 4d, d) bf16, b1 (L, 4d) f32;
// w2 (L, d, 4d) bf16, b2 (L, d) f32.  Scratch: y and ctx (B*128, d), qkv
// (B*128, 3d), hdn (B*128, 4d), all bf16.  d % 8 == 0, d / heads at most
// 128.  Returns the first error, or 0.
int tt_run_layers(bf16* a, const void* ln1s, const void* ln1b,
                  const void* wqkv, const void* bqkv, const void* wo,
                  const void* bo, const void* ln2s, const void* ln2b,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, void* y, void* qkv, void* ctx, void* hdn,
                  int B, int d, int L, int heads, cudaStream_t st) {
  const int M = B * kTok, dk = d / heads;
  const int dkp = dk <= 16 ? 16 : dk <= 32 ? 32 : dk <= 64 ? 64 : 128;
  const float eps = 1e-5f;
  bf16* yb = (bf16*)y;
  bf16* qkvb = (bf16*)qkv;
  bf16* ctxb = (bf16*)ctx;
  bf16* hb = (bf16*)hdn;
  for (int l = 0; l < L; ++l) {
    const float* l1s = (const float*)ln1s + (size_t)l * d;
    const float* l1b = (const float*)ln1b + (size_t)l * d;
    const float* l2s = (const float*)ln2s + (size_t)l * d;
    const float* l2b = (const float*)ln2b + (size_t)l * d;
    const bf16* wq = (const bf16*)wqkv + (size_t)l * 3 * d * d;
    const float* bq = (const float*)bqkv + (size_t)l * 3 * d;
    const bf16* wol = (const bf16*)wo + (size_t)l * d * d;
    const float* bol = (const float*)bo + (size_t)l * d;
    const bf16* w1l = (const bf16*)w1 + (size_t)l * 4 * d * d;
    const float* b1l = (const float*)b1 + (size_t)l * 4 * d;
    const bf16* w2l = (const bf16*)w2 + (size_t)l * 4 * d * d;
    const float* b2l = (const float*)b2 + (size_t)l * d;

    TT_CHECK(launch_layernorm(a, l1s, l1b, yb, M, d, eps, st));
    TT_CHECK(launch_gemm<kBias>(yb, wq, bq, nullptr, qkvb, M, 3 * d, d, st));
    TT_CHECK(dkp == 16   ? launch_attention<16>(qkvb, ctxb, B, d, heads, dk, st)
             : dkp == 32 ? launch_attention<32>(qkvb, ctxb, B, d, heads, dk, st)
             : dkp == 64 ? launch_attention<64>(qkvb, ctxb, B, d, heads, dk, st)
                         : launch_attention<128>(qkvb, ctxb, B, d, heads, dk,
                                                 st));
    TT_CHECK(launch_gemm<kBiasResidual>(ctxb, wol, bol, a, a, M, d, d, st));
    TT_CHECK(launch_layernorm(a, l2s, l2b, yb, M, d, eps, st));
    TT_CHECK(
        launch_gemm<kBiasGelu>(yb, w1l, b1l, nullptr, hb, M, 4 * d, d, st));
    TT_CHECK(launch_gemm<kBiasResidual>(hb, w2l, b2l, a, a, M, d, 4 * d, st));
  }
  return 0;
}

}  // namespace
