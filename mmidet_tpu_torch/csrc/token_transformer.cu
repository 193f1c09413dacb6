// L-layer pre-LN token transformer over 128 tokens (2 modalities x 8x8).
//
// Replaces the TPU kernel
// mmidet_tpu/nn/transformer_pallas.py:fused_token_transformer (its
// transformer_layer core).  Each layer:
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
// What bounds it on the H100: operations.  At the main path's shapes
// (B = 16, L = 8, d = 64 to 512) one call does 2.1 to 107 GFLOP on 1.3 to
// 55 MB, 0.002 to 0.11 ms at the bf16 tensor-core peak.  This first design
// stays far above that bound (PERF.md has its times): launch count and small
// grids decide the time at small d, and the GEMM (wmma, no asynchronous
// copies, no wgmma) at large d.  The design is simple:
//   * a LayerNorm kernel, one warp per token row;
//   * one tiled bf16 tensor-core GEMM (nvcuda::wmma 16x16x16, f32
//     accumulators, 64x64 block tile, K loop in steps of 32, ragged N and K
//     edges zero-filled) whose epilogue adds the bias in f32 and optionally
//     applies erf-GELU or adds the bf16 residual, then stores bf16; it
//     serves qkv (one product against the concatenated weight), wo, w1 and
//     w2, for any d that is a multiple of 8 (d = 1024 included);
//   * an attention kernel, one block per (image, head): Q, K, V (128 x dk,
//     dk zero-padded to a multiple of 16) in shared memory, 128x128 f32
//     scores, row softmax in f32, P in bf16, P V in f32, all with wmma.
// The host loop below launches 7 kernels per layer on the caller's stream
// and checks cudaGetLastError after each.  Fusing the layer into fewer
// launches is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTok = 128;  // tokens per image

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

// ---------------------------------------------------------------- LayerNorm
__global__ void layernorm_kernel(const bf16* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ y, int M, int d,
                                 float eps) {
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

// --------------------------------------------------------------------- GEMM
// C (M, N) = epilogue(A (M, K) @ W (N, K)^T + bias).  M % 64 == 0,
// N % 8 == 0, K % 8 == 0 (16-byte rows).  R may alias C (the in-place
// residual update): each element is read and written by the same thread.
enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdAB = kBK + 8;  // bf16 row pitch of the staged tiles
constexpr int kLdC = kBN + 4;   // f32 row pitch of the staged result

template <int EPI>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const bf16* R, bf16* C, int M,
            int N, int K) {
  __shared__ __align__(128) bf16 As[kBM * kLdAB];
  __shared__ __align__(128) bf16 Ws[kBN * kLdAB];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 64 rows x 32 columns of each operand, 8 bf16 (16 bytes) per load;
    // columns past K and weight rows past N are zero-filled
    for (int i = tid; i < kBM * kBK / 8; i += 128) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool k_in = k0 + c < K;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&As[r * kLdAB + c]) =
          k_in ? *reinterpret_cast<const uint4*>(
                     &A[(size_t)(m0 + r) * K + k0 + c])
               : zero;
      *reinterpret_cast<uint4*>(&Ws[r * kLdAB + c]) =
          k_in && n0 + r < N ? *reinterpret_cast<const uint4*>(
                                   &W[(size_t)(n0 + r) * K + k0 + c])
                             : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * kLdAB + kk], kLdAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[(wn + 16 * j) * kLdAB + kk], kLdAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * kLdC + wn + 16 * j],
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += 128) {
    const int r = i / kBN, c = i % kBN;
    if (n0 + c >= N) continue;
    const size_t g = (size_t)(m0 + r) * N + n0 + c;
    float v = Cs[r * kLdC + c] + bias[n0 + c];
    if (EPI == kBiasGelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    if (EPI == kBiasResidual) v = __bfloat162float(R[g]) + v;
    C[g] = __float2bfloat16(v);
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
  attention_kernel<DKP><<<B * heads, 256, smem, st>>>(
      qkv, ctx, d, heads, dk, 1.0f / sqrtf((float)dk));
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias,
                        const bf16* R, bf16* C, int M, int N, int K,
                        cudaStream_t st) {
  gemm_kernel<EPI><<<dim3((N + kBN - 1) / kBN, M / kBM), 128, 0, st>>>(
      A, W, bias, R, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

#define TT_CHECK(expr)                 \
  do {                                 \
    cudaError_t e_ = (expr);           \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

extern "C" {

// x, out: (B, 128, d) bf16.  Per-layer stacks (L first): ln1s/ln1b/ln2s/
// ln2b (L, d) f32; wqkv (L, 3d, d) bf16, bqkv (L, 3d) f32; wo (L, d, d)
// bf16, bo (L, d) f32; w1 (L, 4d, d) bf16, b1 (L, 4d) f32; w2 (L, d, 4d)
// bf16, b2 (L, d) f32.  Scratch: y and ctx (B*128, d), qkv (B*128, 3d),
// hdn (B*128, 4d), all bf16.  d % 8 == 0, d / heads at most 128.
// Returns the first CUDA error, or 0.
int tt_forward(const void* x, void* out, const void* ln1s, const void* ln1b,
               const void* wqkv, const void* bqkv, const void* wo,
               const void* bo, const void* ln2s, const void* ln2b,
               const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, void* qkv, void* ctx, void* hdn,
               int B, int d, int L, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * kTok, dk = d / heads;
  const int dkp = dk <= 16 ? 16 : dk <= 32 ? 32 : dk <= 64 ? 64 : 128;
  const float eps = 1e-5f;
  bf16* a = (bf16*)out;
  bf16* yb = (bf16*)y;
  bf16* qkvb = (bf16*)qkv;
  bf16* ctxb = (bf16*)ctx;
  bf16* hb = (bf16*)hdn;
  TT_CHECK(cudaMemcpyAsync(a, x, (size_t)M * d * sizeof(bf16),
                           cudaMemcpyDeviceToDevice, st));
  const int ln_blocks = (M * 32 + 255) / 256;
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

    layernorm_kernel<<<ln_blocks, 256, 0, st>>>(a, l1s, l1b, yb, M, d, eps);
    TT_CHECK(cudaGetLastError());
    TT_CHECK(launch_gemm<kBias>(yb, wq, bq, nullptr, qkvb, M, 3 * d, d, st));
    TT_CHECK(dkp == 16   ? launch_attention<16>(qkvb, ctxb, B, d, heads, dk, st)
             : dkp == 32 ? launch_attention<32>(qkvb, ctxb, B, d, heads, dk, st)
             : dkp == 64 ? launch_attention<64>(qkvb, ctxb, B, d, heads, dk, st)
                         : launch_attention<128>(qkvb, ctxb, B, d, heads, dk,
                                                 st));
    TT_CHECK(launch_gemm<kBiasResidual>(ctxb, wol, bol, a, a, M, d, d, st));
    layernorm_kernel<<<ln_blocks, 256, 0, st>>>(a, l2s, l2b, yb, M, d, eps);
    TT_CHECK(cudaGetLastError());
    TT_CHECK(
        launch_gemm<kBiasGelu>(yb, w1l, b1l, nullptr, hb, M, 4 * d, d, st));
    TT_CHECK(launch_gemm<kBiasResidual>(hb, w2l, b2l, a, a, M, d, 4 * d, st));
  }
  return 0;
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
