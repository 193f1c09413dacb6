// K1, the fused token transformer: (B, 128, d) bf16 tokens through L pre-LN
// layers, ln_f left to the caller.
//
// Replaces the TPU kernel
// mmidet_tpu/nn/transformer_pallas.py:fused_token_transformer.  The device
// code, its design and what bounds it on the H100 are in
// token_transformer.cuh, which the fused GPT-merge kernel (gpt_merge.cu)
// shares.

#include "token_transformer.cuh"

extern "C" {

// x, out: (B, 128, d) bf16; weights and scratch as tt_run_layers takes
// them.  Returns the first error, or 0.
int tt_forward(const void* x, void* out, const void* ln1s, const void* ln1b,
               const void* wqkv, const void* bqkv, const void* wo,
               const void* bo, const void* ln2s, const void* ln2b,
               const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, void* qkv, void* ctx, void* hdn,
               int B, int d, int L, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  TT_CHECK(cudaMemcpyAsync(out, x, (size_t)B * kTok * d * sizeof(bf16),
                           cudaMemcpyDeviceToDevice, st));
  return tt_run_layers((bf16*)out, ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s, ln2b,
                       w1, b1, w2, b2, y, qkv, ctx, hdn, B, d, L, heads, st);
}

// The layer GEMM alone, for tests and measurement: C = epilogue(A W^T +
// bias) with epilogue 0 (bias), 1 (bias + erf-GELU) or 2 (bias + the bf16
// residual R, which may alias C), on the tile number `tile` of
// token_transformer.cuh's kTiles (-1: the one the layers would pick).
// A (M, K), W (N, K), R, C (M, N) bf16 row-major and bias (N,) f32, all
// 16-byte aligned; N and K multiples of 8.  Returns the first error, or 0.
int tt_gemm_tile(const void* A, const void* W, const void* bias,
                 const void* R, void* C, int M, int N, int K, int epilogue,
                 int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* a = (const bf16*)A;
  const bf16* w = (const bf16*)W;
  const float* b = (const float*)bias;
  switch (epilogue) {
    case kBias:
      return launch_gemm<kBias>(a, w, b, nullptr, (bf16*)C, M, N, K, st,
                                tile);
    case kBiasGelu:
      return launch_gemm<kBiasGelu>(a, w, b, nullptr, (bf16*)C, M, N, K, st,
                                    tile);
    case kBiasResidual:
      return launch_gemm<kBiasResidual>(a, w, b, (const bf16*)R, (bf16*)C, M,
                                        N, K, st, tile);
  }
  return kErrShape;
}

// tt_gemm_tile on the tile the layers pick
int tt_gemm(const void* A, const void* W, const void* bias, const void* R,
            void* C, int M, int N, int K, int epilogue, void* stream) {
  return tt_gemm_tile(A, W, bias, R, C, M, N, K, epilogue, -1, stream);
}

const char* error_string(int err) { return tt_error_string(err); }

}  // extern "C"
