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
// them.  Returns the first CUDA error, or 0.
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

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
