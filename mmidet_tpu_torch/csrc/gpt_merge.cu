// K4, the fused GPT merge: one fusion level of the two-stream detector,
//   tok  = [pool8x8(rgb) ; pool8x8(ir)]            (128 tokens per image)
//   tok  = conv2(sigmoid(conv1(tok))) * tok        (optional pattern gate)
//   tok  = tok + pos_emb
//   tok  = L pre-LN transformer layers (tok)       (K1's layers)
//   z    = ln_f(tok)
//   out  = stream + bilinear_up(z)                 (both streams: the Add2s)
// on rgb, ir (B, H, W, C) bf16, NHWC; any H, W >= 1; C as K1 takes it.
//
// Replaces the TPU kernel mmidet_tpu/nn/fusion_pallas.py:fused_gpt_merge.
// Its two grid variants (resident and per-layer streamed weights) exist for
// the TPU's on-chip memory and do not carry over: one design serves
// d = 128..1024.
//
// Design.  One C entry point that launches, on the caller's stream,
//   (a) pool_kernel: one block per (image, stream, grid cell), a thread per
//       channel pair walks the cell's adaptive window (torch's
//       start = floor(i n / 8), end = ceil((i + 1) n / 8)) and writes the
//       token; then gate_pos_kernel, one warp per token, applies the two
//       1x1 products of the pattern gate (hand-written dot products: 8 mask
//       channels) and adds pos_emb;
//   (b) the layer stack of token_transformer.cuh, in place on the tokens;
//   (c) the shared LayerNorm kernel for ln_f, then merge_kernel: a thread
//       per 8 channels of one output pixel reads the stream once more,
//       interpolates the four neighbouring tokens (half-pixel centres,
//       clamped; rows first, then columns, in f32) and writes the merged
//       stream.
// The streams are read twice and written once; the pooled maps, the
// upsampled maps and the Add2 sums never exist in device memory.
//
// Rounding points, those of the Pallas kernel, which the plain PyTorch
// version (nn/fusion_cuda.py) repeats: window row sums, their means, the
// column sums of those and their means are each rounded to bf16 (sums
// accumulate in f32); the gate's mask and the gated token are bf16; the
// pos_emb sum is bf16; the layers round as K1; ln_f's output is bf16; the
// interpolation is f32 on bf16 tokens, rounded to bf16 once; the sum into
// the stream is rounded to bf16.  The interpolation uses __fmul_rn /
// __fadd_rn so that no FMA contraction separates it from the plain version.
//
// What bounds the function on the H100 (chip_smoke.py works it out): each
// stream read once and written once, the weights read once, and K1's
// operations.  At the flagship's P2 level (B = 16, 160x160x128) the bytes
// decide: 419 MB, 0.127 ms; at P4 and P5 the transformer's operations, as
// K1.  This design reads the streams a second time in merge_kernel (half
// as many bytes again at P2) and makes 5 + 7 L launches: both are overhead
// above that bound.

#include "token_transformer.cuh"

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// torch AdaptiveAvgPool1d window of output index i over n inputs
__device__ __forceinline__ void pool_window(int i, int n, int* start,
                                            int* len) {
  *start = (i * n) / 8;
  *len = ((i + 1) * n + 7) / 8 - *start;
}

// grid (64, 2B): cell = blockIdx.x (row-major 8x8), blockIdx.y = 2b + stream
__global__ void pool_kernel(const bf16* __restrict__ rgb,
                            const bf16* __restrict__ ir,
                            bf16* __restrict__ tok, int H, int W, int C) {
  const int cell = blockIdx.x, b = blockIdx.y >> 1, s = blockIdx.y & 1;
  int hs, hl, wst, wl;
  pool_window(cell >> 3, H, &hs, &hl);
  pool_window(cell & 7, W, &wst, &wl);
  const bf16* x = (s ? ir : rgb) + (size_t)b * H * W * C;
  bf16* out = tok + ((size_t)b * kTok + s * 64 + cell) * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    float cs0 = 0.f, cs1 = 0.f;
    for (int w = wst; w < wst + wl; ++w) {
      float rs0 = 0.f, rs1 = 0.f;
      const bf16* col = x + ((size_t)hs * W + w) * C + c;
      for (int h = 0; h < hl; ++h) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(col + (size_t)h * W * C));
        rs0 += v.x;
        rs1 += v.y;
      }
      cs0 += bf16r(bf16r(rs0) / (float)hl);
      cs1 += bf16r(bf16r(rs1) / (float)hl);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
        bf16r(cs0) / (float)wl, bf16r(cs1) / (float)wl);
  }
}

// One warp per token row, in place: the optional pattern gate
// tok <- bf16((bf16(sigmoid(tok @ g1)) @ g2) * tok), then
// tok <- bf16(tok + pos).  g1 (C, 8), g2 (8, C) bf16; pos (128, C) f32.
__global__ void gate_pos_kernel(bf16* __restrict__ tok,
                                const bf16* __restrict__ g1,
                                const bf16* __restrict__ g2,
                                const float* __restrict__ pos, int M, int C,
                                int gated) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  bf16* t = tok + (size_t)row * C;
  const float* p = pos + (size_t)(row % kTok) * C;
  float m[8];
  if (gated) {
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = __bfloat162float(t[c]);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[k] = fmaf(x, __bfloat162float(g1[c * 8 + k]), m[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      m[k] = bf16r(1.f / (1.f + expf(-warp_sum(m[k]))));
  }
  for (int c = lane; c < C; c += 32) {
    float x = __bfloat162float(t[c]);
    if (gated) {
      float gv = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        gv = fmaf(m[k], __bfloat162float(g2[(size_t)k * C + c]), gv);
      x = bf16r(gv * x);
    }
    t[c] = __float2bfloat16(x + p[c]);
  }
}

// source pair and weight of output index i: half-pixel centres, clamped
__device__ __forceinline__ void bilinear_src(int i, float scale, int* lo,
                                             int* hi, float* wv) {
  float src = __fsub_rn(__fmul_rn((float)i + 0.5f, scale), 0.5f);
  src = fminf(fmaxf(src, 0.f), 7.f);
  *lo = (int)floorf(src);
  *hi = min(*lo + 1, 7);
  *wv = src - (float)*lo;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// out = bf16(stream + bf16(up(z))): a thread per 8 channels of one pixel.
// z (B, 128, C) bf16, ln_f applied.  sh = 8 / H, sw = 8 / W as f32.
__global__ void merge_kernel(const bf16* __restrict__ rgb,
                             const bf16* __restrict__ ir,
                             const bf16* __restrict__ z,
                             bf16* __restrict__ rgb_out,
                             bf16* __restrict__ ir_out, int B, int H, int W,
                             int C, float sh, float sw) {
  const int c8n = C >> 3;
  const size_t per_stream = (size_t)B * H * W * c8n;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < 2 * per_stream; idx += (size_t)gridDim.x * blockDim.x) {
    const int s = idx >= per_stream;
    const size_t i = idx - (s ? per_stream : 0);
    const int c = (int)(i % c8n) * 8;
    const size_t pix = i / c8n;
    const int w = (int)(pix % W), h = (int)((pix / W) % H);
    const int b = (int)(pix / ((size_t)W * H));
    int hlo, hhi, wlo, whi;
    float wh, ww;
    bilinear_src(h, sh, &hlo, &hhi, &wh);
    bilinear_src(w, sw, &wlo, &whi, &ww);
    const bf16* zb = z + ((size_t)b * kTok + s * 64) * C + c;
    const uint4 q00 = *reinterpret_cast<const uint4*>(zb + (hlo * 8 + wlo) * C);
    const uint4 q10 = *reinterpret_cast<const uint4*>(zb + (hhi * 8 + wlo) * C);
    const uint4 q01 = *reinterpret_cast<const uint4*>(zb + (hlo * 8 + whi) * C);
    const uint4 q11 = *reinterpret_cast<const uint4*>(zb + (hhi * 8 + whi) * C);
    const size_t off = pix * C + c;
    const uint4 xv = *reinterpret_cast<const uint4*>((s ? ir : rgb) + off);
    const __nv_bfloat162* z00 = reinterpret_cast<const __nv_bfloat162*>(&q00);
    const __nv_bfloat162* z10 = reinterpret_cast<const __nv_bfloat162*>(&q10);
    const __nv_bfloat162* z01 = reinterpret_cast<const __nv_bfloat162*>(&q01);
    const __nv_bfloat162* z11 = reinterpret_cast<const __nv_bfloat162*>(&q11);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    uint4 ov;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a00 = __bfloat1622float2(z00[k]);
      const float2 a10 = __bfloat1622float2(z10[k]);
      const float2 a01 = __bfloat1622float2(z01[k]);
      const float2 a11 = __bfloat1622float2(z11[k]);
      const float2 x = __bfloat1622float2(xp[k]);
      // rows first, then columns
      const float ux = lerp_rn(lerp_rn(a00.x, a10.x, wh),
                               lerp_rn(a01.x, a11.x, wh), ww);
      const float uy = lerp_rn(lerp_rn(a00.y, a10.y, wh),
                               lerp_rn(a01.y, a11.y, wh), ww);
      op[k] = __floats2bfloat162_rn(x.x + bf16r(ux), x.y + bf16r(uy));
    }
    *reinterpret_cast<uint4*>((s ? ir_out : rgb_out) + off) = ov;
  }
}

}  // namespace

extern "C" {

// rgb, ir, rgb_out, ir_out: (B, H, W, C) bf16 contiguous.  pos (128, C)
// f32; g1 (C, 8), g2 (8, C) bf16 (read only when gated); lnf_s, lnf_b (C,)
// f32; the layer stacks and the scratch y, qkv, ctx, hdn as tt_run_layers
// takes them; tok (B, 128, C) bf16 scratch.  C % 8 == 0, C / heads at most
// 128, 2B at most 65535.  Returns the first CUDA error, or 0.
int gpt_merge_forward(const void* rgb, const void* ir, void* rgb_out,
                      void* ir_out, const void* pos, const void* g1,
                      const void* g2, const void* lnf_s, const void* lnf_b,
                      const void* ln1s, const void* ln1b, const void* wqkv,
                      const void* bqkv, const void* wo, const void* bo,
                      const void* ln2s, const void* ln2b, const void* w1,
                      const void* b1, const void* w2, const void* b2,
                      void* tok, void* y, void* qkv, void* ctx, void* hdn,
                      int B, int H, int W, int C, int L, int heads, int gated,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * kTok;
  bf16* t = (bf16*)tok;
  int pool_threads = ((C / 2 + 31) / 32) * 32;
  if (pool_threads > 256) pool_threads = 256;
  pool_kernel<<<dim3(64, 2 * B), pool_threads, 0, st>>>(
      (const bf16*)rgb, (const bf16*)ir, t, H, W, C);
  TT_CHECK(cudaGetLastError());
  const int row_blocks = (M * 32 + 255) / 256;
  gate_pos_kernel<<<row_blocks, 256, 0, st>>>(
      t, (const bf16*)g1, (const bf16*)g2, (const float*)pos, M, C, gated);
  TT_CHECK(cudaGetLastError());
  TT_CHECK((cudaError_t)tt_run_layers(t, ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s,
                                      ln2b, w1, b1, w2, b2, y, qkv, ctx, hdn,
                                      B, C, L, heads, st));
  layernorm_kernel<<<row_blocks, 256, 0, st>>>(
      t, (const float*)lnf_s, (const float*)lnf_b, (bf16*)y, M, C, 1e-5f);
  TT_CHECK(cudaGetLastError());
  const size_t items = (size_t)2 * B * H * W * (C / 8);
  size_t blocks = (items + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  merge_kernel<<<(int)blocks, 256, 0, st>>>(
      (const bf16*)rgb, (const bf16*)ir, (const bf16*)y, (bf16*)rgb_out,
      (bf16*)ir_out, B, H, W, C, (float)(8.0 / H), (float)(8.0 / W));
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
