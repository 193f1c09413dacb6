// A stage's conv chain per image: 3x3 SAME conv C -> C, SiLU, bf16, a
// second 3x3 SAME conv C -> C, SiLU, bf16 out; the intermediate map never
// leaves shared memory.
//
// Replaces the TPU kernel tools/_probe_igemm.py:make_chain_kernel (its
// pl.pallas_call, driven by pallas_chain) and computes that probe's
// xla_chain: NHWC bf16 activations, HWIO weights without bias, bf16
// operands with f32 sums, SiLU in f32, rounded to bf16 after each conv;
// SAME zero padding of the input and of the intermediate map.
//
// What bounds it on the H100: operations.  A conv at C = 64 is 2 * 9 * 64
// = 1152 FLOP per output value against 4 bytes of activations in and out,
// far above the card's 295 FLOP per byte.  The design:
//   * one block per 16 x 16 output tile: the (16 + 4)^2 input tile with its
//     two-pixel halo goes to shared memory by cp.async (zero outside the
//     image), conv1 recomputes its one-pixel halo, an 18 x 18 intermediate
//     tile (1.27x the tile's own work), kept in shared memory in bf16 with
//     the pixels outside the image zeroed, then conv2 reads it;
//   * both convs are implicit GEMMs on the tensor cores (mma.sync m16n8k16,
//     bf16 -> f32): M the tile's pixels, N 64 output channels per pass, K
//     9 taps x C input channels.  ldmatrix gathers the A rows of a tap (the
//     pixels shifted by dy, dx) from any pixel address, so the shift costs
//     nothing; pixel rows are stored with their 16-byte chunks XOR-swizzled
//     by the pixel's low three bits, so eight pixels' chunks fall in eight
//     bank groups;
//   * the weights stream tap by tap: one tap's C x 64 slab (8 KB at C = 64,
//     16 KB at 128; a whole conv at C = 128 is 288 KB, more than a block
//     has) is double-buffered by cp.async, the next tap loading while this
//     one multiplies;
//   * 16 warps: warp w owns 32 of the pass's 64 output channels and m-tiles
//     w / 2, + 8, + 16 of the tile's pixels, its sums in registers across
//     the nine taps.
// Shared memory: 109 KB at C = 64, 213 KB at C = 128; one block per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kT = 16;            // output tile: kT x kT pixels
constexpr int kMid = kT + 2;      // the intermediate tile's side
constexpr int kIn = kT + 4;       // the input tile's side
constexpr int kThreads = 512;     // 16 warps
constexpr int kN = 64;            // output channels per pass
constexpr int kM1 = kMid * kMid;  // conv1's pixels: 324, 21 m-tiles
constexpr int kM2 = kT * kT;      // conv2's pixels: 256, 16 m-tiles

template <int C>
constexpr size_t smem_bytes() {
  return (size_t)2 * C * (kIn * kIn + kM1) + (size_t)2 * 2 * kN * C;
}

// byte offset of 16-byte chunk j of row p (a pixel, or an output channel's
// weights) in a tile of rows of C bf16 values
template <int C>
__device__ __forceinline__ uint32_t swz(int p, int j) {
  return (uint32_t)(p * C * 2 + ((j ^ (p & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + __expf(-v));
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layouts (mma.sync, per lane: g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k + 8),
//            a3 (row g+8, k + 8);  B 16x8: b0 (k 2t..2t+1, col g), b1 (k+8)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// A rows are pixels, B columns output channels; the weights are stored
// [co][ci], so a plain ldmatrix of four 8x8 blocks gives two B fragments.

// One tap of one pass: acc[i][j] += A(m-tile mg + 8 i, shifted by dy, dx)
// x W_tap(channels n0 + 8 j ..).  kSW: the source tile's width; kDW, kM:
// the destination's width and pixel count.
template <int C, int kSW, int kDW, int kM, int kNT>
__device__ __forceinline__ void tap_mma(float (&acc)[3][4][4], uint32_t src,
                                        uint32_t wbuf, int tap, int mg,
                                        int ng, int lane) {
  constexpr int kMT = (kM + 15) / 16;
  const int dy = tap / 3, dx = tap % 3;
  int pix[kNT];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    int m = (mg + 8 * i) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    m = min(m, kM - 1);  // rows past the tile: any pixel, never stored
    pix[i] = (m / kDW + dy) * kSW + m % kDW + dx;
  }
  const int ahi = lane >> 4;                              // A: k + 8
  const int brow = ng * 32 + (lane & 7) + 8 * (lane >> 4);  // B: co
  const int bhi = (lane >> 3) & 1;                        // B: k + 8
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t b[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t r[4];
      ldsm_x4(r, wbuf + swz<C>(brow + 16 * jp, 2 * kk + bhi));
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      if (mg + 8 * i >= kMT) continue;  // warp-uniform
      uint32_t a[4];
      ldsm_x4(a, src + swz<C>(pix[i], 2 * kk + ahi));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
conv_chain_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ w1,
                  const uint16_t* __restrict__ w2, uint16_t* __restrict__ out,
                  int H, int W) {
  constexpr int kPasses = C / kN;
  constexpr int kStages = 2 * kPasses * 9;
  constexpr int kChunks = C / 8;  // 16-byte chunks per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t xs = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ms = xs + 2 * C * kIn * kIn;
  const uint32_t wsm = ms + 2 * C * kM1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ng = warp & 1, mg = warp >> 1;
  const int ty0 = blockIdx.y * kT, tx0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.z * H * W;

  // the input tile, zero outside the image
  for (int q = tid; q < kIn * kIn * kChunks; q += kThreads) {
    const int p = q / kChunks, j = q % kChunks;
    const int gy = ty0 - 2 + p / kIn, gx = tx0 - 2 + p % kIn;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const uint16_t* src =
        in ? x + (img + (size_t)gy * W + gx) * C + 8 * j : x;
    cp_async16(xs + swz<C>(p, j), src, in);
  }
  // stage s's weights: conv s / (9 kPasses), output channels of pass
  // (s / 9) % kPasses, tap s % 9; global layout [tap][co][ci]
  auto load_stage = [&](int s) {
    const uint16_t* w = s < 9 * kPasses ? w1 : w2;
    const uint16_t* slab =
        w + ((size_t)(s % 9) * C + ((s / 9) % kPasses) * kN) * C;
    const uint32_t buf = wsm + (s & 1) * 2 * kN * C;
    for (int q = tid; q < kN * kChunks; q += kThreads) {
      const int row = q / kChunks, j = q % kChunks;
      cp_async16(buf + swz<C>(row, j), slab + row * C + 8 * j, true);
    }
    cp_async_commit();
  };
  load_stage(0);

  float acc[3][4][4];
  for (int s = 0; s < kStages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + 1 < kStages) load_stage(s + 1);
    const int tap = s % 9, pass = (s / 9) % kPasses;
    const bool first = s < 9 * kPasses;
    if (tap == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const uint32_t wbuf = wsm + (s & 1) * 2 * kN * C;
    if (first)
      tap_mma<C, kIn, kMid, kM1, 3>(acc, xs, wbuf, tap, mg, ng, lane);
    else
      tap_mma<C, kMid, kT, kM2, 2>(acc, ms, wbuf, tap, mg, ng, lane);
    if (tap != 8) continue;

    // the pass's epilogue: SiLU in f32, bf16; conv1 into the intermediate
    // tile (zero outside the image), conv2 to the output
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int mt = mg + 8 * i;
      if (first ? mt >= (kM1 + 15) / 16 : (i >= 2 || mt >= kM2 / 16)) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = pass * kN + ng * 32 + 8 * j + 2 * t4;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (first) {
            if (m >= kM1) continue;
            const int gy = ty0 - 1 + m / kMid, gx = tx0 - 1 + m % kMid;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const uint32_t v = in ? pack2f(silu(v0), silu(v1)) : 0u;
            const uint32_t a = ms + swz<C>(m, co >> 3) + 2 * (co & 7);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v)
                         : "memory");
          } else {
            const int gy = ty0 + m / kT, gx = tx0 + m % kT;
            if (gy < H && gx < W)
              *reinterpret_cast<uint32_t*>(
                  out + (img + (size_t)gy * W + gx) * C + co) =
                  pack2f(silu(v0), silu(v1));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x, out: (B, H, W, C) bf16, contiguous, 16-byte aligned; w1, w2: (9, C, C)
// bf16 as [tap = 3 dy + dx][co][ci] (the HWIO weights, each tap
// transposed).  C is 64 or 128; B at most 65535.  Returns the first CUDA
// error, or 0.
int conv_chain_forward(const void* x, const void* w1, const void* w2,
                       void* out, int B, int H, int W, int C, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (C != 64 && C != 128))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, B);
  cudaStream_t st = (cudaStream_t)stream;
  static unsigned sized[2];  // per C: devices whose limit is raised
  cudaError_t e;
  if (C == 64) {
    e = allow_smem(conv_chain_kernel<64>, smem_bytes<64>(), sized[0]);
    if (e != cudaSuccess) return (int)e;
    conv_chain_kernel<64><<<grid, kThreads, smem_bytes<64>(), st>>>(
        (const uint16_t*)x, (const uint16_t*)w1, (const uint16_t*)w2,
        (uint16_t*)out, H, W);
  } else {
    e = allow_smem(conv_chain_kernel<128>, smem_bytes<128>(), sized[1]);
    if (e != cudaSuccess) return (int)e;
    conv_chain_kernel<128><<<grid, kThreads, smem_bytes<128>(), st>>>(
        (const uint16_t*)x, (const uint16_t*)w1, (const uint16_t*)w2,
        (uint16_t*)out, H, W);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
