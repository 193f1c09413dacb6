// K3, the fused Contour Enhancement Module (BN folded, deploy form):
//   y   = leaky0.1(conv3x3_{3->24}(x) + b2)
//   e   = tile3(bank8 (*) sum_c y) * factor + bias_s      (frozen edge bank)
//   z   = leaky0.1(conv3x3_{24->3}(y + e) + b3)
//   out = z + x
// on x (B, H, W, 3), NHWC, bf16 or f32; any H, W >= 1.
//
// Replaces the TPU kernel mmidet_tpu/nn/cem_pallas.py:fused_cem.  Only the
// function carries over: the Pallas kernel's host-side im2col, its
// overlapped-patch matmuls, selector matmul and lane rolls feed a matrix
// unit and have no meaning here.
//
// Both forms make one launch and one pass: x is read once and out written
// once; the 24-channel intermediates live in shared memory only.  The
// intermediates are held over the output tile plus a halo: out needs y+e at
// +-1, e needs sum_c y at a further +-1, y needs x at a further +-1.
//
// Zero padding follows the convolutions being replaced: outside the IMAGE
// y is 0 (not leaky(b2)) and y+e is 0 (not bias_s), so borders are masked
// by image coordinates, never by tile coordinates.
//
// Rounding points (bf16 form; the f32 form rounds nothing), those of the
// Pallas kernel, which the plain PyTorch version (nn/cem_cuda.py) repeats:
// w2, bank*factor and w3 arrive already rounded to bf16 (as f32 values);
// every sum is f32; y, sum_c y, y+e, z and z+x are each rounded to bf16.
//
// What bounds the function on the H100 (chip_smoke.py works it out): per
// output pixel 2835 FLOP (conv2 1296, channel sum 24, bank 144, scale and
// bias 48, y+e 24, conv3 1296, residual 3) on 12 bytes in bf16.  At B = 16,
// 640x640 the bytes take 0.023 ms and decide; the operations take 0.019 ms
// at the card's rate for bf16 operands (in the f32 form 0.277 ms at the f32
// rate, and they decide).
//
// bf16 form (cem_kernel_mma), designed for that bound:
//   * conv2 and conv3 are implicit GEMMs on the tensor cores
//     (mma.sync m16n8k16 / m16n8k8, bf16 operands, f32 sums).  conv2:
//     M = pixels of the tile + 2, N = 24, K = 27 taps in (ky, kx, c) order
//     padded to 32; its A fragments are gathered from the input tile.  Its
//     C fragments, biased, activated and rounded, are the A fragments of a
//     product with ones that gives sum_c y, and go to the y tile by
//     stmatrix.
//     conv3: M = output pixels, N = 3 padded to 8, K = 9 taps x 24 channels
//     as a 16-deep and an 8-deep step per tap; its A fragments come from
//     the y + e tile by ldmatrix, whose 48-byte pixel pitch puts the eight
//     16-byte rows of a matrix on distinct banks.  Both weight matrices are
//     read once per block into B fragments held in registers.
//   * The bank (1 -> 24 channels, 9 taps, on the channel sum) is a third
//     implicit GEMM (M = pixels, K = 9 taps padded to 16, N = 24).  Both of
//     its operands are bf16 values already (sum_c y and bank*factor are
//     rounding points), so the tensor cores form the same products and
//     sum them in f32; y arrives by ldmatrix and y + e leaves by stmatrix
//     in the C fragments' layout.  On the CUDA cores (216 FMA a pixel) the
//     bank was a third of the kernel's instructions.  The elementwise work
//     (biases, leaky ReLUs, y + e, the residual, the rounding) stays on the
//     CUDA cores in f32.
//   * A 40x32 output tile (conv2 over 44x36: 1.24x the tile, the bank over
//     42x34: 1.12x) in 90 KB of shared memory, two blocks per SM.
//   * The input tile's rows arrive as 16-byte loads, one warp per row, all
//     of a lane's rows in flight at once, and the output leaves through a
//     staging tile as 16-byte stores.  Tiles whose halo lies inside the
//     image (most of them) run a copy of the code without border masks.
// f32 form (cem_kernel_f32): a direct convolution on the CUDA cores with
// the weights in shared memory over a 16x32 tile; 0 launches on the main
// path, which runs in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kE = 24;  // expanded channels
// packed weights (floats): w2 [24][28] (27 taps in (ky, kx, c) order + pad),
// wb [24][12] (9 taps of bank*factor + pad), w3 [9][24][3], b2 [24],
// bias_s [24], b3 [4]
constexpr int kOffW2 = 0, kOffWB = 672, kOffW3 = 960, kOffB2 = 1608,
              kOffBS = 1632, kOffB3 = 1656, kPack = 1660;

// v >= 0 ? v : 0.1 v for every v but NaN, in two instructions
__device__ __forceinline__ float leaky(float v) {
  return fmaxf(v, 0.1f * v);
}

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------- bf16 form
constexpr int kMH = 40, kMW = 32;               // output tile
constexpr int kMThreads = 384, kMWarps = kMThreads / 32;
constexpr int kXH = kMH + 6, kXW = kMW + 6;     // x tile (pixels)
constexpr int kXP = 120;                        // x row pitch >= 3 kXW
constexpr int kSH = kMH + 4, kSW = kMW + 4;     // conv2 region: sum_c y
constexpr int kYH = kMH + 2, kYW = kMW + 2;     // y, then y+e in place
constexpr int kS2 = kSH * kSW;                  // conv2 pixels
constexpr size_t kMmaSmem = sizeof(bf16) * (kYH * kYW + 1) * kE  // ys, junk
                            + sizeof(uint16_t) * kXH * kXP  // xs
                            + sizeof(uint16_t) * kS2        // ss
                            + sizeof(uint16_t) * kMH * kMW * 3;  // os

// Phases of cem_tile to leave out, a bit each: 1 the input tile, 2 conv2,
// 4 the bank, 8 conv3, 16 the store.  0 in the port's build; chip_profile.py
// builds copies with -DCEM_SKIP_PHASES=<mask> to time the phases one by one
// (their output is wrong whenever a bit is set).
#ifndef CEM_SKIP_PHASES
#define CEM_SKIP_PHASES 0
#endif
constexpr int kSkip = CEM_SKIP_PHASES;

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void stsm_x4(void* p, uint32_t r0, uint32_t r1,
                                        uint32_t r2, uint32_t r3) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
      :
      : "r"(a), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void stsm_x2(void* p, uint32_t r0, uint32_t r1) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1,%2};\n"
               :
               : "r"(a), "r"(r0), "r"(r1)
               : "memory");
}
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0

// Fragment layouts (mma.sync, per lane: g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g,
//            k 2t+8..2t+9), a3 (row g+8, k 2t+8..2t+9);  A 16x8: a0, a1
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);  B 8x8: b0
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// Two values of one register: the lower k (or column) in the low half.
// ldmatrix and stmatrix move the 8x8 blocks of a C (or A) fragment to and
// from the pixel-major tiles: a block's rows are 8 pixels, its columns 8
// channels (16 bytes), each lane holding row g, columns 2t and 2t+1.  Lane
// i addresses pixel (i % 8) + 8 ((i / 8) % 2) of the 16 at channel
// 8 (i / 16) (x4; x2 reads lanes 0-15's addresses).

// value q (0..7) of 8 bf16 in a 16-byte register group
__device__ __forceinline__ uint16_t part(const uint4& v, int q) {
  const uint32_t w = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return (uint16_t)(w >> (16 * (q & 1)));
}

// One output tile.  kEdge: the tile's halo reaches past the image, so
// values outside it are masked to zero; inner tiles (most of a 640x640
// image) skip every mask.
template <bool kEdge>
__device__ __forceinline__ void cem_tile(const uint16_t* __restrict__ x,
                                         const float* __restrict__ wpack,
                                         uint16_t* __restrict__ out, int H,
                                         int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                // [kYH*kYW][24]
  bf16* junk = ys + kYH * kYW * kE;  // one pixel: stmatrix rows to drop
  uint16_t* xs = reinterpret_cast<uint16_t*>(junk + kE);   // [kXH][kXP]
  uint16_t* ss = xs + kXH * kXP;                           // [kSH][kSW]
  uint16_t* os = ss + kS2;                                 // [kMH][kMW*3]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix/stmatrix
  const int mch = 8 * (lane >> 4);
  const int ty0 = blockIdx.y * kMH, tx0 = blockIdx.x * kMW;
  const long long img0 = (long long)blockIdx.z * H * W * 3;
  const uint16_t* xend = x + (long long)gridDim.z * H * W * 3;

  // 0. the input tile with its 3-pixel halo, a warp per row: the row's
  // image span as aligned 16-byte loads (scalar at the tensor's end), all
  // of a lane's loads in flight at once; zero outside the image
  if (!(kSkip & 1)) {
    constexpr int kRows = (kXH + kMWarps - 1) / kMWarps;
    const int first = (tx0 - 3) * 3;  // the tile row's first value
    const int lo = max(tx0 - 3, 0) * 3, hi = min(tx0 + kMW + 3, W) * 3;
    uint4 v[kRows];
    int cs[kRows];  // the lane's chunk: its first value in the image row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + i * kMWarps, gy = ty0 - 3 + r;
      cs[i] = hi;  // none
      if (r < kXH && gy >= 0 && gy < H) {
        const uint16_t* rp = x + img0 + (long long)gy * W * 3;
        const int s =
            lo - (int)(((uintptr_t)(rp + lo) >> 1) & 7) + 8 * lane;
        if (s < hi) {
          cs[i] = s;
          if (rp + s + 8 <= xend) {
            v[i] = *reinterpret_cast<const uint4*>(rp + s);
          } else {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[q] = pack2(s + 2 * q < hi ? rp[s + 2 * q] : 0,
                           s + 2 * q + 1 < hi ? rp[s + 2 * q + 1] : 0);
            v[i] = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + i * kMWarps, gy = ty0 - 3 + r;
      if (r >= kXH) break;
      uint16_t* row = xs + r * kXP;
      if (kEdge) {
        const bool row_in = gy >= 0 && gy < H;
        for (int e = lane; e < kXW * 3; e += 32) {
          const int gx = tx0 - 3 + e / 3;
          if (!row_in || gx < 0 || gx >= W) row[e] = 0;
        }
      }
      if (cs[i] < hi) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int e = cs[i] + q;
          if (e >= lo && e < hi) row[e - first] = part(v[i], q);
        }
      }
    }
  }
  __syncthreads();

  // 1. conv2 on the tensor cores over the tile + 2: y = leaky(. + b2),
  // zero outside the image, rounded; sum_c y to ss, y over the tile + 1 to ys
  if (!(kSkip & 2)) {
    uint32_t bw[2][3][2];  // [k step][n tile][b0, b1]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * s + 2 * t4 + 8 * h, n = 8 * j + g;
          const float w0 = k < 27 ? __ldg(wpack + kOffW2 + n * 28 + k) : 0.f;
          const float w1 =
              k + 1 < 27 ? __ldg(wpack + kOffW2 + n * 28 + k + 1) : 0.f;
          bw[s][j][h] = pack2f(w0, w1);
        }
    // this lane's k -> offset in the x tile: row ky = k / 9, element k % 9
    // from the pixel's first (k >= 27 meets a zero weight: any value will do)
    int ko[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * s + 2 * t4 + (i & 1) + 8 * (i >> 1);
        ko[s][i] = k < 27 ? (k / 9) * kXP + k % 9 : 0;
      }
    float b2v[3][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        b2v[j][u] = __ldg(wpack + kOffB2 + 8 * j + 2 * t4 + u);

    for (int mt = warp; mt * 16 < kS2; mt += kMWarps) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(mt * 16 + g + 8 * h, kS2 - 1);
        base[h] = (q / kSW) * kXP + (q % kSW) * 3;
      }
      float acc[3][4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = base[i & 1];
          a[i] = pack2(xs[p + ko[s][(i >> 1) * 2]],
                       xs[p + ko[s][(i >> 1) * 2 + 1]]);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) mma16816(acc[j], a, bw[s][j][0], bw[s][j][1]);
      }
      uint32_t y2[3][2];  // y rounded, C layout: [n tile][pixel g, g + 8]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + g + 8 * h;
        const int r = q / kSW, c = q % kSW;
        const bool in_img = !kEdge || (ty0 - 2 + r >= 0 && ty0 - 2 + r < H &&
                                       tx0 - 2 + c >= 0 && tx0 - 2 + c < W);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          y2[j][h] = in_img ? pack2f(leaky(acc[j][2 * h] + b2v[j][0]),
                                     leaky(acc[j][2 * h + 1] + b2v[j][1]))
                            : 0u;
      }
      // sum_c y: the C fragments of y are the A fragments of a product with
      // ones (channels 0-15, then 16-23), summed in f32
      float sum[4] = {};
      const uint32_t ya[4] = {y2[0][0], y2[0][1], y2[1][0], y2[1][1]};
      mma16816(sum, ya, kOnes, kOnes);
      mma1688(sum, y2[2][0], y2[2][1], kOnes);
      if (t4 == 0) {
        const int q = mt * 16 + g;
        if (q < kS2) ss[q] = __bfloat16_as_ushort(__float2bfloat16(sum[0]));
        if (q + 8 < kS2)
          ss[q + 8] = __bfloat16_as_ushort(__float2bfloat16(sum[2]));
      }
      {  // y over the tile + 1, by stmatrix; rows of the ring to junk
        const int q = mt * 16 + mrow, r = q / kSW, c = q % kSW;
        const bool keep =
            q < kS2 && r >= 1 && r <= kYH && c >= 1 && c <= kYW;
        bf16* dst = keep ? ys + ((r - 1) * kYW + c - 1) * kE : junk;
        stsm_x4(dst + mch, y2[0][0], y2[0][1], y2[1][0], y2[1][1]);
        stsm_x2(dst + 16, y2[2][0], y2[2][1]);
      }
    }
  }
  __syncthreads();

  // 2. the bank on the tensor cores over the tile + 1 (M = pixels, K = 9
  // taps of sum_c y padded to 16, N = 24), then y + e + bias_s in place on
  // the CUDA cores, zero outside the image
  if (!(kSkip & 4)) {
    uint32_t bw[3][2];  // [n tile][b0, b1]
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * t4 + 8 * h, n = 8 * j + g;
        bw[j][h] = pack2f(k < 9 ? __ldg(wpack + kOffWB + n * 12 + k) : 0.f,
                          k + 1 < 9 ? __ldg(wpack + kOffWB + n * 12 + k + 1)
                                    : 0.f);
      }
    int kb[4];  // this lane's taps -> offset in ss (k >= 9: zero weight)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 2 * t4 + (i & 1) + 8 * (i >> 1);
      kb[i] = k < 9 ? (k / 3) * kSW + k % 3 : 0;
    }
    float bsv[3][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        bsv[j][u] = __ldg(wpack + kOffBS + 8 * j + 2 * t4 + u);

    constexpr int kNY = kYH * kYW;
    for (int mt = warp; mt * 16 < kNY; mt += kMWarps) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(mt * 16 + g + 8 * h, kNY - 1);
        base[h] = (q / kYW) * kSW + q % kYW;
      }
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = pack2(ss[base[i & 1] + kb[(i >> 1) * 2]],
                     ss[base[i & 1] + kb[(i >> 1) * 2 + 1]]);
      float acc[3][4] = {};
#pragma unroll
      for (int j = 0; j < 3; ++j) mma16816(acc[j], a, bw[j][0], bw[j][1]);
      // y in C layout by ldmatrix, y + e back by stmatrix; the rows past
      // the region read its last pixel and go to junk
      const int qa = mt * 16 + mrow;
      bf16* yl = ys + min(qa, kNY - 1) * kE;
      bf16* dst = qa < kNY ? yl : junk;
      uint32_t yv[3][2];
      {
        uint32_t a4[4];
        ldsm_x4(a4, yl + mch);
        yv[0][0] = a4[0]; yv[0][1] = a4[1]; yv[1][0] = a4[2]; yv[1][1] = a4[3];
        ldsm_x2(yv[2][0], yv[2][1], yl + 16);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + g + 8 * h;
        const int gy = ty0 - 1 + q / kYW, gx = tx0 - 1 + q % kYW;
        const bool in_img =
            !kEdge || (gy >= 0 && gy < H && gx >= 0 && gx < W);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t y = yv[j][h];
          yv[j][h] = in_img ? pack2f(bf(y & 0xffffu) + (acc[j][2 * h] + bsv[j][0]),
                                     bf(y >> 16) + (acc[j][2 * h + 1] + bsv[j][1]))
                            : 0u;
        }
      }
      stsm_x4(dst + mch, yv[0][0], yv[0][1], yv[1][0], yv[1][1]);
      stsm_x2(dst + 16, yv[2][0], yv[2][1]);
    }
  }
  __syncthreads();

  // 3. conv3 on the tensor cores, two output rows at a time (the four
  // y + e rows they read are loaded once), z = leaky(. + b3), out = z + x,
  // staged
  if (!(kSkip & 8)) {
    uint32_t bw[9][3];  // per tap: channels 0-15 (b0, b1), 16-23 (b0)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int k = tap * kE + 2 * t4 + 8 * i;  // 2t, 2t + 8, 16 + 2t
        bw[tap][i] = g < 3 ? pack2f(__ldg(wpack + kOffW3 + k * 3 + g),
                                    __ldg(wpack + kOffW3 + (k + 1) * 3 + g))
                           : 0u;
      }
    float b3v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      b3v[u] = 2 * t4 + u < 3 ? __ldg(wpack + kOffB3 + 2 * t4 + u) : 0.f;
    for (int it = warp; it < (kMH / 2) * (kMW / 16); it += kMWarps) {
      const int r0 = 2 * (it / (kMW / 16)), c0 = (it % (kMW / 16)) * 16;
      float acc[2][4] = {};
#pragma unroll
      for (int yr = 0; yr < 4; ++yr)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const bf16* yp = ys + ((r0 + yr) * kYW + c0 + mrow + dx) * kE;
          uint32_t a[4], a0, a1;
          ldsm_x4(a, yp + mch);
          ldsm_x2(a0, a1, yp + 16);
          if (yr < 3) {  // output row r0, tap (yr, dx)
            const int tap = yr * 3 + dx;
            mma16816(acc[0], a, bw[tap][0], bw[tap][1]);
            mma1688(acc[0], a0, a1, bw[tap][2]);
          }
          if (yr > 0) {  // output row r0 + 1, tap (yr - 1, dx)
            const int tap = (yr - 1) * 3 + dx;
            mma16816(acc[1], a, bw[tap][0], bw[tap][1]);
            mma1688(acc[1], a0, a1, bw[tap][2]);
          }
        }
      if (t4 < 2) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int n = 2 * t4 + u, r = r0 + rr, c = c0 + g + 8 * h;
              if (n < 3) {
                const float z =
                    rnd_bf16(leaky(acc[rr][2 * h + u] + b3v[u]));
                const float xv = bf(xs[(r + 3) * kXP + (c + 3) * 3 + n]);
                os[(r * kMW + c) * 3 + n] =
                    __bfloat16_as_ushort(__float2bfloat16(z + xv));
              }
            }
      }
    }
  }
  __syncthreads();

  // 4. the staged tile out, a warp per row: 16-byte stores of the chunks
  // inside the row's image span, scalar stores at its two ends
  for (int r = warp; r < kMH && !(kSkip & 16); r += kMWarps) {
    const int gy = ty0 + r;
    if (gy >= H) continue;
    uint16_t* rp = out + img0 + (long long)gy * W * 3;
    const int lo = tx0 * 3, hi = min(tx0 + kMW, W) * 3;
    const uint16_t* orow = os + r * kMW * 3;  // value e of the row at e - lo
    for (int s = lo - (int)(((uintptr_t)(rp + lo) >> 1) & 7) + 8 * lane;
         s < hi; s += 256) {
      if (s >= lo && s + 8 <= hi) {
        const uint16_t* o = orow + (s - lo);
        *reinterpret_cast<uint4*>(rp + s) =
            make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                       pack2(o[4], o[5]), pack2(o[6], o[7]));
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (s + q >= lo && s + q < hi) rp[s + q] = orow[s + q - lo];
      }
    }
  }
}

__global__ void __launch_bounds__(kMThreads, 2)
cem_kernel_mma(const uint16_t* __restrict__ x, const float* __restrict__ wpack,
               uint16_t* __restrict__ out, int H, int W) {
  const int ty0 = blockIdx.y * kMH, tx0 = blockIdx.x * kMW;
  if (ty0 >= 3 && tx0 >= 3 && ty0 + kMH + 3 <= H && tx0 + kMW + 3 <= W)
    cem_tile<false>(x, wpack, out, H, W);
  else
    cem_tile<true>(x, wpack, out, H, W);
}

// ----------------------------------------------------------------- f32 form
constexpr int kTH = 16, kTW = 32;      // output tile
constexpr int kFXW = kTW + 6, kFXH = kTH + 6;  // x tile
constexpr int kFSW = kTW + 4, kFSH = kTH + 4;  // sum_c y region
constexpr int kFYW = kTW + 2, kFYH = kTH + 2;  // y / y+e region
constexpr int kThreads = 256;
constexpr size_t kF32Smem =
    sizeof(float) * (kPack + kFXH * kFXW * 3 + kFSH * kFSW + kFYH * kFYW * kE);

// 8 consecutive channels of one pixel, to and from shared memory
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Three passes over the tile, a barrier between them, each a direct
// convolution with the pixel's inputs in registers and the weights read
// from shared memory as broadcast 16-byte loads.
__global__ void __launch_bounds__(kThreads)
cem_kernel_f32(const float* __restrict__ x, const float* __restrict__ wpack,
               float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);       // kPack
  float* xs = ws + kPack;                            // [kFXH][kFXW][3]
  float* ss = xs + kFXH * kFXW * 3;                  // [kFSH][kFSW]
  float* ys = ss + kFSH * kFSW;                      // [kFYH][kFYW][24]

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
  const float* xi = x + (size_t)img * H * W * 3;
  float* oi = out + (size_t)img * H * W * 3;

  for (int i = tid; i < kPack; i += kThreads) ws[i] = wpack[i];
  // input tile with its 3-pixel halo, zero outside the image
  for (int i = tid; i < kFXH * kFXW * 3; i += kThreads) {
    const int r = i / (kFXW * 3), rem = i % (kFXW * 3);
    const int gy = ty0 - 3 + r, gx = tx0 - 3 + rem / 3;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xi[((size_t)gy * W + gx) * 3 + rem % 3];
    xs[i] = v;
  }
  __syncthreads();

  // pass 1: y = leaky(conv2(x) + b2) over the tile + 2; its channel sum to
  // ss, and y itself over the tile + 1 to ys
  for (int p = tid; p < kFSH * kFSW; p += kThreads) {
    const int r = p / kFSW, c = p % kFSW;
    const int gy = ty0 - 2 + r, gx = tx0 - 2 + c;
    const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bool keep = r >= 1 && r <= kFYH && c >= 1 && c <= kFYW;
    float xv[28];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        xv[ky * 9 + k] = xs[((r + ky) * kFXW + c) * 3 + k];
    xv[27] = 0.f;
    float sum = 0.f;
    float* yp = keep ? ys + ((r - 1) * kFYW + (c - 1)) * kE : ys;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float yv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = g * 8 + j;
        float acc = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < 7; ++k4) {
          const float4 w = *reinterpret_cast<const float4*>(
              &ws[kOffW2 + ch * 28 + 4 * k4]);
          acc = fmaf(xv[4 * k4], w.x, acc);
          acc = fmaf(xv[4 * k4 + 1], w.y, acc);
          acc = fmaf(xv[4 * k4 + 2], w.z, acc);
          acc = fmaf(xv[4 * k4 + 3], w.w, acc);
        }
        const float v = in_img ? leaky(acc + ws[kOffB2 + ch]) : 0.f;
        yv[j] = v;
        sum += v;
      }
      if (keep) store8(yp + g * 8, yv);
    }
    ss[p] = sum;
  }
  __syncthreads();

  // pass 2: y + e in place over the tile + 1, zero outside the image
  for (int p = tid; p < kFYH * kFYW; p += kThreads) {
    const int r = p / kFYW, c = p % kFYW;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float sv[12];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        sv[dy * 3 + dx] = ss[(r + dy) * kFSW + c + dx];
    sv[9] = sv[10] = sv[11] = 0.f;
    float* yp = ys + p * kE;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float yv[8];
      load8(yp + g * 8, yv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = g * 8 + j;
        float e = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < 3; ++k4) {
          const float4 w = *reinterpret_cast<const float4*>(
              &ws[kOffWB + ch * 12 + 4 * k4]);
          e = fmaf(sv[4 * k4], w.x, e);
          e = fmaf(sv[4 * k4 + 1], w.y, e);
          e = fmaf(sv[4 * k4 + 2], w.z, e);
          e = fmaf(sv[4 * k4 + 3], w.w, e);
        }
        e += ws[kOffBS + ch];
        yv[j] = in_img ? yv[j] + e : 0.f;
      }
      store8(yp + g * 8, yv);
    }
  }
  __syncthreads();

  // pass 3: z = leaky(conv3(y + e) + b3), out = z + x
  for (int p = tid; p < kTH * kTW; p += kThreads) {
    const int r = p / kTW, c = p % kTW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= H || gx >= W) continue;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* yp = ys + ((r + tap / 3) * kFYW + c + tap % 3) * kE;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float yv[8];
        load8(yp + g * 8, yv);
        const float* wp = &ws[kOffW3 + (tap * kE + g * 8) * 3];
#pragma unroll
        for (int q = 0; q < 6; ++q) {  // 8 channels x 3 outputs = 6 float4
          const float4 w = *reinterpret_cast<const float4*>(wp + 4 * q);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int idx = 4 * q + t, ch = idx / 3, o = idx % 3;
            if (o == 0) a0 = fmaf(yv[ch], wv[t], a0);
            if (o == 1) a1 = fmaf(yv[ch], wv[t], a1);
            if (o == 2) a2 = fmaf(yv[ch], wv[t], a2);
          }
        }
      }
    }
    const float acc[3] = {a0, a1, a2};
    const float* xc = &xs[((r + 3) * kFXW + c + 3) * 3];
    float* op = oi + ((size_t)gy * W + gx) * 3;
#pragma unroll
    for (int o = 0; o < 3; ++o)
      op[o] = leaky(acc[o] + ws[kOffB3 + o]) + xc[o];
  }
}

}  // namespace

extern "C" {

// x, out: (B, H, W, 3) contiguous, bf16 (is_bf16 = 1) or f32, 16-byte
// aligned.  wpack: 1660 floats as laid out above
// (nn/cem_cuda.py:pack_cem_weights).  B at most 65535 (grid z).  Returns
// the first CUDA error, or 0.
int cem_forward(const void* x, const void* wpack, void* out, int B, int H,
                int W, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  static unsigned sized[2];  // per form: devices whose limit is raised
  cudaError_t e;
  if (is_bf16) {
    e = allow_smem(cem_kernel_mma, kMmaSmem, sized[1]);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + kMW - 1) / kMW, (H + kMH - 1) / kMH, B);
    cem_kernel_mma<<<grid, kMThreads, kMmaSmem, st>>>(
        (const uint16_t*)x, (const float*)wpack, (uint16_t*)out, H, W);
  } else {
    e = allow_smem(cem_kernel_f32, kF32Smem, sized[0]);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    cem_kernel_f32<<<grid, kThreads, kF32Smem, st>>>(
        (const float*)x, (const float*)wpack, (float*)out, H, W);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
