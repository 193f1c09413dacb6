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
// Design.  One launch, one pass: x is read once and out written once; the
// 24-channel intermediates live in shared memory only.  A block of 256
// threads owns a 16x32 output tile and holds
//   * the input tile with a 3-pixel halo as f32 (out needs y+e at +-1, e
//     needs sum_c y at a further +-1, y needs x at a further +-1),
//   * sum_c y over the tile + 2,
//   * y, then y+e in place, over the tile + 1, pixel-major with the 24
//     channels contiguous (a 48-byte pixel pitch in bf16, which 16-byte
//     loads of neighbouring threads cover without bank conflicts),
//   * all weights (1660 floats).
// Three passes over the tile, a barrier between them, each a direct
// convolution on the CUDA cores with the pixel's inputs in registers and the
// weights read from shared memory as broadcast 16-byte loads.
//
// Zero padding follows the convolutions being replaced: outside the IMAGE
// y is 0 (not leaky(b2)) and y+e is 0 (not bias_s), so borders are masked
// by image coordinates, never by tile coordinates.
//
// Rounding points (T = bf16; with T = float nothing is rounded), those of
// the Pallas kernel, which the plain PyTorch version (nn/cem_cuda.py)
// repeats: w2, bank*factor and w3 arrive already rounded to bf16 (as f32
// values); every sum is f32; y, sum_c y, y+e, z and z+x are each rounded to
// bf16.
//
// What bounds the function on the H100 (chip_smoke.py works it out): per
// output pixel 2835 FLOP (conv2 1296, channel sum 24, bank 144, scale and
// bias 48, y+e 24, conv3 1296, residual 3) on 12 bytes in bf16.  At B = 16,
// 640x640 the bytes take 0.023 ms and decide; the operations take 0.019 ms
// at the card's rate for bf16 operands (in the f32 form 0.277 ms at the f32
// rate, and they decide).  This design stands well above that bound by its
// own choices: it runs every product on the CUDA cores in f32, recomputes
// conv2 over the halo (x 1.41) and the bank over its halo (x 1.2), and
// re-reads the weights from shared memory for every pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTH = 16, kTW = 32;      // output tile
constexpr int kE = 24;                 // expanded channels
constexpr int kXW = kTW + 6, kXH = kTH + 6;  // x tile
constexpr int kSW = kTW + 4, kSH = kTH + 4;  // sum_c y region
constexpr int kYW = kTW + 2, kYH = kTH + 2;  // y / y+e region
constexpr int kThreads = 256;
// packed weights (floats): w2 [24][28] (27 taps in (ky, kx, c) order + pad),
// wb [24][12] (9 taps of bank*factor + pad), w3 [9][24][3], b2 [24],
// bias_s [24], b3 [4]
constexpr int kOffW2 = 0, kOffWB = 672, kOffW3 = 960, kOffB2 = 1608,
              kOffBS = 1632, kOffB3 = 1656, kPack = 1660;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.1f * v;
}

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive channels of one pixel, to and from shared memory
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
struct CemSmem {
  static constexpr size_t kBytes =
      sizeof(float) * (kPack + kXH * kXW * 3 + kSH * kSW) +
      sizeof(T) * kYH * kYW * kE;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cem_kernel(const T* __restrict__ x, const float* __restrict__ wpack,
           T* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);       // kPack
  float* xs = ws + kPack;                            // [kXH][kXW][3]
  float* ss = xs + kXH * kXW * 3;                    // [kSH][kSW]
  T* ys = reinterpret_cast<T*>(ss + kSH * kSW);      // [kYH][kYW][24]

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
  const T* xi = x + (size_t)img * H * W * 3;
  T* oi = out + (size_t)img * H * W * 3;

  for (int i = tid; i < kPack; i += kThreads) ws[i] = wpack[i];
  // input tile with its 3-pixel halo, zero outside the image
  for (int i = tid; i < kXH * kXW * 3; i += kThreads) {
    const int r = i / (kXW * 3), rem = i % (kXW * 3);
    const int gy = ty0 - 3 + r, gx = tx0 - 3 + rem / 3;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f<T>(xi[((size_t)gy * W + gx) * 3 + rem % 3]);
    xs[i] = v;
  }
  __syncthreads();

  // pass 1: y = leaky(conv2(x) + b2) over the tile + 2; its channel sum to
  // ss, and y itself over the tile + 1 to ys
  for (int p = tid; p < kSH * kSW; p += kThreads) {
    const int r = p / kSW, c = p % kSW;
    const int gy = ty0 - 2 + r, gx = tx0 - 2 + c;
    const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bool keep = r >= 1 && r <= kYH && c >= 1 && c <= kYW;
    float xv[28];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        xv[ky * 9 + k] = xs[((r + ky) * kXW + c) * 3 + k];
    xv[27] = 0.f;
    float sum = 0.f;
    T* yp = keep ? ys + ((r - 1) * kYW + (c - 1)) * kE : ys;
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
        const float v =
            in_img ? rnd<T>(leaky(acc + ws[kOffB2 + ch])) : 0.f;
        yv[j] = v;
        sum += v;
      }
      if (keep) store8(yp + g * 8, yv);
    }
    ss[p] = rnd<T>(sum);
  }
  __syncthreads();

  // pass 2: y + e in place over the tile + 1, zero outside the image
  for (int p = tid; p < kYH * kYW; p += kThreads) {
    const int r = p / kYW, c = p % kYW;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float sv[12];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        sv[dy * 3 + dx] = ss[(r + dy) * kSW + c + dx];
    sv[9] = sv[10] = sv[11] = 0.f;
    T* yp = ys + p * kE;
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
        yv[j] = in_img ? rnd<T>(yv[j] + e) : 0.f;
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
      const T* yp = ys + ((r + tap / 3) * kYW + c + tap % 3) * kE;
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
    const float* xc = &xs[((r + 3) * kXW + c + 3) * 3];
    T* op = oi + ((size_t)gy * W + gx) * 3;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float z = rnd<T>(leaky(acc[o] + ws[kOffB3 + o]));
      op[o] = from_f<T>(z + xc[o]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wpack, void* out, int B, int H,
                   int W, cudaStream_t st) {
  const size_t smem = CemSmem<T>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      cem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  cem_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)x, (const float*)wpack, (T*)out, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (B, H, W, 3) contiguous, bf16 (is_bf16 = 1) or f32.  wpack: 1660
// floats as laid out above (nn/cem_cuda.py:pack_cem_weights).  B at most
// 65535 (grid z).  Returns the first CUDA error, or 0.
int cem_forward(const void* x, const void* wpack, void* out, int B, int H,
                int W, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<bf16>(x, wpack, out, B, H, W, st)
                       : launch<float>(x, wpack, out, B, H, W, st));
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
