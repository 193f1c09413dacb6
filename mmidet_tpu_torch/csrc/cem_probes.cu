// The CEM layout probes: what each probe body computes, as simple kernels.
//
// Replace the TPU kernels of tools/_probe_cem_r3.py (bodies _k_a to _k_d,
// launched through its _try's pl.pallas_call) and tools/_probe_cem_fb.py
// (_k_slice192, _k_slice8, _k_ones_matmul, the same way).  On the TPU they
// asked which sublane and lane slices, rolls and concatenations Mosaic
// compiles; a GPU thread addresses any element, so that question does not
// arise here, and each body keeps only its function, shapes and rounding
// points:
//   P2, halo-gather sums (bf16 in, f32 out): per output pixel the f32 sum of
//     the gathered bf16 values, rounded once to bf16, written to 8 lanes;
//       halo_concat (_k_a)  t (R+4, G+2, 8): rows 2.., t[g,7] + sum t[g+1,:]
//                           + t[g+2,0]                 -> (R+2, G, 8)
//       halo_roll   (_k_b)  t (R+4, G, 8): rows 2.., t[g-1,7] + sum t[g,:]
//                           + t[g+1,0], zero outside 0 <= g < G
//       lane_wrap   (_k_c)  y (R+2, G, 192): sum y[168:] + sum y + sum y[:24]
//       flat_gather (_k_d)  f ((R+4)(G+2), 8): sum over dy, dg < 3 of
//                           f[i + dy (G+2) + dg, 0]    -> ((R+2) G, 8)
//   P3, products (bf16 operands, f32 sums) of a lane-widened row and a
//     (K, 128) matrix:
//       slice192 (_k_slice192)  [a[:,168:], a, a[:,:24], 0^16] @ w (256, 128)
//       slice8   (_k_slice8)    [a[:,7:8], a, a[:,0:1], 0^118] @ w (128, 128)
//       ones_matmul             y (M, 192) @ s (192, 128)
// What bounds them on the H100: neither bytes (at most 1.6 MB) nor
// operations (at most 6.3 MFLOP): each is a launch or two of latency.  One
// thread per output pixel (P2) or output value (P3).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float bf(const uint16_t* p, long long i) {
  return __bfloat162float(__ushort_as_bfloat16(p[i]));
}

// the sum rounded to bf16 once, on all 8 lanes of output pixel o
__device__ __forceinline__ void store8(float* out, int o, float sum) {
  const float v = __bfloat162float(__float2bfloat16_rn(sum));
  float4* q = reinterpret_cast<float4*>(out + 8 * (long long)o);
  q[0] = q[1] = make_float4(v, v, v, v);
}

// P2: body 0 halo_concat, 1 halo_roll, 2 lane_wrap, 3 flat_gather; one
// thread per output pixel o < n
__global__ void __launch_bounds__(kThreads)
halo_sum_kernel(const uint16_t* __restrict__ t, float* __restrict__ out,
                int body, int R, int G) {
  const int n = (R + 2) * G;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  const int i = o / G, g = o % G;
  float s = 0.f;
  if (body == 0) {  // t (R+4, G+2, 8), output row i reads row i + 2
    const uint16_t* row = t + (long long)(i + 2) * (G + 2) * 8;
    s = bf(row, g * 8 + 7);
    for (int c = 0; c < 8; ++c) s += bf(row, (g + 1) * 8 + c);
    s += bf(row, (g + 2) * 8);
  } else if (body == 1) {  // t (R+4, G, 8)
    const uint16_t* row = t + (long long)(i + 2) * G * 8;
    s = g > 0 ? bf(row, (g - 1) * 8 + 7) : 0.f;
    for (int c = 0; c < 8; ++c) s += bf(row, g * 8 + c);
    s += g < G - 1 ? bf(row, (g + 1) * 8) : 0.f;
  } else if (body == 2) {  // y (R+2, G, 192)
    const uint16_t* px = t + (long long)o * 192;
    for (int c = 168; c < 192; ++c) s += bf(px, c);
    for (int c = 0; c < 192; ++c) s += bf(px, c);
    for (int c = 0; c < 24; ++c) s += bf(px, c);
  } else {  // f ((R+4)(G+2), 8), flat rows
    for (int dy = 0; dy < 3; ++dy)
      for (int dg = 0; dg < 3; ++dg)
        s += bf(t, 8 * ((long long)o + dy * (G + 2) + dg));
  }
  store8(out, o, s);
}

// P3: out (M, 128) = p (M, K) @ w (K, 128), p the lane-widened row of a:
// body 0 slice192 (a (M, 192), K = 256), 1 slice8 (a (M, 8), K = 128),
// 2 ones_matmul (a (M, 192), K = 192).  Lanes past the widened row are zero
// and skipped.
__global__ void __launch_bounds__(kThreads)
lane_matmul_kernel(const uint16_t* __restrict__ a,
                   const uint16_t* __restrict__ w, float* __restrict__ out,
                   int body, int M) {
  const int m = blockIdx.x, n = threadIdx.x;  // 128 threads: one column each
  if (m >= M) return;
  float acc = 0.f;
  if (body == 0) {
    const uint16_t* r = a + (long long)m * 192;
    for (int k = 0; k < 24; ++k)
      acc = fmaf(bf(r, 168 + k), bf(w, k * 128 + n), acc);
    for (int k = 0; k < 192; ++k)
      acc = fmaf(bf(r, k), bf(w, (24 + k) * 128 + n), acc);
    for (int k = 0; k < 24; ++k)
      acc = fmaf(bf(r, k), bf(w, (216 + k) * 128 + n), acc);
  } else if (body == 1) {
    const uint16_t* r = a + (long long)m * 8;
    acc = bf(r, 7) * bf(w, n);
    for (int k = 0; k < 8; ++k)
      acc = fmaf(bf(r, k), bf(w, (1 + k) * 128 + n), acc);
    acc = fmaf(bf(r, 0), bf(w, 9 * 128 + n), acc);
  } else {
    const uint16_t* r = a + (long long)m * 192;
    for (int k = 0; k < 192; ++k)
      acc = fmaf(bf(r, k), bf(w, k * 128 + n), acc);
  }
  out[(long long)m * 128 + n] = acc;
}

}  // namespace

extern "C" {

// t: the body's bf16 input (see above), out: its f32 output, contiguous,
// out 16-byte aligned; body 0-3 as halo_sum_kernel numbers them.
int halo_sum_forward(const void* t, void* out, int body, int R, int G,
                     void* stream) {
  if (body < 0 || body > 3 || R < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const int n = (R + 2) * G;
  halo_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>((const uint16_t*)t, (float*)out,
                                            body, R, G);
  return (int)cudaGetLastError();
}

// a (M, 192 or 8) and w (K, 128) bf16, out (M, 128) f32, contiguous; body
// 0-2 as lane_matmul_kernel numbers them.
int lane_matmul_forward(const void* a, const void* w, void* out, int body,
                        int M, void* stream) {
  if (body < 0 || body > 2 || M < 1) return (int)cudaErrorInvalidValue;
  lane_matmul_kernel<<<M, 128, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)w, (float*)out, body, M);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
