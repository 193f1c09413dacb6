// The CEM layout probes: what each probe body computes, as kernels for
// Hopper, and an empty kernel that measures what a launch costs.
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
//
// What bounds them on the H100: neither bytes (at most 2.6 MB, under 1 us
// at 3.35 TB/s) nor operations (at most 6.3 MFLOP): a launch and one or two
// trips to memory.  So the design cuts the trips and spreads the work:
//   P2: every SM gets blocks (205 at R = G = 80), and every load but
//     flat_gather's is 16 bytes.  halo_concat and halo_roll: a thread per
//     pixel loads its centre pixel as one vector; its two edge values (lane
//     7 of the left pixel, lane 0 of the right) come from the neighbouring
//     threads by shuffle, and are read only at a warp's or a row's edge.
//     lane_wrap, the one large input (2.5 MB): 8 threads a pixel, three
//     16-byte loads each, so that 4 pixels' 1536 bytes are read by a warp
//     in three coalesced loads; lanes [0:24) and [168:192) count twice
//     (the same sum as the wrapped 240 lanes), three xor shuffles reduce.
//     flat_gather: 3 scalar loads a thread, its neighbours' by shuffle.
//   P3: on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums).
//     A block takes 16 rows and 32 columns (4 warps, one n8 tile each): at
//     M = 96 a grid of 6 x 4 blocks fetches w six times (not once a row).
//     Its slice of w and its rows of a arrive by 16-byte cp.async, all in
//     flight at once, and the rows are widened in shared memory by the
//     index map widen_src (probe_cem_fb.widen_index in Python): slice192's
//     and ones_matmul's as they arrive (each 16-byte chunk of a widened row
//     is one of a's), slice8's value by value after; k16 steps that
//     hold no lane of a are skipped: slice192 runs 15 of 16, slice8 1 of 8,
//     ones_matmul 12 of 12.  ldmatrix feeds the products, rows padded by
//     16 bytes so that its eight rows hit distinct banks.  Why mma.sync
//     and not wgmma: a wgmma form (64-row tiles, one warpgroup, A from
//     registers, w by descriptor from a 128-byte swizzled slice, M = 96
//     padded to 128) was timed against this one on the H100 and was the
//     slower for every body at the probe's 96 rows (PERF.md).  A
//     body there is one trip to memory and a short chain of products,
//     which 24 small blocks finish sooner than wgmma's 4 large ones; only
//     at 1024 rows, which no caller has, did wgmma win (slice192,
//     ones_matmul).
//   empty_kernel: nothing, launched like the others: the launch floor.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(const uint16_t* p, size_t i) {
  return __bfloat162float(__ushort_as_bfloat16(p[i]));
}
// the low and the high bf16 of a 32-bit word, exactly, as f32
__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ float sum8(const uint4& v) {
  return ((lo(v.x) + hi(v.x)) + (lo(v.y) + hi(v.y))) +
         ((lo(v.z) + hi(v.z)) + (lo(v.w) + hi(v.w)));
}
__device__ __forceinline__ float4 rounded4(float sum) {
  const float v = __bfloat162float(__float2bfloat16_rn(sum));
  return make_float4(v, v, v, v);
}

// ---------------------------------------------------------------- P2
// body 0 halo_concat, 1 halo_roll, 2 lane_wrap, 3 flat_gather.  Bodies 0,
// 1, 3: a thread per output pixel o < n = (R + 2) G, consecutive pixels on
// consecutive lanes; body 2: 8 threads per pixel.  Every lane of a warp
// takes part in its shuffles; lanes past n only feed them.
template <int BODY>
__global__ void __launch_bounds__(256)
halo_sum_kernel(const uint16_t* __restrict__ t, float* __restrict__ out,
                int R, int G) {
  const int n = (R + 2) * G;
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (BODY == 2) {  // y (R+2, G, 192)
    const int o = tid >> 3, j = tid & 7;
    float s = 0.f;
    if (o < n) {
      const uint4* px = reinterpret_cast<const uint4*>(t + (size_t)o * 192);
      const uint4 v0 = __ldg(px + j), v1 = __ldg(px + j + 8),
                  v2 = __ldg(px + j + 16);
      // chunks 0-2 are lanes [0:24), 21-23 lanes [168:192)
      s = (j < 3 ? 2.f : 1.f) * sum8(v0) + sum8(v1) +
          (j >= 5 ? 2.f : 1.f) * sum8(v2);
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    s += __shfl_xor_sync(kFull, s, 4);
    if (o < n && j < 2)
      reinterpret_cast<float4*>(out + (size_t)o * 8)[j] = rounded4(s);
  } else if constexpr (BODY == 3) {  // f ((R+4)(G+2), 8), flat rows
    // live lanes read their neighbours' rows up to n + 1, always in range
    const size_t ol = (size_t)min(tid, n + 1);
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const size_t r = ol + (size_t)dy * (G + 2);
      const float x = bf(t, 8 * r);
      float x1 = __shfl_down_sync(kFull, x, 1);
      float x2 = __shfl_down_sync(kFull, x, 2);
      if (lane == 31) x1 = bf(t, 8 * (r + 1));
      if (lane >= 30) x2 = bf(t, 8 * (r + 2));
      s += x + x1 + x2;
    }
    if (tid < n) {
      float4* q = reinterpret_cast<float4*>(out + (size_t)tid * 8);
      q[0] = q[1] = rounded4(s);
    }
  } else {  // halo_concat: t (R+4, G+2, 8); halo_roll: t (R+4, G, 8)
    constexpr int kPad = BODY == 0 ? 2 : 0;  // pixels a row holds past G
    const int o = min(tid, n - 1);
    const int i = o / G, g = o - i * G;
    const uint16_t* row = t + (size_t)(i + 2) * (G + kPad) * 8;
    const int c = g + kPad / 2;  // the centre pixel in its row
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + c);
    float left = __shfl_up_sync(kFull, hi(v.w), 1);    // its lane 7
    float right = __shfl_down_sync(kFull, lo(v.x), 1); // its lane 0
    // at a row's edge the value is halo_concat's pad pixel or halo_roll's
    // zero; at a warp's edge it is read
    if (g == 0 || lane == 0)
      left = (BODY == 0 || g > 0) ? bf(row, 8 * (c - 1) + 7) : 0.f;
    if (g == G - 1 || lane == 31)
      right = (BODY == 0 || g < G - 1) ? bf(row, 8 * (c + 1)) : 0.f;
    if (tid < n) {
      float4* q = reinterpret_cast<float4*>(out + (size_t)tid * 8);
      q[0] = q[1] = rounded4(left + sum8(v) + right);
    }
  }
}

// ---------------------------------------------------------------- P3
// body 0 slice192, 1 slice8, 2 ones_matmul: a's lanes L (w has 16 STEPS
// rows or more: 256, 128, 192);
// the k16 steps that hold a lane of a; CHUNKED: every 8 columns of the
// widened row read 8 consecutive lanes of a from a multiple of 8, or none
template <int BODY>
struct Body;
template <>
struct Body<0> {
  static constexpr int L = 192, STEPS = 15;
  static constexpr bool CHUNKED = true;
};
template <>
struct Body<1> {
  static constexpr int L = 8, STEPS = 1;
  static constexpr bool CHUNKED = false;
};
template <>
struct Body<2> {
  static constexpr int L = 192, STEPS = 12;
  static constexpr bool CHUNKED = true;
};

// the lane of a that column k of the widened row reads, or -1 (a zero);
// mirrors probe_cem_fb.widen_index
__device__ __forceinline__ int widen_src(int body, int k) {
  if (body == 0)
    return k < 24 ? 168 + k : k < 216 ? k - 24 : k < 240 ? k - 216 : -1;
  if (body == 1) return k == 0 ? 7 : k < 9 ? k - 1 : k == 9 ? 0 : -1;
  return k;
}

// a block's tile: kRows x kCols outputs; kWRow, the bytes of a row of its
// slice of w in shared memory: 32 columns and 16 bytes of padding, so that
// ldmatrix's eight rows fall in distinct banks
constexpr int kRows = 16, kCols = 32, kWRow = 2 * kCols + 16;
constexpr int kAStride = 256 + 8;  // bf16s a widened row, padded the same way

template <int BODY>
constexpr int lane_matmul_smem() {
  using B = Body<BODY>;
  return 16 * B::STEPS * kWRow +
         kRows * (kAStride + (B::CHUNKED ? 0 : B::L)) * 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {  // zeros past bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p))
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

__device__ __forceinline__ void store2(float* out, int row, int col, int M,
                                       float x, float y) {
  if (row < M)
    *reinterpret_cast<float2*>(out + (size_t)row * 128 + col) =
        make_float2(x, y);
}

// out (M, 128) = p (M, K) @ w (K, 128), p the lane-widened row of a
template <int BODY>
__global__ void __launch_bounds__(128)
lane_matmul_kernel(const uint16_t* __restrict__ a,
                   const uint16_t* __restrict__ w, float* __restrict__ out,
                   int M) {
  using B = Body<BODY>;
  constexpr int KU = 16 * B::STEPS;  // the widened columns that hold lanes
  extern __shared__ __align__(16) unsigned char ws[];
  uint16_t* aw = reinterpret_cast<uint16_t*>(ws + KU * kWRow);
  uint16_t* araw = aw + kRows * kAStride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kCols;

  // 1. the tile's rows of a (zeros past M), widened as they arrive where
  // the widening moves whole chunks, and its slice of w, all in flight at
  // once
  if constexpr (B::CHUNKED) {
    for (int c = tid; c < kRows * (KU / 8); c += 128) {
      const int r = c / (KU / 8), k = 8 * (c % (KU / 8));
      const int s = widen_src(BODY, k);
      const bool in = m0 + r < M && s >= 0;
      cp_async16(aw + r * kAStride + k,
                 a + (size_t)(in ? m0 + r : 0) * B::L + (in ? s : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < kRows * (B::L / 8); c += 128) {
      const int r = c / (B::L / 8), q = c % (B::L / 8);
      const bool in = m0 + r < M;
      cp_async16(araw + r * B::L + q * 8,
                 a + (size_t)(in ? m0 + r : 0) * B::L + q * 8, in ? 16 : 0);
    }
  }
  constexpr int kWChunks = kCols / 8;
  for (int c = tid; c < KU * kWChunks; c += 128) {
    const int k = c / kWChunks, q = c % kWChunks;
    cp_async16(ws + k * kWRow + q * 16, w + (size_t)k * 128 + n0 + q * 8, 16);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the widened rows, value by value, where the widening splits chunks
  if constexpr (!B::CHUNKED) {
    for (int e = tid; e < kRows * KU; e += 128) {
      const int r = e / KU, k = e % KU, s = widen_src(BODY, k);
      aw[r * kAStride + k] = s < 0 ? 0 : araw[r * B::L + s];
    }
    __syncthreads();
  }

  // 3. the products, warp w: columns 8 w .. 8 w + 7 of the tile; lane l
  // addresses A's row l % 16 at column 8 (l / 16)
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < B::STEPS; ++s) {
    uint32_t af[4], b0, b1;
    ldsm_x4(af, aw + (lane & 15) * kAStride + 16 * s + 8 * (lane >> 4));
    ldsm_x2_trans(b0, b1, ws + (16 * s + (lane & 15)) * kWRow + 16 * warp);
    mma16816(d, af, b0, b1);
  }
  const int g = lane >> 2, t4 = lane & 3, col = n0 + 8 * warp + 2 * t4;
  store2(out, m0 + g, col, M, d[0], d[1]);
  store2(out, m0 + g + 8, col, M, d[2], d[3]);
}

template <int BODY>
cudaError_t launch_lane_matmul(const void* a, const void* w, void* out,
                               int M, cudaStream_t stream) {
  constexpr int bytes = lane_matmul_smem<BODY>();
  static_assert(bytes <= 48 * 1024, "no opt-in to more shared memory");
  const dim3 grid((M + kRows - 1) / kRows, 128 / kCols);
  lane_matmul_kernel<BODY><<<grid, 128, bytes, stream>>>(
      (const uint16_t*)a, (const uint16_t*)w, (float*)out, M);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// t: the body's bf16 input (see above), out: its f32 output, both
// contiguous and 16-byte aligned; body 0-3 as halo_sum_kernel numbers them.
int halo_sum_forward(const void* t, void* out, int body, int R, int G,
                     void* stream) {
  if (body < 0 || body > 3 || R < 1 || G < 1 ||
      ((long long)R + 2) * G * 8 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n = (R + 2) * G;
  const int per = body == 2 ? 8 : 1, threads = body == 2 ? 256 : 32;
  const int blocks = (n * per + threads - 1) / threads;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* ti = (const uint16_t*)t;
  float* o = (float*)out;
  switch (body) {
    case 0: halo_sum_kernel<0><<<blocks, threads, 0, s>>>(ti, o, R, G); break;
    case 1: halo_sum_kernel<1><<<blocks, threads, 0, s>>>(ti, o, R, G); break;
    case 2: halo_sum_kernel<2><<<blocks, threads, 0, s>>>(ti, o, R, G); break;
    default: halo_sum_kernel<3><<<blocks, threads, 0, s>>>(ti, o, R, G);
  }
  return (int)cudaGetLastError();
}

// a (M, 192 or 8) and w (K, 128) bf16, out (M, 128) f32, contiguous and
// 16-byte aligned; body 0-2 as Body numbers them.
int lane_matmul_forward(const void* a, const void* w, void* out, int body,
                        int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M < 1) return (int)cudaErrorInvalidValue;
  switch (body) {
    case 0: return (int)launch_lane_matmul<0>(a, w, out, M, s);
    case 1: return (int)launch_lane_matmul<1>(a, w, out, M, s);
    case 2: return (int)launch_lane_matmul<2>(a, w, out, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// one launch of a kernel that does nothing: the floor under every launch
int empty_forward(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
