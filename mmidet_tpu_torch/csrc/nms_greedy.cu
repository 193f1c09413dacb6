// Greedy selection NMS, one thread block per image.
//
// Replaces the TPU kernel mmidet_tpu/ops/nms_pallas.py:nms_greedy_pallas
// (_nms_kernel) and computes exactly mmidet_tpu/ops/nms.py:_nms_single on
// boxes that already carry the class offset: max_det dependent steps of
//   j = argmax(scores)            (first occurrence: lowest index on ties)
//   iou = inter / (areas + areas[j] - inter + 1e-9)
//   scores[iou > iou_thres or index == j] = -inf      (if scores[j] > -inf)
// keep_idx[t] = j (0 when the step found nothing), keep_valid[t] = found.
//
// What bounds it on the H100: latency, not bytes or FLOPs.  The pool is
// 4096 x 20 bytes per image and each step is one O(K) pass, but the steps
// depend on each other.  The design keeps the whole pool in registers of
// one 1024-thread block (K/1024 candidates per thread, areas computed
// once), so a step is a block argmax (warp shuffles, then one shared-memory
// round) plus a register-only IoU pass: two __syncthreads per step, no
// device-memory traffic between steps, and one launch for all max_det
// steps of every image.  The block stops once the pool is exhausted.  At
// batch 16 it fills only 16 of the 132 SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;  // candidates per thread: K <= 4096

struct Best {
  float s;
  int i;
  float4 b;
};

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ Best warp_best(Best v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.s = __shfl_xor_sync(0xffffffffu, v.s, off);
    o.i = __shfl_xor_sync(0xffffffffu, v.i, off);
    o.b.x = __shfl_xor_sync(0xffffffffu, v.b.x, off);
    o.b.y = __shfl_xor_sync(0xffffffffu, v.b.y, off);
    o.b.z = __shfl_xor_sync(0xffffffffu, v.b.z, off);
    o.b.w = __shfl_xor_sync(0xffffffffu, v.b.w, off);
    if (better(o.s, o.i, v.s, v.i)) v = o;
  }
  return v;
}

// IEEE products and quotient, never contracted into an FMA, so the IoU is
// bit-identical to the plain PyTorch version's separate operations.
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ keep_idx, bool* __restrict__ keep_valid, int K,
           int max_det, float iou_thres) {
  __shared__ Best warp_win[kThreads / 32];
  __shared__ Best win;
  const int img = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;
  keep_idx += (size_t)img * max_det;
  keep_valid += (size_t)img * max_det;

  float4 bx[kItems];
  float ar[kItems], sc[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int idx = t * kThreads + tid;
    if (idx < K) {
      bx[t] = boxes[idx];
      sc[t] = scores[idx];
    } else {
      bx[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      sc[t] = -CUDART_INF_F;
    }
    ar[t] = area(bx[t]);
  }

  for (int step = 0; step < max_det; ++step) {
    Best v{-CUDART_INF_F, 0x7fffffff, make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int idx = t * kThreads + tid;
      if (better(sc[t], idx, v.s, v.i)) v = Best{sc[t], idx, bx[t]};
    }
    v = warp_best(v);
    if (lane == 0) warp_win[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = warp_best(warp_win[lane]);
      if (lane == 0) {
        const bool found = v.s > -CUDART_INF_F;
        win = v;
        keep_idx[step] = found ? v.i : 0;
        keep_valid[step] = found;
      }
    }
    __syncthreads();
    v = win;
    if (!(v.s > -CUDART_INF_F)) {  // pool exhausted: the rest is empty
      for (int t = step + 1 + tid; t < max_det; t += kThreads) {
        keep_idx[t] = 0;
        keep_valid[t] = false;
      }
      break;
    }
    const float barea = area(v.b);
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const float iw = fmaxf(__fsub_rn(fminf(bx[t].z, v.b.z),
                                       fmaxf(bx[t].x, v.b.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(bx[t].w, v.b.w),
                                       fmaxf(bx[t].y, v.b.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(ar[t], barea), inter),
                                  1e-9f);
      const float iou = __fdiv_rn(inter, den);
      if (iou > iou_thres || t * kThreads + tid == v.i) sc[t] = -CUDART_INF_F;
    }
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32 xyxy with the class offset applied; scores (B, K) f32
// with -inf for invalid candidates; keep_idx (B, max_det) int32 and
// keep_valid (B, max_det) bool.  K <= 4096, max_det >= 1.
int nms_greedy_forward(const void* boxes, const void* scores, void* keep_idx,
                       void* keep_valid, int B, int K, int max_det,
                       float iou_thres, void* stream) {
  nms_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (int*)keep_idx,
      (bool*)keep_valid, K, max_det, iou_thres);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
