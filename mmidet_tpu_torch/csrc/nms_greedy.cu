// Greedy selection NMS, one thread block per image: sort once, then a
// chunked scan of the sorted pool.
//
// Replaces the TPU kernel mmidet_tpu/ops/nms_pallas.py:nms_greedy_pallas
// (_nms_kernel) and computes exactly mmidet_tpu/ops/nms.py:_nms_single on
// boxes that already carry the class offset: max_det dependent steps of
//   j = argmax(scores)            (first occurrence: lowest index on ties)
//   iou = inter / (areas + areas[j] - inter + 1e-9)
//   scores[iou > iou_thres or index == j] = -inf      (if scores[j] > -inf)
// keep_idx[t] = j (0 when the step found nothing), keep_valid[t] = found.
//
// Why a scan gives the same answer.  Greedy picks, among the live
// candidates, the highest score with the lowest index on ties.  On the pool
// sorted by (score descending, index ascending) that is the first live
// candidate, so a candidate is kept exactly when no earlier kept box
// suppresses it.  Every IoU below is computed as the plain version computes
// it, with the later candidate as the pool element and the kept box as j,
// in the same non-contracted IEEE operations, so each comparison is
// bit-identical to the one greedy makes.
//
// What bounds it on the H100: latency, not bytes or FLOPs: the pool is
// 4096 x 20 bytes per image and the selections depend on each other.  The
// design cuts the dependent rounds from max_det block-wide argmaxes to
//   * a bitonic sort of 64-bit keys (score bits ordered descending, then the
//     index) in shared memory: log2(P) (log2(P) + 1) / 2 barrier stages,
//     78 at P = 4096; invalid (-inf) slots sort last and are counted;
//   * ceil(consumed / 64) chunk rounds over the sorted pool.  Per round all
//     threads (a) build the chunk's 64 x 64 suppression bit matrix (ballots)
//     and (b) test the chunk's candidates against every box kept so far; one
//     thread then (c) walks the chunk's live bits in order, each kept box
//     clearing the later bits it suppresses.  Candidates past the last round
//     are never tested.  The walk stops at max_det kept or at the last valid
//     candidate.
// At batch 16 it fills 16 of the 132 SMs.  Scores are finite or -inf (a NaN
// score counts as invalid).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 64;       // candidates per scan round: one 64-bit row
constexpr int kMaxPool = 4096;
// dynamic shared memory per pool slot: key, sorted box, its area, and the
// sorted position of a kept box
constexpr int kSlotBytes = 8 + 16 + 4 + 2;

// IEEE products and quotient, never contracted into an FMA, so the IoU is
// bit-identical to the plain PyTorch version's separate operations.
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU of pool box b (area ab) against the selected box j (area aj), in the
// order of the plain version: inter / (areas + areas[j] - inter + 1e-9)
__device__ __forceinline__ float iou(float4 b, float ab, float4 j, float aj) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, j.z), fmaxf(b.x, j.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(b.w, j.w), fmaxf(b.y, j.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(ab, aj), inter), 1e-9f);
  return __fdiv_rn(inter, den);
}

// 32 bits that sort ascending as the score descends (s > -inf, not NaN);
// -0 and +0 tie, as they do for argmax
__device__ __forceinline__ uint32_t descending(float s) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;  // ascending with s
  return ~u;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ keep_idx, bool* __restrict__ keep_valid,
           int* __restrict__ stats, int K, int P, int max_det,
           float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);       // [P]
  float4* sb = reinterpret_cast<float4*>(key + P);          // [P] sorted boxes
  float* sa = reinterpret_cast<float*>(sb + P);             // [P] their areas
  uint16_t* kept = reinterpret_cast<uint16_t*>(sa + P);     // [P] positions
  __shared__ uint64_t rows[kChunk];  // bit b of row a: kept a suppresses b
  __shared__ unsigned long long dead;  // chunk bits suppressed by earlier rounds
  __shared__ int n_valid, n_kept;
  const int img = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;
  keep_idx += (size_t)img * max_det;
  keep_valid += (size_t)img * max_det;

  if (tid == 0) {
    n_valid = 0;
    n_kept = 0;
    dead = 0;
  }
  __syncthreads();
  int nv = 0;
  for (int i = tid; i < P; i += kThreads) {
    uint64_t k = ~0ull;  // padding past K sorts after everything
    if (i < K) {
      const float s = scores[i];
      const bool valid = s > -CUDART_INF_F;
      k = (uint64_t)(valid ? descending(s) : 0xffffffffu) << 32 | (uint32_t)i;
      nv += valid;
    }
    key[i] = k;
  }
  nv = __reduce_add_sync(0xffffffffu, nv);
  if (lane == 0 && nv) atomicAdd(&n_valid, nv);

  // bitonic sort, ascending keys
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < P / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const uint64_t a = key[lo], b = key[hi];
        if ((a > b) == ((lo & size) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
    }
  __syncthreads();
  const int nvalid = n_valid;
  for (int p = tid; p < nvalid; p += kThreads) {
    const float4 b = boxes[(uint32_t)key[p]];
    sb[p] = b;
    sa[p] = area(b);
  }
  __syncthreads();

  int rounds = 0, consumed = 0;  // thread 0's count of the scan
  for (int base = 0; base < nvalid; base += kChunk) {
    const int nk = n_kept;
    if (nk >= max_det) break;
    ++rounds;
    const int m = min(kChunk, nvalid - base);
    {  // (a) the chunk's own rows: thread -> row tid / 16, 4 columns
      const int a = tid >> 4, c = tid & 15;
      unsigned bits = 0;
      if (a < m) {
        const float4 ba = sb[base + a];
        const float aa = sa[base + a];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = c + 16 * j;
          if (b > a && b < m &&
              iou(sb[base + b], sa[base + b], ba, aa) > iou_thres)
            bits |= 1u << j;
        }
      }
      uint64_t r0 = 0, r1 = 0;  // rows 2 warp (lanes 0-15), 2 warp + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t bal = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
        r0 |= (uint64_t)(bal & 0xffffu) << (16 * j);
        r1 |= (uint64_t)(bal >> 16) << (16 * j);
      }
      if (lane == 0) {
        rows[2 * warp] = r0;
        rows[2 * warp + 1] = r1;
      }
    }
    {  // (b) candidate tid % 64 against kept boxes tid / 64, + 16, + 32, ...
      const int b = tid & (kChunk - 1);
      bool hit = false;
      if (b < m) {
        const float4 bb = sb[base + b];
        const float ab = sa[base + b];
        for (int t = tid >> 6; t < nk && !hit; t += kThreads / kChunk) {
          const int p = kept[t];
          hit = iou(bb, ab, sb[p], sa[p]) > iou_thres;
        }
      }
      const uint32_t bal = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && bal)
        atomicOr(&dead, (unsigned long long)bal << (32 * (warp & 1)));
    }
    __syncthreads();
    if (tid == 0) {  // (c) the serial walk over the chunk's live bits
      uint64_t live = (m == kChunk ? ~0ull : (1ull << m) - 1) & ~dead;
      int n = nk;
      consumed = base + m;
      while (live && n < max_det) {
        const int a = __ffsll((long long)live) - 1;
        live &= ~rows[a] & (live - 1);
        kept[n] = (uint16_t)(base + a);
        keep_idx[n] = (int)(uint32_t)key[base + a];
        keep_valid[n] = true;
        if (++n == max_det) consumed = base + a + 1;
      }
      n_kept = n;
      dead = 0;
    }
    __syncthreads();
  }
  for (int t = n_kept + tid; t < max_det; t += kThreads) {
    keep_idx[t] = 0;
    keep_valid[t] = false;
  }
  if (stats && tid == 0) {
    int* st = stats + 4 * img;
    st[0] = rounds;
    st[1] = consumed;
    st[2] = n_kept;
    st[3] = nvalid;
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32 xyxy with the class offset applied; scores (B, K) f32
// with -inf for invalid candidates; keep_idx (B, max_det) int32 and
// keep_valid (B, max_det) bool.  1 <= K <= 4096, max_det >= 1.  stats,
// when not null, (B, 4) int32: per image the scan's rounds, the sorted
// candidates it consumed (up to the max_det-th kept box, else all valid
// ones), the boxes kept and the valid candidates.
int nms_greedy_forward(const void* boxes, const void* scores, void* keep_idx,
                       void* keep_valid, void* stats, int B, int K,
                       int max_det, float iou_thres, void* stream) {
  if (K < 1 || K > kMaxPool || max_det < 1) return (int)cudaErrorInvalidValue;
  int P = 2;  // the sort's width: a power of two, 16-byte aligned regions
  while (P < K) P <<= 1;
  static unsigned sized = 0;  // the limit for the largest pool
  const cudaError_t e = allow_smem(nms_kernel, kMaxPool * kSlotBytes, sized);
  if (e != cudaSuccess) return (int)e;
  const int smem = P * kSlotBytes;
  nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (int*)keep_idx,
      (bool*)keep_valid, (int*)stats, K, P, max_det, iou_thres);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
