// Greedy selection NMS: sort each image's pool once, then a chunked scan of
// the sorted pool.  Two forms of one algorithm: pools of up to 4096 slots
// sort in one thread block's shared memory; larger pools, up to 30000 (the
// evaluator's pre_nms_topk), sort across a cluster of eight blocks.
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
// K x 20 bytes per image and the selections depend on each other.  The
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
// The large-pool form (4096 < K <= 30000).  30000 keys are 240 KB, more
// than the 227 KB of shared memory one block can have, so each image takes
// a cluster of eight blocks:
//   1. block r sorts the keys of pool slots [4096 r, 4096 (r + 1)) in its
//      own shared memory (the small form's sort; padding sorts last);
//   2. after a cluster barrier, each valid key finds its place in the whole
//      pool's order: its position in its own run plus, for each other run,
//      the number of that run's keys below it, by a binary search of the
//      other block's shared memory (distributed shared memory).  Keys are
//      distinct (they hold the index), so the places are a permutation;
//   3. each block writes its candidates' boxes, areas and indices at their
//      places into a workspace in global memory (24 bytes a slot, 11.5 MB
//      at batch 16: it stays in the 50 MB L2);
//   4. after a second cluster barrier the other blocks exit and block 0 runs
//      the small form's scan over the workspace.
// One launch per batch, no host sync; the same scan and round count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 64;       // candidates per scan round: one 64-bit row
constexpr int kMaxPool = 4096;   // the small form: the whole pool in a block
constexpr int kCluster = 8;      // the large form: blocks per image
constexpr int kMaxLarge = 30000;  // <= kCluster * kMaxPool, positions < 2^16
// dynamic shared memory per pool slot of the small form: key, sorted box,
// its area, and the sorted position of a kept box
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

// key[i] for pool slots first + i, i < P: (descending score, index); an
// invalid slot has the largest score bits, padding past K is all ones.
// Returns this thread's count of valid slots.
__device__ __forceinline__ int load_keys(uint64_t* key,
                                         const float* __restrict__ scores,
                                         int first, int K, int P) {
  int nv = 0;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int s_i = first + i;
    uint64_t k = ~0ull;  // padding past K sorts after everything
    if (s_i < K) {
      const float s = scores[s_i];
      const bool valid = s > -CUDART_INF_F;
      k = (uint64_t)(valid ? descending(s) : 0xffffffffu) << 32 |
          (uint32_t)s_i;
      nv += valid;
    }
    key[i] = k;
  }
  return nv;
}

// bitonic sort of key[0, P), P a power of two, ascending; ends with a
// barrier
__device__ __forceinline__ void bitonic_sort(uint64_t* key, int P) {
  const int tid = threadIdx.x;
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
}

// The sorted pool as the scan reads it: position p's box, its area and its
// index in the caller's pool.  Small form: shared memory.
struct SharedPool {
  const uint64_t* key;
  const float4* sb;
  const float* sa;
  __device__ float4 box(int p) const { return sb[p]; }
  __device__ float area_of(int p) const { return sa[p]; }
  __device__ int index(int p) const { return (int)(uint32_t)key[p]; }
};
// Large form: the workspace in global memory, written by the cluster in
// this launch (plain loads, never the read-only path).
struct GlobalPool {
  const float4* sb;
  const float* sa;
  const int* si;
  __device__ float4 box(int p) const { return sb[p]; }
  __device__ float area_of(int p) const { return sa[p]; }
  __device__ int index(int p) const { return si[p]; }
};

// The chunked scan over the nvalid sorted candidates of one image, by the
// whole block; kept: the sorted positions of kept boxes (shared memory, at
// least min(max_det, nvalid) slots).
template <class Pool>
__device__ __forceinline__ void scan(const Pool pool, int nvalid,
                                     uint16_t* kept, int* keep_idx,
                                     bool* keep_valid, int* stats, int img,
                                     int max_det, float iou_thres) {
  __shared__ uint64_t rows[kChunk];  // bit b of row a: kept a suppresses b
  __shared__ unsigned long long dead;  // chunk bits killed by earlier rounds
  __shared__ int n_kept;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    n_kept = 0;
    dead = 0;
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
        const float4 ba = pool.box(base + a);
        const float aa = pool.area_of(base + a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = c + 16 * j;
          if (b > a && b < m &&
              iou(pool.box(base + b), pool.area_of(base + b), ba, aa) >
                  iou_thres)
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
        const float4 bb = pool.box(base + b);
        const float ab = pool.area_of(base + b);
        for (int t = tid >> 6; t < nk && !hit; t += kThreads / kChunk) {
          const int p = kept[t];
          hit = iou(bb, ab, pool.box(p), pool.area_of(p)) > iou_thres;
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
        keep_idx[n] = pool.index(base + a);
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
  __shared__ int n_valid;
  const int img = blockIdx.x, tid = threadIdx.x;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;

  if (tid == 0) n_valid = 0;
  __syncthreads();
  const int nv = __reduce_add_sync(0xffffffffu,
                                   load_keys(key, scores, 0, K, P));
  if ((tid & 31) == 0 && nv) atomicAdd(&n_valid, nv);
  bitonic_sort(key, P);
  const int nvalid = n_valid;
  for (int p = tid; p < nvalid; p += kThreads) {
    const float4 b = boxes[(uint32_t)key[p]];
    sb[p] = b;
    sa[p] = area(b);
  }
  __syncthreads();
  scan(SharedPool{key, sb, sa}, nvalid, kept,
       keep_idx + (size_t)img * max_det, keep_valid + (size_t)img * max_det,
       stats, img, max_det, iou_thres);
}

// Block r of image blockIdx.x / kCluster holds pool slots [4096 r, 4096 r +
// 4096); ws_* are the image's sorted pool, K slots each.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms_kernel_large(const float4* __restrict__ boxes,
                 const float* __restrict__ scores, int* __restrict__ keep_idx,
                 bool* __restrict__ keep_valid, int* __restrict__ stats,
                 float4* ws_box, float* ws_area, int* ws_idx, int K,
                 int max_det, float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);          // [4096]
  uint16_t* kept = reinterpret_cast<uint16_t*>(key + kMaxPool);  // block 0
  __shared__ int n_valid;  // of this block's run
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), tid = threadIdx.x;
  const int img = blockIdx.x / kCluster;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;
  ws_box += (size_t)img * K;
  ws_area += (size_t)img * K;
  ws_idx += (size_t)img * K;

  if (tid == 0) n_valid = 0;
  __syncthreads();
  const int first = r * kMaxPool;
  const int nv = __reduce_add_sync(
      0xffffffffu, load_keys(key, scores, first, K, kMaxPool));
  if ((tid & 31) == 0 && nv) atomicAdd(&n_valid, nv);
  if (first < K) {
    bitonic_sort(key, kMaxPool);
  } else {
    __syncthreads();  // all padding: sorted already
  }
  cluster.sync();  // every run sorted, every count final

  // the whole pool's valid count, and each valid key's place in the pool's
  // order: the keys below it in its own run and in the seven others
  int nvalid = 0;
  const uint64_t* runs[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    runs[q] = cluster.map_shared_rank(key, q);
    nvalid += *cluster.map_shared_rank(&n_valid, q);
  }
  const int mine = n_valid;  // valid keys sort first in the run
  for (int i = tid; i < mine; i += kThreads) {
    const uint64_t k = key[i];
    int place = i;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      if (q == r) continue;
      const uint64_t* run = runs[q];
      int pos = 0;  // lower bound: keys of run q below k
#pragma unroll
      for (int step = kMaxPool / 2; step > 0; step >>= 1)
        if (run[pos + step - 1] < k) pos += step;
      place += pos + (run[pos] < k);
    }
    const int s_i = (int)(uint32_t)k;
    const float4 b = boxes[s_i];
    ws_box[place] = b;
    ws_area[place] = area(b);
    ws_idx[place] = s_i;
  }
  __threadfence();
  cluster.sync();  // the workspace is complete; no block reads another's
                   // shared memory past here
  if (r != 0) return;
  __threadfence();
  scan(GlobalPool{ws_box, ws_area, ws_idx}, nvalid, kept,
       keep_idx + (size_t)img * max_det, keep_valid + (size_t)img * max_det,
       stats, img, max_det, iou_thres);
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32 xyxy with the class offset applied; scores (B, K) f32
// with -inf for invalid candidates; keep_idx (B, max_det) int32 and
// keep_valid (B, max_det) bool.  1 <= K <= 30000, max_det >= 1.  stats,
// when not null, (B, 4) int32: per image the scan's rounds, the sorted
// candidates it consumed (up to the max_det-th kept box, else all valid
// ones), the boxes kept and the valid candidates.  workspace: for
// K > 4096, B * K * 24 bytes, 16-byte aligned (the large form's sorted
// pools); unused, and may be null, for K <= 4096.
int nms_greedy_forward(const void* boxes, const void* scores, void* keep_idx,
                       void* keep_valid, void* stats, void* workspace, int B,
                       int K, int max_det, float iou_thres, void* stream) {
  if (K < 1 || K > kMaxLarge || max_det < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static unsigned sized[2];  // per form: devices whose limit is raised
  cudaError_t e;
  if (K <= kMaxPool) {
    int P = 2;  // the sort's width: a power of two, 16-byte aligned regions
    while (P < K) P <<= 1;
    e = allow_smem(nms_kernel, kMaxPool * kSlotBytes, sized[0]);
    if (e != cudaSuccess) return (int)e;
    nms_kernel<<<B, kThreads, P * kSlotBytes, st>>>(
        (const float4*)boxes, (const float*)scores, (int*)keep_idx,
        (bool*)keep_valid, (int*)stats, K, P, max_det, iou_thres);
    return (int)cudaGetLastError();
  }
  if (!workspace) return (int)cudaErrorInvalidValue;
  e = allow_smem(nms_kernel_large, kMaxPool * 8 + 2 * kMaxLarge, sized[1]);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * K;
  float4* ws_box = (float4*)workspace;
  float* ws_area = (float*)(ws_box + n);
  int* ws_idx = (int*)(ws_area + n);
  const int smem = kMaxPool * 8 + 2 * (max_det < K ? max_det : K);
  nms_kernel_large<<<B * kCluster, kThreads, smem, st>>>(
      (const float4*)boxes, (const float*)scores, (int*)keep_idx,
      (bool*)keep_valid, (int*)stats, ws_box, ws_area, ws_idx, K, max_det,
      iou_thres);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
