// Greedy selection NMS: put each image's pool in order once, then a windowed
// scan of the ordered pool.  Two forms of one algorithm: pools of up to 4096
// slots sort in one thread block's shared memory; larger pools, up to 30000
// (the evaluator's pre_nms_topk), take a cluster of eight blocks.
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
// ordered by (score descending, index ascending) that is the first live
// candidate, so a candidate is kept exactly when no earlier kept box
// suppresses it.  Every IoU below is computed as the plain version computes
// it, in the same non-contracted IEEE operations, so each comparison is
// bit-identical to the one greedy makes.
//
// What bounds it on the H100: latency, not bytes or FLOPs: the pool is
// K x 20 bytes per image and the selections depend on each other.  The
// scan (both forms) walks the ordered pool in windows of 1024 positions:
//   * one thread a candidate tests it against every box kept so far (the
//     kept boxes and their areas live in shared memory), and the survivors
//     are compacted in order;
//   * the survivors are walked in chunks of 64: all threads build the
//     chunk's 64 x 64 suppression bit matrix and test the chunk against the
//     boxes kept earlier in this window; one thread then walks the chunk's
//     live bits in order, each kept box clearing the later bits it
//     suppresses (only the bits that suppress a later live one need the
//     walk), and the kept boxes are recorded in parallel.
// A pool read from global memory is staged one window ahead (the boxes by
// cp.async, the indices in a register).  The scan stops at max_det kept or
// at the last valid candidate.  Its count of dependent steps (windows plus
// chunks) goes to stats.
//
// The small form (K <= 4096): a bitonic sort of 64-bit keys (score bits
// ordered descending, then the index) in shared memory, its strides below
// 64 in registers, then the scan.
//
// The large form (4096 < K <= 30000), a cluster of eight blocks per image,
// block r holding the keys of pool slots [4096 r, 4096 r + 4096):
//   1. in order?  Every block checks that its slots' keys ascend, across
//      its boundary too.  In a pool in order (torch.topk's output, the
//      evaluator's case) each slot is its own position: block 0 scans the
//      input directly (path 1).
//   2. otherwise the cluster selects the kTop = 1024 smallest keys or a
//      few more (at most kTopCap = 2048; every valid key when there are no
//      more than that): radix histograms over 8-bit digits of the key,
//      summed through distributed shared memory, refined until the bucket
//      where the count crosses kTop fits.  The selected keys are the first
//      positions of the whole order.  Block 0 gathers and sorts them and
//      scans the first kTop positions (or every valid one) from shared
//      memory (path 2);
//   3. if that scan used up its positions before max_det was kept and
//      valid keys remain, every block sorts its run, each valid key finds
//      its place in the whole order by binary searches of the other runs
//      (distributed shared memory), the keys from position kTop on go with
//      their boxes to a workspace in global memory, and block 0 goes on
//      scanning from position kTop (path 3).
// One launch per batch, no host sync.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).  chip_profile.py
// builds it with -DNMS_SKIP=<mask> to leave parts of the large form out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWindow = kThreads;  // scan window: one candidate a thread
constexpr int kChunk = 64;         // walk step: one 64-bit row a candidate
constexpr int kMaxPool = 4096;     // the small form: the whole pool a block
constexpr int kCluster = 8;        // the large form: blocks per image
constexpr int kMaxLarge = 30000;   // <= kCluster * kMaxPool
constexpr int kTop = 1024;         // positions path 2 scans (of kWindow)
constexpr int kTopCap = 2048;      // most keys the selection may hold
constexpr int kKeptShared = 1024;  // large form: most kept boxes in shared
// the large form's parts that chip_profile.py leaves out (bit i)
#ifndef NMS_SKIP
#define NMS_SKIP 0
#endif
constexpr int kSkip = NMS_SKIP;
enum : int { kSkipRunSort = 1, kSkipMerge = 2, kSkipWrite = 4, kSkipScan = 8,
             kSkipCheck = 16, kSkipTopSort = 32 };
constexpr uint64_t kInvalid = 0xffffffffull << 32;  // smallest invalid key

// IEEE products and quotient, never contracted into an FMA, so the IoU is
// bit-identical to the plain PyTorch version's separate operations.
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU of pool box b (area ab) against the selected box j (area aj), in the
// order of the plain version: inter / (areas + areas[j] - inter + 1e-9),
// above iou_thres.  Where the boxes do not meet (iw or inter 0), the
// quotient is +-0 or NaN, never above a threshold >= 0, and is not
// computed.
__device__ __forceinline__ bool suppresses(float4 b, float ab, float4 j,
                                           float aj, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, j.z), fmaxf(b.x, j.x)), 0.f);
  if (iw == 0.f && thr >= 0.f) return false;
  const float ih = fmaxf(__fsub_rn(fminf(b.w, j.w), fmaxf(b.y, j.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f && thr >= 0.f) return false;
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(ab, aj), inter), 1e-9f);
  return __fdiv_rn(inter, den) > thr;
}

// 32 bits that sort ascending as the score descends (s > -inf, not NaN);
// -0 and +0 tie, as they do for argmax
__device__ __forceinline__ uint32_t descending(float s) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;  // ascending with s
  return ~u;
}

// a key's high half: invalid (-inf or NaN) slots the largest
__device__ __forceinline__ uint32_t score_bits(float s) {
  return s > -CUDART_INF_F ? descending(s) : 0xffffffffu;
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
      k = (uint64_t)score_bits(scores[s_i]) << 32 | (uint32_t)s_i;
      nv += k < kInvalid;
    }
    key[i] = k;
  }
  return nv;
}

// The bitonic stages of sizes [from, to] (powers of two, to <= 64 or from
// == to) whose strides are below 64, in registers: each warp takes 64-key
// segments, lane l holding keys seg + l and seg + 32 + l; stride 32 pairs
// them within the lane, the smaller strides by shuffles.
__device__ __forceinline__ void bitonic_in_registers(uint64_t* key, int P,
                                                     int from, int to) {
  const int lane = threadIdx.x & 31;
  for (int seg = (threadIdx.x >> 5) * 64; seg < P; seg += 2 * kThreads) {
    uint64_t x0 = key[seg + lane], x1 = key[seg + 32 + lane];
    const int i0 = seg + lane, i1 = i0 + 32;
    for (int size = from; size <= to; size <<= 1)
      for (int stride = min(size >> 1, 32); stride > 0; stride >>= 1) {
        if (stride == 32) {  // the pair (i0, i1)
          if ((x0 > x1) == ((i0 & size) == 0)) {
            const uint64_t t = x0;
            x0 = x1;
            x1 = t;
          }
          continue;
        }
        const uint64_t y0 = __shfl_xor_sync(0xffffffffu, x0, stride);
        const uint64_t y1 = __shfl_xor_sync(0xffffffffu, x1, stride);
        const bool lower = (lane & stride) == 0;  // the pair's first index
        x0 = (lower == ((i0 & size) == 0)) == (x0 < y0) ? x0 : y0;
        x1 = (lower == ((i1 & size) == 0)) == (x1 < y1) ? x1 : y1;
      }
    key[seg + lane] = x0;
    key[seg + 32 + lane] = x1;
  }
}

// bitonic sort of key[0, P), P a power of two >= 64, ascending: strides of
// 64 and more through shared memory, one barrier each; below 64 in
// registers, one barrier per size.  Ends with a barrier.
__device__ __forceinline__ void bitonic_sort(uint64_t* key, int P) {
  const int tid = threadIdx.x;
  __syncthreads();
  bitonic_in_registers(key, P, 2, 64);
  for (int size = 128; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
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
    bitonic_in_registers(key, P, size, size);
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ordered pool as the scan reads it: position p's box and its index in
// the caller's pool.  In shared memory (the small form, path 2) it is read
// in place; from global memory (paths 1 and 3) it is staged.
struct SharedPool {
  static constexpr bool kStaged = false;
  const uint64_t* key;
  const float4* sb;
  __device__ float4 box(int p) const { return sb[p]; }
  __device__ int index(int p) const { return (int)(uint32_t)key[p]; }
};
struct InputPool {  // path 1: position p is pool slot p
  static constexpr bool kStaged = true;
  const float4* boxes;
  __device__ const float4* box_at(int p) const { return boxes + p; }
  __device__ int index(int p) const { return p; }
};
struct WorkspacePool {  // path 3: written by the cluster in this launch
  static constexpr bool kStaged = true;
  const float4* ws_box;
  const int* ws_idx;
  __device__ const float4* box_at(int p) const { return ws_box + p; }
  __device__ int index(int p) const { return __ldcg(ws_idx + p); }
};

// The scan's count, carried from path 2 into path 3 (shared memory).
struct ScanState {
  int n_kept, rounds, consumed;
};
// The kept boxes and their areas (shared memory, or global memory for more
// than kKeptShared kept boxes in the large form); a window's survivors in
// order; the stage of a staged pool, two windows.
struct ScanBuffers {
  float4* kbox;
  float* karea;
  float4* cbox;
  float* carea;
  int* cpos;
  int* cidx;
  float4* stage;
};

// Scan positions [begin, end) of the ordered pool by the whole block, begin
// a multiple of kWindow, st initialised and followed by a barrier.  Ends
// with a barrier.
template <class Pool>
__device__ __forceinline__ void scan(const Pool pool, int begin, int end,
                                     ScanBuffers sbuf, ScanState& st,
                                     int* keep_idx, bool* keep_valid,
                                     int max_det, float thr) {
  __shared__ uint64_t rows[kChunk];  // bit b of row a: kept a suppresses b
  __shared__ unsigned long long dead;  // chunk bits killed in this window
  __shared__ uint64_t kept_bits;       // chunk bits the walk kept
  __shared__ int warp_first[kThreads / 32], n_surv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) dead = 0;
  int next_idx = 0;
  if constexpr (Pool::kStaged) {
    if (begin + tid < end) {
      cp_async16(sbuf.stage + tid, pool.box_at(begin + tid));
      next_idx = pool.index(begin + tid);
    }
    cp_async_commit();
  }
  int buf = 0;
  for (int wbase = begin; wbase < end; wbase += kWindow, buf ^= 1) {
    const int nk = st.n_kept;
    if (nk >= max_det) break;
    const int m = min(kWindow, end - wbase);
    const int p = wbase + tid;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    int idx = 0;
    if constexpr (Pool::kStaged) {  // stage the next window, take this one
      idx = next_idx;
      if (p + kWindow < end) {
        cp_async16(sbuf.stage + (buf ^ 1) * kWindow + tid,
                   pool.box_at(p + kWindow));
        next_idx = pool.index(p + kWindow);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's own copy of this window's box
      if (tid < m) b = sbuf.stage[buf * kWindow + tid];
    } else if (tid < m) {
      b = pool.box(p);
      idx = pool.index(p);
    }
    // (1) the window against every box kept before it
    bool alive = tid < m;
    const float ab = area(b);
    for (int t = 0; t < nk && alive; ++t)
      alive = !suppresses(b, ab, sbuf.kbox[t], sbuf.karea[t], thr);
    // (2) the survivors compacted in order
    const unsigned bal = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) warp_first[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_first[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      warp_first[lane] = incl - v;
      if (lane == 31) n_surv = incl;
    }
    __syncthreads();
    if (alive) {
      const int at = warp_first[warp] + __popc(bal & ((1u << lane) - 1));
      sbuf.cbox[at] = b;
      sbuf.carea[at] = ab;
      sbuf.cpos[at] = p;
      sbuf.cidx[at] = idx;
    }
    if (tid == 0) ++st.rounds;
    __syncthreads();
    const int ns = n_surv;
    // (3) the survivors in chunks of 64
    for (int cb = 0; cb < ns; cb += kChunk) {
      const int nk2 = st.n_kept;
      if (nk2 >= max_det) break;
      const int mm = min(kChunk, ns - cb);
      {  // (a) the chunk's own rows: thread -> row tid / 16, 4 columns
        const int a = tid >> 4, c = tid & 15;
        unsigned bits = 0;
        if (a < mm) {
          const float4 ba = sbuf.cbox[cb + a];
          const float aa = sbuf.carea[cb + a];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = c + 16 * j;
            if (e > a && e < mm &&
                suppresses(sbuf.cbox[cb + e], sbuf.carea[cb + e], ba, aa,
                           thr))
              bits |= 1u << j;
          }
        }
        uint64_t r0 = 0, r1 = 0;  // rows 2 warp (lanes 0-15), 2 warp + 1
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bl = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
          r0 |= (uint64_t)(bl & 0xffffu) << (16 * j);
          r1 |= (uint64_t)(bl >> 16) << (16 * j);
        }
        if (lane == 0) {
          rows[2 * warp] = r0;
          rows[2 * warp + 1] = r1;
        }
      }
      {  // (b) candidate tid % 64 against the boxes kept in this window
        const int c = tid & (kChunk - 1);
        bool hit = false;
        if (c < mm) {
          const float4 bc = sbuf.cbox[cb + c];
          const float ac = sbuf.carea[cb + c];
          for (int t = nk + (tid >> 6); t < nk2 && !hit;
               t += kThreads / kChunk)
            hit = suppresses(bc, ac, sbuf.kbox[t], sbuf.karea[t], thr);
        }
        const uint32_t bl = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && bl)
          atomicOr(&dead, (unsigned long long)bl << (32 * (warp & 1)));
      }
      __syncthreads();
      if (warp == 0) {  // (c) the walk over the chunk's live bits
        uint64_t live = (mm == kChunk ? ~0ull : (1ull << mm) - 1) & ~dead;
        // a live candidate that suppresses no later live one is kept when
        // the walk reaches it and clears nothing: only the others are
        // walked, in order, each one still live clearing its row
        const uint64_t sup =
            __ballot_sync(0xffffffffu,
                          (live >> lane & 1) && (rows[lane] & live)) |
            (uint64_t)__ballot_sync(
                0xffffffffu, (live >> (lane + 32) & 1) &&
                                 (rows[lane + 32] & live))
                << 32;
        if (lane == 0) {
          for (uint64_t w = sup; w; w &= w - 1) {
            const int a = __ffsll((long long)w) - 1;
            if (live >> a & 1) {
              live &= ~rows[a];
              w &= live;
            }
          }
          // the walk stops at max_det kept: the first max_det - nk2 bits
          int n = nk2 + __popcll(live);
          for (; n > max_det; --n) live &= ~(1ull << (63 - __clzll(live)));
          if (n == max_det)
            st.consumed = sbuf.cpos[cb + 63 - __clzll(live)] + 1;
          kept_bits = live;
          st.n_kept = n;
          ++st.rounds;
          dead = 0;
        }
      }
      __syncthreads();
      if (tid < kChunk && (kept_bits >> tid & 1)) {  // (d) the kept boxes
        const int n = nk2 + __popcll(kept_bits & ((1ull << tid) - 1));
        sbuf.kbox[n] = sbuf.cbox[cb + tid];
        sbuf.karea[n] = sbuf.carea[cb + tid];
        keep_idx[n] = sbuf.cidx[cb + tid];
        keep_valid[n] = true;
      }
      __syncthreads();
    }
    if (tid == 0 && st.n_kept < max_det) st.consumed = wbase + m;
    __syncthreads();
  }
  if constexpr (Pool::kStaged) cp_async_wait<0>();
}

__device__ __forceinline__ void init_scan(ScanState& st) {
  if (threadIdx.x == 0) st = ScanState{0, 0, 0};
  __syncthreads();
}

// the rest of keep_idx / keep_valid, and stats: (rounds, consumed, kept,
// valid, path) per image
__device__ __forceinline__ void finish(const ScanState& st, int nvalid,
                                       int path, int* keep_idx,
                                       bool* keep_valid, int* stats, int img,
                                       int max_det) {
  for (int t = st.n_kept + threadIdx.x; t < max_det; t += kThreads) {
    keep_idx[t] = 0;
    keep_valid[t] = false;
  }
  if (stats && threadIdx.x == 0) {
    int* s = stats + 5 * img;
    s[0] = st.rounds;
    s[1] = st.consumed;
    s[2] = st.n_kept;
    s[3] = nvalid;
    s[4] = path;
  }
}

// Shared bytes of the scan's buffers with kept_smem kept boxes in shared
// memory (the stage lives elsewhere).
constexpr int scan_bytes(int kept_smem) {
  return kWindow * 28 + kept_smem * 20;
}

// The scan's buffers from at (16-byte aligned): cbox, kbox, carea, karea,
// cpos, cidx; kept boxes in global memory when kept_smem is 0.
__device__ __forceinline__ ScanBuffers scan_buffers(unsigned char* at,
                                                    int kept_smem,
                                                    float4* kbox_g,
                                                    float* karea_g,
                                                    float4* stage) {
  ScanBuffers s;
  s.cbox = reinterpret_cast<float4*>(at);
  float4* kb = s.cbox + kWindow;
  s.kbox = kept_smem ? kb : kbox_g;
  s.carea = reinterpret_cast<float*>(kb + kept_smem);
  s.karea = kept_smem ? s.carea + kWindow : karea_g;
  s.cpos = reinterpret_cast<int*>(s.carea + kWindow + kept_smem);
  s.cidx = s.cpos + kWindow;
  s.stage = stage;
  return s;
}

// Small form.  Dynamic shared memory: key[P], sorted boxes sb[P], then the
// scan's buffers (min(max_det, K) kept boxes).
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ keep_idx, bool* __restrict__ keep_valid,
           int* __restrict__ stats, int K, int P, int max_det, int kept_n,
           float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);  // [P]
  float4* sb = reinterpret_cast<float4*>(key + P);     // [P] sorted boxes
  __shared__ int n_valid;
  __shared__ ScanState st;
  const int img = blockIdx.x, tid = threadIdx.x;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;
  keep_idx += (size_t)img * max_det;
  keep_valid += (size_t)img * max_det;

  if (tid == 0) n_valid = 0;
  __syncthreads();
  const int nv = __reduce_add_sync(0xffffffffu,
                                   load_keys(key, scores, 0, K, P));
  if ((tid & 31) == 0 && nv) atomicAdd(&n_valid, nv);
  bitonic_sort(key, P);
  const int nvalid = n_valid;
  for (int p = tid; p < nvalid; p += kThreads) sb[p] = boxes[(uint32_t)key[p]];
  init_scan(st);
  const ScanBuffers sbuf = scan_buffers(
      reinterpret_cast<unsigned char*>(sb + P), kept_n, nullptr, nullptr,
      nullptr);
  scan(SharedPool{key, sb}, 0, nvalid, sbuf, st, keep_idx, keep_valid,
       max_det, iou_thres);
  finish(st, nvalid, 0, keep_idx, keep_valid, stats, img, max_det);
}

// Large form.  Dynamic shared memory: key[4096] (the block's run); a region
// that holds block 0's selection (kTopCap keys, then their boxes) or, in
// paths 1 and 3, the scan's stage; the scan's buffers.  Workspace per
// image: ws_box[K] and ws_idx[K] (path 3's ordered pool from kTop on) and,
// when kept_n > kKeptShared, the kept boxes and their areas.
constexpr int kSelBytes = kTopCap * 24 > 2 * kWindow * 16 ? kTopCap * 24
                                                           : 2 * kWindow * 16;
__constant__ int kDigitShift[6] = {56, 48, 40, 32, 8, 0};  // indices < 2^16

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms_kernel_large(const float4* __restrict__ boxes,
                 const float* __restrict__ scores, int* __restrict__ keep_idx,
                 bool* __restrict__ keep_valid, int* __restrict__ stats,
                 float4* ws_box, int* ws_idx, float4* kbox_g, float* karea_g,
                 int K, int max_det, int kept_n, float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);     // [4096]
  uint64_t* sel = key + kMaxPool;                         // [kTopCap]
  float4* sb = reinterpret_cast<float4*>(sel + kTopCap);  // [kTopCap]
  float4* stage = reinterpret_cast<float4*>(sel);         // [2 kWindow]
  __shared__ int ordered[kCluster], counts[kCluster];  // pushed by each block
  __shared__ int n_sel, go_on;                          // pushed by the others
  __shared__ int n_valid;                               // of this run
  __shared__ int hist[2][256], warp_sum[8], cross[3];
  __shared__ ScanState st;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.x / kCluster;
  boxes += (size_t)img * K;
  scores += (size_t)img * K;
  ws_box += (size_t)img * K;
  ws_idx += (size_t)img * K;
  kbox_g += (size_t)img * kept_n;
  karea_g += (size_t)img * kept_n;
  keep_idx += (size_t)img * max_det;
  keep_valid += (size_t)img * max_det;
  const ScanBuffers sbuf = scan_buffers(
      reinterpret_cast<unsigned char*>(sel) + kSelBytes,
      kept_n <= kKeptShared ? kept_n : 0, kbox_g, karea_g, stage);

  // 1. the run's keys, its valid count, and whether its slots are in order
  if (tid == 0) {
    n_valid = 0;
    n_sel = 0;
  }
  __syncthreads();
  const int first = r * kMaxPool;
  const int nv = __reduce_add_sync(
      0xffffffffu, load_keys(key, scores, first, K, kMaxPool));
  if ((tid & 31) == 0 && nv) atomicAdd(&n_valid, nv);
  __syncthreads();
  bool in_order = !(kSkip & kSkipCheck);
  for (int i = tid; i < kMaxPool && first + i + 1 < K; i += kThreads) {
    const uint32_t next = i + 1 < kMaxPool
                              ? (uint32_t)(key[i + 1] >> 32)
                              : score_bits(scores[first + kMaxPool]);
    in_order &= (uint32_t)(key[i] >> 32) <= next;
  }
  in_order = __syncthreads_and(in_order);
  if (tid < kCluster) {
    *cluster.map_shared_rank(&ordered[r], tid) = in_order;
    *cluster.map_shared_rank(&counts[r], tid) = n_valid;
  }
  cluster.sync();
  int nvalid = 0;
  bool all_in_order = true;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    nvalid += counts[q];
    all_in_order &= ordered[q] != 0;
  }
  if (all_in_order) {  // path 1: position p is slot p
    if (r != 0) return;
    init_scan(st);
    if (!(kSkip & kSkipScan))
      scan(InputPool{boxes}, 0, nvalid, sbuf, st, keep_idx, keep_valid,
           max_det, iou_thres);
    finish(st, nvalid, 1, keep_idx, keep_valid, stats, img, max_det);
    return;
  }

  // 2. the cluster selects the first n_top keys of the whole order, those
  // <= top; all blocks take the same decisions from the same histograms
  uint64_t top = kInvalid - 1;  // every valid key, if they fit
  int n_top = nvalid;
  if (nvalid > kTopCap) {
    uint64_t prefix = 0, fixed = 0;  // digits decided so far, their mask
    int below = 0;                   // keys below the prefix
    for (int d = 0; d < 6; ++d) {
      const int shift = kDigitShift[d];
      int* h = hist[d & 1];  // the other one may still be read remotely
      if (tid < 256) h[tid] = 0;
      __syncthreads();
      for (int i = tid; i < kMaxPool; i += kThreads) {
        const uint64_t k = key[i];
        const int digit = (k & fixed) == prefix ? (int)(k >> shift) & 255
                                                 : 256;
        const unsigned same = __match_any_sync(0xffffffffu, digit);
        if (digit < 256 && lane == __ffs(same) - 1)
          atomicAdd(&h[digit], __popc(same));
      }
      cluster.sync();  // every block's histogram complete
      int tot = 0, incl = 0;
      if (tid < 256) {
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          tot += cluster.map_shared_rank(h, q)[tid];
        incl = tot;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        if (lane == 31) warp_sum[warp] = incl;
      }
      __syncthreads();
      if (tid < 256) {
        for (int w = 0; w < warp; ++w) incl += warp_sum[w];
        // the bucket where the count of keys first reaches kTop
        if (below + incl >= kTop && below + incl - tot < kTop) {
          cross[0] = tid;
          cross[1] = incl;
          cross[2] = incl - tot;
        }
      }
      __syncthreads();
      const uint64_t digit = (uint64_t)cross[0] << shift;
      if (below + cross[1] <= kTopCap) {  // always so at the last digit
        top = prefix | digit | ((1ull << shift) - 1);
        n_top = below + cross[1];
        break;
      }
      below += cross[2];
      prefix |= digit;
      fixed |= 0xffull << shift;
    }
  }
  {  // every block puts its selected keys into block 0's sel
    uint64_t* sel0 = cluster.map_shared_rank(sel, 0);
    int* n_sel0 = cluster.map_shared_rank(&n_sel, 0);
    for (int i = tid; i < kMaxPool; i += kThreads) {
      const uint64_t k = key[i];
      const bool pick = k <= top;
      const unsigned bal = __ballot_sync(0xffffffffu, pick);
      int at = 0;
      if (lane == 0 && bal) at = atomicAdd(n_sel0, __popc(bal));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (pick) sel0[at + __popc(bal & ((1u << lane) - 1))] = k;
    }
  }
  cluster.sync();  // block 0 holds the n_top selected keys

  // path 2: block 0 sorts the selection and scans its first kTop positions
  // (every valid one, when they all fit)
  const int end2 = nvalid <= kTopCap ? nvalid : kTop;
  if (r == 0) {
    int P = 64;
    while (P < n_top) P <<= 1;
    for (int i = n_top + tid; i < P; i += kThreads) sel[i] = ~0ull;
    __syncthreads();
    if (!(kSkip & kSkipTopSort)) bitonic_sort(sel, P);
    for (int p = tid; p < n_top; p += kThreads)
      sb[p] = boxes[(uint32_t)sel[p]];
    init_scan(st);
    if (!(kSkip & kSkipScan))
      scan(SharedPool{sel, sb}, 0, end2, sbuf, st, keep_idx, keep_valid,
           max_det, iou_thres);
    const int more = st.n_kept < max_det && end2 < nvalid;
    if (tid < kCluster) *cluster.map_shared_rank(&go_on, tid) = more;
  }
  cluster.sync();  // every block knows whether path 3 follows
  if (!go_on) {
    if (r == 0)
      finish(st, nvalid, 2, keep_idx, keep_valid, stats, img, max_det);
    return;
  }

  // 3. path 3: every run sorted and ranked across the cluster, positions
  // from kTop on written to the workspace; block 0 scans on from kTop
  if (first < K && !(kSkip & kSkipRunSort)) {
    bitonic_sort(key, kMaxPool);
  } else {
    __syncthreads();  // all padding: sorted already
  }
  cluster.sync();  // every run sorted
  const uint64_t* runs[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) runs[q] = cluster.map_shared_rank(key, q);
  const int mine = n_valid;  // valid keys sort first in the run
  for (int i = tid; i < mine; i += kThreads) {
    const uint64_t k = key[i];
    int place = i;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      if (q == r || (kSkip & kSkipMerge)) continue;
      const uint64_t* run = runs[q];
      int pos = 0;  // lower bound: keys of run q below k
#pragma unroll
      for (int step = kMaxPool / 2; step > 0; step >>= 1)
        if (run[pos + step - 1] < k) pos += step;
      place += pos + (run[pos] < k);
    }
    if (place < kTop || (kSkip & kSkipWrite)) continue;
    const int s_i = (int)(uint32_t)k;
    ws_box[place] = boxes[s_i];
    ws_idx[place] = s_i;
  }
  __threadfence();
  cluster.sync();  // the workspace is complete; no block reads another's
                   // shared memory past here
  if (r != 0) return;
  if (!(kSkip & kSkipScan))
    scan(WorkspacePool{ws_box, ws_idx}, kTop, nvalid, sbuf, st, keep_idx,
         keep_valid, max_det, iou_thres);
  finish(st, nvalid, 3, keep_idx, keep_valid, stats, img, max_det);
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32 xyxy with the class offset applied, 16-byte aligned;
// scores (B, K) f32 with -inf for invalid candidates; keep_idx (B, max_det)
// int32 and keep_valid (B, max_det) bool.  1 <= K <= 30000, max_det >= 1.
// stats, when not null, (B, 5) int32: per image the scan's dependent steps
// (windows plus chunks), the ordered candidates it consumed (up to the
// max_det-th kept box, else all valid ones), the boxes kept, the valid
// candidates and the path (0 small form, 1 in order, 2 selected top, 3
// cluster sort).  workspace, for K > 4096 only (else unused, may be null):
// 16-byte aligned, the ordered pools' boxes (B K x 16 bytes) and indices
// (B K x 4, rounded up to a multiple of 16) and, when min(max_det, K) >
// 1024, the kept boxes and areas (B min(max_det, K) x 20).
int nms_greedy_forward(const void* boxes, const void* scores, void* keep_idx,
                       void* keep_valid, void* stats, void* workspace, int B,
                       int K, int max_det, float iou_thres, void* stream) {
  if (K < 1 || K > kMaxLarge || max_det < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static unsigned sized[2];  // per form: devices whose limit is raised
  cudaError_t e;
  const int kept_n = max_det < K ? max_det : K;
  if (K <= kMaxPool) {
    int P = 64;  // the sort's width: a power of two >= 64
    while (P < K) P <<= 1;
    e = allow_smem(nms_kernel, kMaxPool * 24 + scan_bytes(kMaxPool),
                   sized[0]);
    if (e != cudaSuccess) return (int)e;
    nms_kernel<<<B, kThreads, P * 24 + scan_bytes(kept_n), st>>>(
        (const float4*)boxes, (const float*)scores, (int*)keep_idx,
        (bool*)keep_valid, (int*)stats, K, P, max_det, kept_n, iou_thres);
    return (int)cudaGetLastError();
  }
  if (!workspace) return (int)cudaErrorInvalidValue;
  const int base = kMaxPool * 8 + kSelBytes;
  e = allow_smem(nms_kernel_large, base + scan_bytes(kKeptShared), sized[1]);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * K;
  float4* ws_box = (float4*)workspace;
  int* ws_idx = (int*)(ws_box + n);
  float4* kbox_g = (float4*)((char*)ws_idx + (n * 4 + 15) / 16 * 16);
  float* karea_g = (float*)(kbox_g + (size_t)B * kept_n);
  nms_kernel_large<<<B * kCluster, kThreads,
                     base + scan_bytes(kept_n <= kKeptShared ? kept_n : 0),
                     st>>>(
      (const float4*)boxes, (const float*)scores, (int*)keep_idx,
      (bool*)keep_valid, (int*)stats, ws_box, ws_idx, kbox_g, karea_g, K,
      max_det, kept_n, iou_thres);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
