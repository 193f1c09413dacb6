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
// far above the card's 295 FLOP per byte.  So the design feeds the tensor
// cores and keeps everything else off their path:
//   * 16 x 16 output tiles.  A tile's (16 + 4)^2 input with its two-pixel
//     halo comes to shared memory; conv1 recomputes its one-pixel halo, an
//     18 x 18 intermediate tile (324 pixels, 6 m64 row tiles: 1.5x the
//     tile's own conv1 work, 1.25x over both convs), kept in shared memory
//     in bf16 with the pixels outside the image zeroed; conv2 reads it.
//     Both convs are implicit GEMMs: M the tile's pixels, N all C output
//     channels, K 9 taps x C input channels.
//   * Persistent blocks, one per SM (the shared memory below allows one),
//     each walking the (image, tile row, tile column) tiles t = block,
//     block + grid, ...; so any batch size runs on one grid.
//   * Warp specialisation: one thread of a producer warpgroup issues every
//     copy by TMA (setmaxnreg gives the producer's registers to the two
//     consumer warpgroups).  The input tile is one 4-D TMA box (64
//     channels, 20, 20, 1) over (C, W, H, B) per 64 channels, started at
//     (x0 - 2, y0 - 2): TMA fills what lies outside the image with zeros,
//     so the input's SAME padding costs nothing.  Under the 128-byte
//     swizzle a 64-channel pixel is one 128-byte row whose 16-byte chunks
//     are XOR-ed with the pixel's low three bits, so ldmatrix's eight rows
//     fall in eight bank groups.  The weights come as (64 ci, C co) boxes
//     of the (9 C, C) [tap][co][ci] view into a ring of stages, one stage
//     per (tap, 64 input channels) of a round of products.  Each ring stage
//     and each input buffer has a full and an empty mbarrier; no barrier
//     of the whole block remains after set-up.  The next tile's input loads
//     while this tile computes: into a second buffer at C = 64 (from the
//     start of the tile), into the same buffer at C = 128 once conv1 has
//     read it (conv2, 45% of a tile's products, covers the load).
//   * The products: wgmma m64nCk16 with A from registers and B, the weight
//     stage, by descriptor ("RS").  ldmatrix.x4 of a tap's shifted pixels
//     (any dy, dx: each lane names its own pixel row) is exactly a warp's A
//     fragment of the warpgroup's m64 tile.  Warpgroup g owns m64 tiles
//     3g .. 3g + 2 of conv1 and 2g, 2g + 1 of conv2, their f32 sums in
//     registers across the nine taps (at C = 128 conv1 runs in two rounds,
//     2 tiles then 1, so that 2 x 64 sums a thread fit).  A stage is two
//     groups of two k16 steps, each group committed by itself; the A
//     fragments are double-buffered in registers, so the next group's
//     ldmatrix runs while the one group left in flight multiplies.
//   * The epilogue: SiLU in f32 (v / (1 + exp(-v)), ex2.approx and a fast
//     quotient), bf16.  conv1 writes the intermediate tile by stmatrix
//     (zero outside the image; a warp whose rows all lie past its 324
//     pixels skips it); conv2 writes the output 16 bytes a lane after a
//     transpose within each quad of lanes, masked at the ragged edge.  The
//     consumers' named barriers order the intermediate tile: warpgroup 0's
//     conv2 reads only rows it wrote itself, so only warpgroup 1 waits for
//     the other's rows, and only warpgroup 0 waits, before writing the next
//     tile's rows, for warpgroup 1's conv2 to have read them.
// What limits it now (chip_profile.py p1_phases, PERF.md): the products
// and their operand reads.  Each m64n64k16 reads 4 KB of shared memory (A
// by ldmatrix, B by wgmma) for 131 kFLOP, which at 128 bytes a clock is
// the tensor cores' own rate, so at C = 64 shared-memory bandwidth shares
// the bound with the tensor cores; N = 128 at C = 128 reads 6 KB per 262.
// Shared memory: C = 64: two input buffers 2 x 51200, the intermediate
// 41472 (41984 with a spare row, aligned), 8 weight stages of 8 KB: 211104
// bytes with barriers and alignment.  C = 128: one input buffer 102400 (two
// 64-channel halves), the intermediate 82944 (83968), 2 weight stages of
// 16 KB: 220208 bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (mmidet_tpu_torch/kernels.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kT = 16;            // output tile: kT x kT pixels
constexpr int kMid = kT + 2;      // the intermediate tile's side
constexpr int kIn = kT + 4;       // the input tile's side
constexpr int kM1 = kMid * kMid;  // conv1's pixels: 324, 6 m64 tiles
constexpr int kM2 = kT * kT;      // conv2's pixels: 256, 4 m64 tiles
constexpr int kRow = 128;         // bytes of a pixel's 64 channels
constexpr int kInHalf = kIn * kIn * kRow;    // 51200
constexpr int kMidHalf = kM1 * kRow;         // 41472
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer's

// measurement only (chip_profile.py p1): bits of the consumers' work the
// kernel leaves out, 0 in the port's build.  1 the products, 2 the A
// loads, 4 SiLU, 8 the epilogue's stores.
#ifndef P1_SKIP
#define P1_SKIP 0
#endif
constexpr int kSkip = P1_SKIP;
// the products' groups: k16 steps a committed wgmma group (a stage is
// four), groups of A fragments held in registers
constexpr int kKB = 2, kNB = 2;

enum {
  kErrNoEncoder = 30001,  // no cuTensorMapEncodeTiled entry point found
  kErrTensorMap = 30002,  // cuTensorMapEncodeTiled refused a tensor
};

template <int C>
struct Traits {
  static constexpr int kHalves = C / 64;   // 64-channel halves of K
  static constexpr int kN = C;             // output channels a product
  static constexpr int kBufs = C == 64 ? 2 : 1;     // input buffers
  static constexpr int kRing = C == 64 ? 8 : 2;     // weight stages
  static constexpr int kStageBytes = 64 * kN * 2;   // one (64, C) box
  static constexpr int kInBytes = kHalves * kInHalf;
  // the halves and a spare row that takes the stores of rows past the tile
  static constexpr int kMidBytes =
      (kHalves * kMidHalf + kRow + 1023) / 1024 * 1024;
  static constexpr int kMidOff = kBufs * kInBytes;
  static constexpr int kRingOff = kMidOff + kMidBytes;
  static constexpr int kBarOff = kRingOff + kRing * kStageBytes;
  // a warpgroup's m64 tiles a round (kN / 2 sums each a thread); conv1's
  // three in kRounds1 rounds, conv2's two in one
  static constexpr int kNT = C == 64 ? 3 : 2;
  static constexpr int kRounds1 = (3 + kNT - 1) / kNT;
  static constexpr int kJob = 9 * kHalves;  // stages a round
  static constexpr int kTile = (kRounds1 + 1) * kJob;
  // the stage before which the producer loads the next tile's input: at
  // once into the other buffer; into the same buffer once the ring holds
  // conv2's first stages (their wait implies conv1 has read the input)
  static constexpr int kInputAt = kBufs == 2 ? 0 : kRounds1 * kJob + kRing;
  static constexpr size_t kBytes =
      kBarOff + (size_t)(2 * kBufs + 2 * kRing) * 8 + 1024;
  static_assert(kInputAt < kTile, "the next input must load in the tile");
  static_assert(kBytes <= 232448, "one block's shared memory");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// byte offset of 16-byte chunk j (of 8) of row p in a region of 128-byte
// rows under the 128-byte swizzle (the region 1024-byte aligned where TMA
// writes it)
__device__ __forceinline__ uint32_t swz(int p, int j) {
  return (uint32_t)(p * kRow + ((j ^ (p & 7)) << 4));
}

// f32 SiLU, v / (1 + exp(-v)): ex2.approx and rcp.approx, a relative error
// of a few f32 ulps for v > -87 (about 1e-6 at |v| = 12), on either side of
// zero; below -87, where |silu(v)| < 1e-35, it gives 0.  (The quotient-free
// (1 + tanh(v / 2)) / 2 form loses v < 0 to cancellation: 10% at v = -6.)
__device__ __forceinline__ float silu(float v) {
  if (kSkip & 4) return v;
  return __fdividef(v, 1.f + __expf(-v));
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Named barriers of the consumers: kBarMidReady and kBarMidFree between the
// two warpgroups (256 threads: one side arrives, the other waits);
// kBarWg0, kBarWg1 one warpgroup's own 128 threads.
enum { kBarMidReady = 1, kBarMidFree, kBarWg0, kBarWg1 };
__device__ __forceinline__ void named_sync(int id, int n = kConsumers) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers)
               : "memory");
}

// A 4 x 4 transpose within each quad of lanes: u holds a lane's packed
// bf16 pairs of one row, channels 8 j + 2 q, + 1 (the layout below); lane
// q gets the 8 channels 32 grp + 8 q .. + 7, one 16-byte store.  In round
// r lane q sends its pair of block q ^ r and receives lane (q ^ r)'s pair
// of block q.
template <int NJ>
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&u)[NJ],
                                                int grp, int q) {
  uint32_t o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = q ^ r;
    uint32_t x = u[4 * grp];
    x = j == 1 ? u[4 * grp + 1] : x;
    x = j == 2 ? u[4 * grp + 2] : x;
    x = j == 3 ? u[4 * grp + 3] : x;
    const uint32_t y = r ? __shfl_xor_sync(0xffffffffu, x, r) : x;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p == j) o[p] = y;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The pixel of the source tile (width kSW) that row m of the destination
// (width kDW, kM pixels) reads at tap (dy, dx); rows past kM read any
// pixel and are never stored.
template <int kSW, int kDW, int kM>
__device__ __forceinline__ int tap_pixel(int m, int dy, int dx) {
  m = min(m, kM - 1);
  return (m / kDW + dy) * kSW + m % kDW + dx;
}

// Fragment layouts (per lane: g = lane / 4, t = lane % 4): A 16x16 as
// mma.sync m16n8k16's; the sums of warp w of a warpgroup, for its m16 tile
// of an m64 tile, in acc[4j .. 4j + 3]: columns 8j + 2t, 8j + 2t + 1 of
// rows g and g + 8 (wgmma's layout).

// The products of one weight stage (one tap, 64 input channels, N output
// channels) for the warpgroup's m64 tiles mt0 .. mt0 + NT - 1: acc[i] +=
// A_i (shifted pixels of src) x W_stage^T.  NT is a template argument:
// wgmma under a condition that the compiler cannot prove uniform is
// serialised (ptxas C7520).
template <int kSW, int kDW, int kM, int N>
struct Stage {
  // a holds kNB groups of the A fragments of kKB k16 steps, kept across
  // stages by the caller; a stage is 4 / kKB groups of products, each
  // committed as a wgmma group, kNB - 1 groups left in flight while the
  // next group's A loads.  release: the previous stage's empty barrier,
  // arrived at once that stage's last group has retired.
  template <int NT, int NA>
  static __device__ __forceinline__ void run(
      float (&acc)[NA][N / 2], uint32_t (&a)[kNB][kKB][NA][4], uint32_t src,
      uint32_t wst, int tap, int mt0, int wq, int lane, uint64_t* release,
      bool leader) {
    static_assert((4 / kKB) % kNB == 0 && 4 / kKB > kNB - 2, "groups");
    const int dy = tap / 3, dx = tap % 3;
    int pix[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      pix[i] = tap_pixel<kSW, kDW, kM>(
          ((mt0 + i) * 4 + wq) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
          dy, dx);
    const int ahi = lane >> 4;
#pragma unroll
    for (int bt = 0; bt < 4 / kKB; ++bt) {
      const int buf = bt % kNB;
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int i = 0; i < NT; ++i)
          if (!(kSkip & 2))
            ldsm_x4(a[buf][kb][i],
                    src + swz(pix[i], 2 * (bt * kKB + kb) + ahi));
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int i = 0; i < NT; ++i)
          if (!(kSkip & 1))
            wgmma_bf16_rs<N>(acc[i], a[buf][kb][i],
                             wgmma_desc(wst + 32 * (bt * kKB + kb)));
      wgmma_commit();
      wgmma_wait<kNB - 1>();
      // the group kNB - 1 before this one has retired: its buffer is free
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int i = 0; i < NT; ++i) fence_regs(a[(bt + 1) % kNB][kb][i]);
      if (bt == kNB - 2 && release != nullptr && leader) mbar_arrive(release);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
conv_chain_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw1,
                  const __grid_constant__ CUtensorMap tmw2,
                  uint16_t* __restrict__ out, int H, int W, int tiles_x,
                  int tiles_per_image, int tiles) {
  using S = Traits<C>;
  constexpr int kH = S::kHalves, kN = S::kN, kNT = S::kNT;
  // the m64 tiles of conv1's last round where it has two (C = 128)
  constexpr int kNT1 = 3 % kNT ? 3 % kNT : kNT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t xs = smem_u32(sm);
  const uint32_t ms = xs + S::kMidOff;
  const uint32_t ring = xs + S::kRingOff;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sm + S::kBarOff);
  uint64_t* xempty = xfull + S::kBufs;
  uint64_t* wfull = xempty + S::kBufs;
  uint64_t* wempty = wfull + S::kRing;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int b = 0; b < S::kBufs; ++b) {
      mbar_init(&xfull[b], 1);
      mbar_init(&xempty[b], kConsumers / 32);  // each consumer warp
    }
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 2);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer: one thread issues copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != kConsumers) return;
    const CUtensorMap* mx = &tmx;
    const CUtensorMap* mw1 = &tmw1;
    const CUtensorMap* mw2 = &tmw2;
    // tile k of this block into its input buffer: each 64-channel half as
    // one box from (x0 - 2, y0 - 2), zeros outside the image
    auto load_input = [=](int t, int k) {
      const int buf = k % S::kBufs;
      if (k >= S::kBufs) mbar_wait(&xempty[buf], (k / S::kBufs - 1) & 1);
      const int b = t / tiles_per_image, r = t % tiles_per_image;
      const int y0 = (r / tiles_x) * kT, x0 = (r % tiles_x) * kT;
      mbar_expect_tx(&xfull[buf], S::kInBytes);
      for (int h = 0; h < kH; ++h)
        tma_load_4d(sm + buf * S::kInBytes + h * kInHalf, mx, &xfull[buf],
                    64 * h, x0 - 2, y0 - 2, b);
    };
    int s = 0;
    if ((int)blockIdx.x < tiles) load_input(blockIdx.x, 0);
    for (int t = blockIdx.x, k = 0; t < tiles; t += gridDim.x, ++k) {
      for (int q = 0; q < S::kTile; ++q, ++s) {
        if (q == S::kInputAt && t + (int)gridDim.x < tiles)
          load_input(t + gridDim.x, k + 1);
        // stage q: conv1's rounds, then conv2's; tap, 64 input channels
        const bool conv2 = q >= S::kRounds1 * S::kJob;
        const int j = q % S::kJob, tap = j / kH, half = j % kH;
        const int slot = s % S::kRing;
        if (s >= S::kRing) mbar_wait(&wempty[slot], (s / S::kRing - 1) & 1);
        mbar_expect_tx(&wfull[slot], S::kStageBytes);
        tma_load_2d(sm + S::kRingOff + slot * S::kStageBytes,
                    conv2 ? mw2 : mw1, &wfull[slot], 64 * half, tap * C);
      }
    }
    return;
  }

  // the consumers: warpgroup wg, its warp wq
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = (tid & 127) == 0;
  float acc[kNT][kN / 2];
  uint32_t afr[kNB][kKB][kNT][4] = {};
  int s = 0;
  for (int t = blockIdx.x, k = 0; t < tiles; t += gridDim.x, ++k) {
    const int b = t / tiles_per_image, r = t % tiles_per_image;
    const int ty0 = (r / tiles_x) * kT, tx0 = (r % tiles_x) * kT;
    const size_t img = (size_t)b * H * W;
    const int buf = k % S::kBufs;
    const uint32_t xin = xs + buf * S::kInBytes;
    const bool next = t + (int)gridDim.x < tiles;
    mbar_wait(&xfull[buf], (k / S::kBufs) & 1);

#pragma unroll 1
    for (int job = 0; job <= S::kRounds1; ++job) {
      // conv1's rounds of m64 tiles 3 wg + kNT job .., then conv2's
      const bool c1 = job < S::kRounds1;
      const int mt0 = c1 ? 3 * wg + kNT * job : 2 * wg;
      const int nt = c1 ? min(kNT, 3 - kNT * job) : 2;
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int i = 0; i < kNT; ++i) fence_regs(acc[i]);
      uint64_t* pending = nullptr;  // the stage the last wait left busy
#pragma unroll 1
      for (int j = 0; j < S::kJob; ++j, ++s) {
        const int tap = j / kH, half = j % kH;
        const int slot = s % S::kRing;
        const uint32_t wst = ring + slot * S::kStageBytes;
        mbar_wait(&wfull[slot], (s / S::kRing) & 1);
        using S1 = Stage<kIn, kMid, kM1, kN>;
        using S2 = Stage<kMid, kT, kM2, kN>;
        const uint32_t x1 = xin + half * kInHalf, y1 = ms + half * kMidHalf;
        if (c1 && nt == kNT)
          S1::template run<kNT>(acc, afr, x1, wst, tap, mt0, wq, lane,
                                pending, leader);
        else if (c1)
          S1::template run<kNT1>(acc, afr, x1, wst, tap, mt0, wq, lane,
                                 pending, leader);
        else
          S2::template run<2>(acc, afr, y1, wst, tap, mt0, wq, lane, pending,
                              leader);
        pending = &wempty[slot];
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kNT; ++i) fence_regs(acc[i]);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
          for (int i = 0; i < kNT; ++i) fence_regs(afr[nb][kb][i]);
      if (leader) mbar_arrive(pending);
      if (job == S::kRounds1 - 1) {  // conv1 has read the input
        __syncwarp();
        if (lane == 0) mbar_arrive(&xempty[buf]);
      }
      // warpgroup 1's conv2 has read the intermediate tile (it is the
      // only reader of rows the other warpgroup writes next)
      if (!c1 && wg == 1 && next) named_arrive(kBarMidFree);
      if (job == 0 && k > 0) {  // before this tile's intermediate rows
        if (wg == 0)
          named_sync(kBarMidFree);  // and every warp of it past its conv2
        else
          named_sync(kBarWg1, 128);  // every warp of it past its conv2
      }

      // the round's epilogue: SiLU in f32, bf16; conv1 into the
      // intermediate tile (zero outside the image), conv2 to the output
      // (masked at the ragged edge)
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (i >= nt) continue;
        const int mt = (mt0 + i) * 4 + wq;  // the warp's m16 tile
        if (c1 && mt * 16 >= kM1) continue;  // all its rows past the tile
        uint32_t u[2][kN / 8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jn = 0; jn < kN / 8; ++jn)
            u[h][jn] = pack2f(silu(acc[i][4 * jn + 2 * h]),
                              silu(acc[i][4 * jn + 2 * h + 1]));
        if (c1) {
          // zero the rows outside the image, then stmatrix.x4: lane l
          // names row l % 8 of matrix l / 8 = (h, chunk 2c + l / 16)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + g + 8 * h;
            const int gy = ty0 - 1 + m / kMid, gx = tx0 - 1 + m % kMid;
            if (gy < 0 || gy >= H || gx < 0 || gx >= W)
#pragma unroll
              for (int jn = 0; jn < kN / 8; ++jn) u[h][jn] = 0u;
          }
          const int ma = mt * 16 + 8 * ((lane >> 3) & 1) + (lane & 7);
          const int jhi = lane >> 4;
#pragma unroll
          for (int c = 0; c < kN / 16; ++c) {
            if (kSkip & 8) continue;
            const int jn = 2 * c + jhi;  // channels 8 jn .. 8 jn + 7
            // rows past the tile go to a spare row after the halves
            const uint32_t addr =
                ma < kM1 ? ms + (jn >> 3) * kMidHalf + swz(ma, jn & 7)
                         : ms + kH * kMidHalf + ((jn & 7) << 4);
            stsm_x4(addr, u[0][2 * c], u[1][2 * c], u[0][2 * c + 1],
                    u[1][2 * c + 1]);
          }
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          const int gy = ty0 + m / kT, gx = tx0 + m % kT;
#pragma unroll
          for (int grp = 0; grp < kN / 32; ++grp) {
            const uint4 v = quad_transpose(u[h], grp, q);
            if (!(kSkip & 8) && gy < H && gx < W)
              *reinterpret_cast<uint4*>(
                  out + (img + (size_t)gy * W + gx) * C +
                  8 * (4 * grp + q)) = v;
          }
        }
      }
      // the intermediate tile is whole: warpgroup 0's own warps wait for
      // each other, warpgroup 1 waits for both
      if (job == S::kRounds1 - 1) {
        if (wg == 0) {
          named_sync(kBarWg0, 128);
          named_arrive(kBarMidReady);
        } else {
          named_sync(kBarMidReady);
        }
      }
    }
  }
}

// a bf16 tensor map of `rank` dims (innermost first), 128-byte swizzle,
// zeros outside the tensor
int encode(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
           const cuuint32_t* box) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return kErrNoEncoder;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// blocks, tiles, shared-memory bytes a block, weight stages, input buffers
void config(int B, int H, int W, int C, int (&cfg)[5]) {
  const long tiles = (long)B * ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  cfg[1] = tiles > 0x7fffffffL ? -1 : (int)tiles;
  cfg[0] = (int)(tiles < sm_count() ? tiles : sm_count());
  const bool c64 = C == 64;
  cfg[2] = (int)(c64 ? Traits<64>::kBytes : Traits<128>::kBytes);
  cfg[3] = c64 ? Traits<64>::kRing : Traits<128>::kRing;
  cfg[4] = c64 ? Traits<64>::kBufs : Traits<128>::kBufs;
}

template <int C>
int launch(const void* x, const void* w1, const void* w2, void* out, int B,
           int H, int W, cudaStream_t st) {
  CUtensorMap tmx, tmw1, tmw2;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint32_t xbox[4] = {64, kIn, kIn, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)Traits<C>::kN};
  int e = encode(&tmx, x, 4, xdims, xbox);
  if (!e) e = encode(&tmw1, w1, 2, wdims, wbox);
  if (!e) e = encode(&tmw2, w2, 2, wdims, wbox);
  if (e) return e;
  int cfg[5];
  config(B, H, W, C, cfg);
  static unsigned sized = 0;  // devices whose limit is raised
  const cudaError_t ce =
      allow_smem(conv_chain_kernel<C>, Traits<C>::kBytes, sized);
  if (ce != cudaSuccess) return (int)ce;
  const int tiles_x = (W + kT - 1) / kT;
  conv_chain_kernel<C><<<cfg[0], kThreads, Traits<C>::kBytes, st>>>(
      tmx, tmw1, tmw2, (uint16_t*)out, H, W, tiles_x,
      tiles_x * ((H + kT - 1) / kT), cfg[1]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (B, H, W, C) bf16, contiguous, 16-byte aligned; w1, w2: (9, C, C)
// bf16 as [tap = 3 dy + dx][co][ci] (the HWIO weights, each tap
// transposed).  C is 64 or 128; any B, H, W >= 1 with fewer than 2^31
// 16 x 16 tiles.  Returns the first error, or 0.
int conv_chain_forward(const void* x, const void* w1, const void* w2,
                       void* out, int B, int H, int W, int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (C != 64 && C != 128))
    return (int)cudaErrorInvalidValue;
  int cfg[5];
  config(B, H, W, C, cfg);
  if (cfg[1] < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return C == 64 ? launch<64>(x, w1, w2, out, B, H, W, st)
                 : launch<128>(x, w1, w2, out, B, H, W, st);
}

// The launch's shape for (B, H, W, C): out[0] persistent blocks, out[1]
// tiles (-1 past 2^31 - 1), out[2] shared-memory bytes a block, out[3]
// weight stages in the ring, out[4] input buffers.
int conv_chain_config(int B, int H, int W, int C, int* out) {
  if (B < 1 || H < 1 || W < 1 || (C != 64 && C != 128))
    return (int)cudaErrorInvalidValue;
  int cfg[5];
  config(B, H, W, C, cfg);
  for (int i = 0; i < 5; ++i) out[i] = cfg[i];
  return 0;
}

const char* error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "no cuTensorMapEncodeTiled entry point found";
    case kErrTensorMap:
      return "cuTensorMapEncodeTiled refused a tensor (16-byte aligned "
             "addresses and strides needed)";
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
