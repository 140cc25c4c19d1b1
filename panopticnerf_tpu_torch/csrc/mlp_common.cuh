// Device code shared by the trunk kernels (mlp_train.cu: B, B') and the
// whole-field kernels (field_train.cu: C, C'), for NVIDIA Hopper (sm_90a).
//
// - the forward tile engine (kernel B, and C's trunk and heads), written
//   for Hopper with wgmma, TMA and mbarrier rings (hopper.cuh): persistent
//   over 128-point tiles, a producer warpgroup streaming every packed
//   weight by TMA, two consumer warpgroups of 64 points each keeping the
//   tile's [h | x] in shared memory as wgmma's A operand, each epilogue's
//   bf16 result stored back into it by stmatrix and saved by a TMA store
//   that overlaps the next layer's products;
// - the trunk's backward (kernel B', also the trunk half of C'), three
//   passes written the same way: a persistent data pass over 128-point
//   tiles, a split-K weight pass that also serves C''s head blocks, and
//   in-order reductions; dW written as bf16 or as float32.
//
// What bounds the forward: ~1 MFLOP per point at W = 256, L = 8 (0.26 ms
// of tensor-core time at 262,144 points), against the 4,096 bytes per
// point of saved activations (0.32 ms at HBM's rate): the design floor is
// the stores, which the engine overlaps with the products; the packed
// weights are read again for every tile, from L2.
// What bounds the trunk's backward: at W = 256, L = 8 the three-pass plan
// moves ~9.3 KB per point in the data pass (the f32 upstream g, 8 masks
// read from the saved activations, 8 bf16 g written, dx) and ~7.9 KB in
// the weight pass (7 activations, x twice, 8 bf16 g) against ~2 MFLOP of
// products: HBM bound on the H100 (0.73 + 0.62 ms at 262,144 points). What
// the design does about it: TMA moves every tile (weights, masks, g, the
// bf16 g out) with no thread spending registers or instructions on the
// copy; the mask of the next epilogue and the next weight chunks load
// while the tensor cores work; the products are wgmma from shared memory
// (the data pass keeps the tile's bf16 g there as the A operand, one
// layer to the next); one block per SM keeps many bytes in flight.
//
// Everything sits in an anonymous namespace: each .cu file that includes
// it compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;  // points per tile (forward, backward data passes)
constexpr int kFPad = 64; // x_enc columns

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // keeps NaN

__device__ __forceinline__ void store_val(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

// -------------------------------------------------- warp-specialised kernels

// The kernels below are warp-specialised: warpgroup 0 produces (its
// warps 0 and 1 issue TMA loads, one lane each), warpgroups 1 and 2
// consume (wgmma, epilogues); setmaxnreg moves registers from the
// producers to the consumers. The split must fit the pool the block
// launches with, 384 x 168 registers (128 x 56 + 256 x 224 = 64,512; a
// split that needs more waits for registers that never come). Every ring
// stage is released by the 8 consumer warps.
constexpr int kWsThreads = 384;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use on the H100
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// One consumer warp's release of a stage (8 arrivals complete it).
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
__device__ __forceinline__ void release(uint64_t* bar) { release(smem_u32(bar)); }

// A consumer thread's ldmatrix / stmatrix row in its warpgroup's 64 rows
// of a 128-row tile of 64-column boxes (1024-aligned): lane l addresses
// row l % 8 + 8 ((l / 8) % 2) of its warp's 16 rows in 8-column block
// 2 jp + l / 16, i.e. chunk (2 jp) % 8 ^ l / 16 of 64-column box jp / 4;
// r[q] then pairs with acc[8 jp + 2 q], acc[8 jp + 2 q + 1]. `lane_row`
// is the byte offset of that row in box 0 at jp = 0, `at_jp` moves it to
// group jp: one XOR with a constant per access.
__device__ __forceinline__ uint32_t lane_row(int cw) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  return sw128_row(cw * 64 + 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1)) ^ ((lane >> 4) << 4);
}
__device__ __forceinline__ uint32_t at_jp(uint32_t row, int jp) {
  return (row ^ (((2 * jp) & 7) << 4)) + (jp >> 2) * kBM * 128;
}

// ------------------------------------------------------ forward tile engine

// Kernels B (mlp_train.cu) and C (field_train.cu) are one engine,
// persistent over 128-point tiles (block b takes tiles b, b + gridDim.x,
// ...). Shared memory, from a 1024-aligned base: the tile's [h | x] as
// W / 64 + 1 boxes of 128 rows x 64 columns (wgmma's K-major A operand),
// for C one more box (s, later r, take the x box and that one), the weight
// ring, the barriers. A ring stage is 64 rows (K) of a packed weight, up to kNB
// boxes of 64 columns (N), the MN-major B operand: the weights are K x N
// with N contiguous, so a k16 step advances 2,048 bytes. Warp 0 of the
// producer pushes every stage in the order the consumers take them; warp
// 1 loads each tile's x (and for C, d_enc) into the x box, which the
// consumers release after its last product. Each consumer warpgroup owns
// 64 of the tile's points: a 64 x N f32 accumulator, one wgmma m64nNk16
// chain per product, then the epilogue (f32 bias, ReLU, bf16) written by
// stmatrix into the tile, where it is the next product's A operand and
// the source of a TMA store that runs while the next products do. The two
// warpgroups share only the ring and the x box. Every product runs whole
// 64-row chunks: past a product's K the weights' rows lie outside their
// tensor (TMA reads them as zeros) and the tile's columns hold zeros or
// finite bf16 values. Shared memory is addressed by 32-bit shared-window
// addresses, one register each, so that a 64 x 256 accumulator and the
// loop state fit the 168 registers a thread has. No split-K, no atomics:
// a second call gives the same bits.
constexpr int kHeadMax = 128;    // widest head of C (CP, CWP)
constexpr int kBox = kBM * 128;  // one 64-column box of a 128-row tile

template <int W, bool kHeads>
struct FwdSmem {
  static constexpr int kNB = kHeads && W < kHeadMax ? kHeadMax / 64 : W / 64;
  static constexpr int kStageBytes = kNB * 64 * 128;
  static constexpr bool kXHeld = kHeads;      // C keeps the x box past the trunk
  static constexpr int kX = (W / 64) * kBox;  // the x box; for C also s / r's first box
  static constexpr int kRing = kX + (kHeads ? 2 : 1) * kBox;
  static constexpr int kFree = kSmemMax - kRing - 1024 - 256;
  static constexpr int kStages = kFree / kStageBytes < 4 ? kFree / kStageBytes : 4;
  static constexpr int kBar = kRing + kStages * kStageBytes;  // full[], empty[], xfull, xempty
  static constexpr int kBytes = kBar + 256 + 1024;  // + slack for the alignment
  static_assert(kStages >= 3, "the forward needs three ring stages");
  // shared-window addresses from the base `sm`
  static __device__ __forceinline__ uint32_t stage(uint32_t sm, int st) {
    return sm + kRing + st * kStageBytes;
  }
  static __device__ __forceinline__ uint32_t full(uint32_t sm, int st) {
    return sm + kBar + 8 * st;
  }
  static __device__ __forceinline__ uint32_t empty(uint32_t sm, int st) {
    return sm + kBar + 8 * (kStages + st);
  }
  static __device__ __forceinline__ uint32_t xfull(uint32_t sm) { return sm + kBar + 16 * kStages; }
  static __device__ __forceinline__ uint32_t xempty(uint32_t sm) { return xfull(sm) + 8; }
};

// The 1024-aligned base of the dynamic shared memory, after one thread has
// set up the engine's barriers: ring stages full (1 arrival + bytes) /
// empty (8 consumer warps), the x box's the same.
template <class S>
__device__ __forceinline__ uint32_t fwd_setup(const unsigned char* smem_raw) {
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(S::full(sm, i), 1);
      mbar_init(S::empty(sm, i), 8);
    }
    mbar_init(S::xfull(sm), 1);
    mbar_init(S::xempty(sm), 8);
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// Producer: rows [row, row + 64) of `map` at depth z, columns from col0 in
// `boxes` boxes, into the next ring stage (`it` counts the stages pushed).
template <class S>
__device__ __forceinline__ void push(uint32_t sm, uint32_t& it, const CUtensorMap* map, int col0,
                                     int row, int z, int boxes) {
  const int st = it % S::kStages;
  mbar_wait(S::empty(sm, st), ((it / S::kStages) & 1) ^ 1);
  mbar_expect_tx(S::full(sm, st), boxes * 64 * 128);
  for (int b = 0; b < boxes; ++b)
    tma_load(S::stage(sm, st) + b * 64 * 128, map, S::full(sm, st), col0 + 64 * b, row, z);
  ++it;
}

// Consumer: acc (64 x 2R) = A B over the ring's next kc1 - kc0 stages (`it`
// counts the stages taken); A = `a` (this warpgroup's rows of a tile),
// boxes kc0 .. kc1 - 1. B is a stage of 64 K-rows, MN-major (a packed
// weight K x N, N contiguous); with kKMajorB a stage of N rows of 64 K
// columns (a weight read as W^T: the product g W^T of a data pass). A
// data pass's chain starts from a zeroed accumulator and always
// accumulates, as the trunk's data pass does: its epilogues write the
// accumulator, and with a first step that overwrites it instead, ptxas
// serialized every chain of C''s heads pass (C7511).
template <class S, int R, bool kKMajorB = false>
__device__ __forceinline__ void fwd_product(float (&acc)[R], uint32_t sm, uint32_t& it, uint32_t a,
                                            int kc0, int kc1) {
  if (kKMajorB) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  }
  int prev = -1;
  for (int kc = kc0; kc < kc1; ++kc, ++it) {
    const int st = it % S::kStages;
    mbar_wait(S::full(sm, st), (it / S::kStages) & 1);
    const uint32_t ak = a + kc * kBox, b = S::stage(sm, st);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes into A's rows, 16 K of B
      if (kKMajorB)
        wgmma<0, 0>(acc, desc_sw128(ak + kk * 32, 16, 1024), desc_sw128(b + kk * 32, 16, 1024));
      else
        wgmma<0, 1>(acc, desc_sw128(ak + kk * 32, 16, 1024),
                    desc_sw128(b + kk * 2048, 64 * 128, 1024), kc > kc0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: release its stage
    if (prev >= 0) release(S::empty(sm, prev));
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(S::empty(sm, prev));
}

// The first R values of an accumulator: a kernel keeps one accumulator
// array for all its products, so that every wgmma chain writes the same
// registers (chains on separate arrays of other widths can leave ptxas no
// consistent assignment, and it then serializes them through local memory).
template <int R, int RA>
__device__ __forceinline__ float (&prefix(float (&acc)[RA]))[R] {
  static_assert(R <= RA, "a prefix of the accumulator");
  return *reinterpret_cast<float(*)[R]>(&acc[0]);
}

// Before an epilogue overwrites a tile: every TMA store of this warpgroup
// has read its source, and every warp's products are complete.
__device__ __forceinline__ void tile_free(int cw) {
  if ((threadIdx.x & 127) == 0) tma_store_wait_read();
  named_bar(1 + cw, 128);
}

// The epilogue into a tile at `buf`: this warpgroup's rows of acc + bias
// (f32), ReLU if kRelu, rounded to bf16, into columns [0, 16 jps).
template <bool kRelu, int R>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[R], const float* __restrict__ bias,
                                             uint32_t buf, int cw, int jps) {
  const int tq = threadIdx.x & 3;
  const uint32_t row = buf + lane_row(cw);
#pragma unroll
  for (int jp = 0; jp < R / 8; ++jp) {
    if (jp >= jps) break;
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 2 * tq));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 8 + 2 * tq));
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns 16 jp + 8 (q / 2) + 2 tq, + 1
      const float2 b = q < 2 ? b0 : b1;
      float v0 = acc[8 * jp + 2 * q] + b.x, v1 = acc[8 * jp + 2 * q + 1] + b.y;
      if (kRelu) {
        v0 = relu(v0);
        v1 = relu(v1);
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      v[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    stsm_x4_at(at_jp(row, jp), v);
  }
}

// After it: the writes fenced for the async proxy (wgmma, TMA), then one
// lane stores `boxes` boxes of this warpgroup's rows to `map` at (64 kb,
// row0, z), rows past n clipped.
__device__ __forceinline__ void tile_written(const CUtensorMap* map, uint32_t buf, int boxes,
                                             int cw, int row0, int z, int n) {
  fence_proxy_async();
  named_bar(1 + cw, 128);
  if ((threadIdx.x & 127) == 0 && row0 < n) {
    for (int kb = 0; kb < boxes; ++kb)
      tma_store(map, buf + kb * kBox + cw * 64 * 128, 64 * kb, row0, z);
    tma_store_commit();
  }
}

// out[p * ld + off + c] = acc + bias[c] (f32) for this warpgroup's points
// p < n and accumulator columns c < cols.
template <int R>
__device__ __forceinline__ void store_cols(const float (&acc)[R], const float* __restrict__ bias,
                                           float* __restrict__ out, int ld, int off, int cols,
                                           int row0, int n) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (8 * j >= cols) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = row0 + 16 * w + (lane >> 2) + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        if (p < n && c < cols) out[(size_t)p * ld + off + c] = acc[4 * j + 2 * h + e] + bias[c];
      }
    }
  }
}

// Producer: the chunks of every trunk layer in the consumers' order (layer
// 0: its 64 x rows; then each layer's W h rows, a skip layer's x rows
// after them).
template <class S, int W>
__device__ __forceinline__ void push_trunk(uint32_t sm, uint32_t& it, const CUtensorMap* wmap,
                                           int layers, unsigned skip_mask) {
  for (int l = 0; l < layers; ++l) {
    const int kc1 = l == 0 || ((skip_mask >> l) & 1u) ? W / 64 + 1 : W / 64;
    for (int kc = l == 0 ? W / 64 : 0; kc < kc1; ++kc)
      push<S>(sm, it, wmap, 0, 64 * kc, l, W / 64);
  }
}

// Producer: the tile's rows (row0 ...) of a [point][column] bf16 tensor (x
// or d_enc) into the x box, once the consumers released it (`xi` counts
// the loads); a half past n is not loaded (its points are never stored).
template <class S>
__device__ __forceinline__ void push_rows(uint32_t sm, uint32_t& xi, const CUtensorMap* map,
                                          int row0, int n) {
  const int halves = row0 + 64 < n ? 2 : 1;
  mbar_wait(S::xempty(sm), (xi & 1) ^ 1);
  mbar_expect_tx(S::xfull(sm), halves * 64 * 128);
  for (int hf = 0; hf < halves; ++hf)
    tma_load(sm + S::kX + hf * 64 * 128, map, S::xfull(sm), 0, row0 + 64 * hf, 0);
  ++xi;
}

// Consumer: the trunk over one tile for warpgroup cw (its points from
// row0): layer l = bf16(relu([h | x] W_l + b_l)) into the tile's h boxes
// and, by TMA, to acts[l]. The x box is released after the last layer
// that reads it (layer 0 or the last skip layer), unless S::kXHeld.
template <class S, int W>
__device__ __forceinline__ void trunk_tile(float (&acc)[W / 2], uint32_t sm, uint32_t& it,
                                           uint32_t& xi,
                                           const CUtensorMap* amap, const float* __restrict__ bp,
                                           int layers, unsigned skip_mask, int cw, int row0,
                                           int n) {
  int last_x = 0;
  for (int l = 1; l < layers; ++l)
    if ((skip_mask >> l) & 1u) last_x = l;
  mbar_wait(S::xfull(sm), xi & 1);
  for (int l = 0; l < layers; ++l) {
    const int kc1 = l == 0 || ((skip_mask >> l) & 1u) ? W / 64 + 1 : W / 64;
    fwd_product<S>(acc, sm, it, sm + cw * 64 * 128, l == 0 ? W / 64 : 0, kc1);
    if (!S::kXHeld && l == last_x) {
      release(S::xempty(sm));
      ++xi;
    }
    tile_free(cw);
    fwd_epilogue<true>(acc, bp + (size_t)l * W, sm, cw, W / 16);
    tile_written(amap, sm, W / 64, cw, row0, l, n);
  }
}

// ------------------------------------------------ trunk backward, data pass

// Shared memory of the data pass (offsets from a 1024-aligned base): the
// tile's bf16 g (wgmma's K-major A operand) and the mask tile (a saved
// activation), each [W / 64][128 rows][64] in 64 x 64 TMA boxes; a ring of
// stages, each 64 columns of one layer's W h rows or of its 64 x rows (the
// K-major B operand of g W^T: three stages at W = 256); barriers. Each
// consumer warp's column sums go into its own rows of the mask tile,
// which the epilogue releases after summing them.
template <int W>
struct DataSmem {
  static constexpr int kTileBytes = kBM * W * 2;
  static constexpr int kStageBytes = (W > kFPad ? W : kFPad) * 128;
  static constexpr int kFree = kSmemMax - 2 * kTileBytes - 1024 - 256;
  static constexpr int kStages = kFree / kStageBytes < 4 ? kFree / kStageBytes : 4;
  static constexpr int kGs = 0, kMask = kTileBytes, kRing = 2 * kTileBytes;
  static constexpr int kBar = kRing + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 256 + 1024;  // + slack for the alignment
  static_assert(kStages >= 2, "the data pass needs two ring stages");
};

// One exchange of the column sums: a (kept by lanes without bit o) and b
// (kept by lanes with it) -> a = the kept value plus the partner's.
__device__ __forceinline__ void halve(float& a, float b, int lane, int o) {
  const bool hi = lane & o;
  const float other = __shfl_xor_sync(0xffffffffu, hi ? a : b, o);
  a = (hi ? b : a) + other;
}

// This warp's column sums of a consumer warpgroup's 64 x 2R accumulator
// (f32), summed in place: the two rows of each thread, then a halving
// exchange over the warp's 8 row groups; the warp's 2R sums go to
// dbw_w[column].
template <int R>
__device__ __forceinline__ void warp_col_sums(float (&acc)[R], float* dbw_w) {
  constexpr int RV = R / 2;  // sums per thread before the exchange
  static_assert(RV >= 8, "the exchange needs 16 accumulator columns per thread");
  const int lane = threadIdx.x & 31;
  // value k = 2 j + e (column 8 j + 2 (lane % 4) + e) sits at acc[4 j + e]
#define PNT_V(k) acc[4 * ((k) >> 1) + ((k)&1)]
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    acc[4 * j] += acc[4 * j + 2];
    acc[4 * j + 1] += acc[4 * j + 3];
  }
#pragma unroll
  for (int i = 0; i < RV / 2; ++i) halve(PNT_V(i), PNT_V(i + RV / 2), lane, 16);
#pragma unroll
  for (int i = 0; i < RV / 4; ++i) halve(PNT_V(i), PNT_V(i + RV / 4), lane, 8);
#pragma unroll
  for (int i = 0; i < RV / 8; ++i) halve(PNT_V(i), PNT_V(i + RV / 8), lane, 4);
  // lane bits 4, 3, 2 chose which RV / 8 values the lane kept
  const int k0 = (lane & 16 ? RV / 2 : 0) + (lane & 8 ? RV / 4 : 0) + (lane & 4 ? RV / 8 : 0);
#pragma unroll
  for (int i = 0; i < RV / 8; ++i) {
    const int k = k0 + i;
    dbw_w[8 * (k >> 1) + 2 * (lane & 3) + (k & 1)] = PNT_V(i);
  }
#undef PNT_V
}

// The epilogue of one layer on a consumer warpgroup's 64 x W accumulators
// (f32 g): mask by the saved activation (the mask tile, ldmatrix), bf16
// rounding into gs (the next product's A operand, stmatrix) and a TMA
// store of those rows to gbuf[layer], and this warpgroup's db partial from
// the f32 masked g (summed in place: the two rows of each thread, then a
// halving exchange over the warp's 8 row groups, then the four warps in
// order through `dbw`, the warpgroup's rows of the mask tile).
template <int W>
__device__ __forceinline__ void data_epilogue(float (&acc)[W / 2], const unsigned char* mask,
                                              unsigned char* gs, float* dbw, uint64_t* mfull,
                                              uint64_t* mempty, uint32_t& mi,
                                              const CUtensorMap* gmap, float* __restrict__ db_out,
                                              int cw, int row0, int n, int layer, bool add) {
  constexpr int kWarpDbw = 512;  // floats in a warp's 16 rows of the mask tile (block 0)
  const int t = threadIdx.x & 127, w = t >> 5;
  float prev[(W + 127) / 128];  // this block's sums of its earlier tiles, loaded early
#pragma unroll
  for (int i = 0; i < (W + 127) / 128; ++i)
    prev[i] = add && t + 128 * i < W ? db_out[t + 128 * i] : 0.f;
  const uint32_t rsw = lane_row(cw);  // ldmatrix / stmatrix rows
  const uint32_t mrow = smem_u32(mask) + rsw, grow = smem_u32(gs) + rsw;
  mbar_wait(mfull, mi & 1);
  ++mi;
#pragma unroll
  for (int jp = 0; jp < W / 16; ++jp) {
    uint32_t m[4];
    ldsm_x4_at(m, at_jp(mrow, jp));
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // act > 0: bf16 bits in [0x0001, 0x7f80] (NaN is not)
        const uint32_t bits = (m[q] >> (16 * e)) & 0xffffu;
        acc[8 * jp + 2 * q + e] = bits - 1u < 0x7f80u ? acc[8 * jp + 2 * q + e] : 0.f;
      }
  }
  if (t == 0) tma_store_wait_read();  // the previous store out of gs has read it
  named_bar(1 + cw, 128);
#pragma unroll
  for (int jp = 0; jp < W / 16; ++jp) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(acc[8 * jp + 2 * q], acc[8 * jp + 2 * q + 1]);
      v[q] = *reinterpret_cast<const uint32_t*>(&b);
    }
    stsm_x4_at(at_jp(grow, jp), v);
  }
  fence_proxy_async();
  warp_col_sums(acc, dbw + w * kWarpDbw);
  named_bar(1 + cw, 128);
  if (t == 0 && row0 < n) {
    for (int kb = 0; kb < W / 64; ++kb)
      tma_store(gmap, gs + kb * kBM * 128 + cw * 64 * 128, kb * 64, row0, layer);
    tma_store_commit();
  }
#pragma unroll
  for (int i = 0; i < (W + 127) / 128; ++i) {
    const int c = t + 128 * i;
    if (c >= W) break;
    const float v =
        ((dbw[c] + dbw[kWarpDbw + c]) + dbw[2 * kWarpDbw + c]) + dbw[3 * kWarpDbw + c];
    db_out[c] = add ? prev[i] + v : v;  // the block's tiles in order
  }
  release(mempty);
}

// Persistent: block b takes tiles b, b + gridDim.x, ... For each tile the
// weight producer streams every layer's packed weight (L-1 down to 0) in
// 64-column chunks: first the layer's 64 x rows if it is layer 0 or a
// skip layer, then its W h rows if it has a predecessor; the mask producer
// loads the saved activation each epilogue needs (acts[L-1], then
// acts[L-2], ...) one layer ahead. Each consumer warpgroup takes 64 of the
// tile's 128 points: the upstream g (f32, from global memory) -> epilogue;
// then per layer l: gx += g_l W_x^T (layer 0 and skip layers; dx =
// bf16(gx) at layer 0), acc = g_l W_h^T, both from gs, and the epilogue of
// layer l - 1. gx (32 registers) and acc (W / 2) are never live together,
// so that W = 256 compiles without spills: the f32 partial of gx waits in
// global memory between two layers that read x. db: one partial per block
// and consumer warpgroup, summed over the block's tiles in order.
template <int W>
__global__ void __launch_bounds__(kWsThreads, 1)
    trunk_bwd_data_kernel(const __grid_constant__ CUtensorMap wmap,  // wp (L, W + 64, W)
                          const __grid_constant__ CUtensorMap amap,  // acts (L, N, W)
                          const __grid_constant__ CUtensorMap gmap,  // gbuf (L, N, W) out
                          const float* __restrict__ g,               // (N, W)
                          float* __restrict__ db_part,  // (2 x blocks, L, W) out
                          float* __restrict__ gxs,      // (N, 64) scratch: f32 partial of dx
                          bf16* __restrict__ dx,        // (N, 64) out
                          int n, int layers, unsigned skip_mask, int tiles) {
  using S = DataSmem<W>;
  constexpr int KB = W / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* gs = sm + S::kGs;
  unsigned char* mask = sm + S::kMask;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* empty = full + S::kStages;
  uint64_t* mfull = empty + S::kStages;
  uint64_t* mempty = mfull + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(mfull, 1);
    mbar_init(mempty, 8);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {  // the weight ring
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int l = layers - 1; l >= 0; --l) {
          const bool xrows = l == 0 || ((skip_mask >> l) & 1u);
          for (int ph = xrows ? 0 : 1; ph < (l > 0 ? 2 : 1); ++ph)  // 0: x rows, 1: h rows
            for (int kc = 0; kc < KB; ++kc, ++it) {
              const int st = it % S::kStages;
              mbar_wait(&empty[st], ((it / S::kStages) & 1) ^ 1);
              unsigned char* dst = sm + S::kRing + st * S::kStageBytes;
              mbar_expect_tx(&full[st], (ph ? W : kFPad) * 128);
              if (ph)
                for (int nb = 0; nb < KB; ++nb)
                  tma_load(dst + nb * 64 * 128, &wmap, &full[st], kc * 64, nb * 64, l);
              else
                tma_load(dst, &wmap, &full[st], kc * 64, W, l);
            }
        }
    } else if (warp == 1 && lane == 0) {  // the masks
      uint32_t mi = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        // a half past n is not loaded: its stale rows meet a g of 0
        const int halves = tile * kBM + 64 < n ? 2 : 1;
        for (int m = layers - 1; m >= 0; --m, ++mi) {
          mbar_wait(mempty, (mi & 1) ^ 1);
          mbar_expect_tx(mfull, halves * KB * 64 * 128);
          for (int kb = 0; kb < KB; ++kb)
            for (int hf = 0; hf < halves; ++hf)
              tma_load(mask + kb * kBM * 128 + hf * 64 * 128, &amap, mfull, kb * 64,
                       tile * kBM + hf * 64, m);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x & 127, w = t >> 5;
  // each warp's column sums go to its own rows of the mask tile (kb block 0)
  float* dbw = reinterpret_cast<float*>(mask + cw * 64 * 128);
  float* db_blk = db_part + (size_t)(2 * blockIdx.x + cw) * layers * W;
  float acc[W / 2], gx[32];
  uint32_t it = 0, mi = 0;
  // one layer's product with the ring's 64-column chunks of its x or h
  // rows: d += g_l (gs) times the chunk, transposed
  auto chunks = [&](auto& d) {
    int prev = -1;
    for (int kc = 0; kc < KB; ++kc, ++it) {
      const int st = it % S::kStages;
      mbar_wait(&full[st], (it / S::kStages) & 1);
      const unsigned char* b = sm + S::kRing + st * S::kStageBytes;
      const unsigned char* a = gs + kc * kBM * 128 + cw * 64 * 128;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k16 steps: 32 bytes into the swizzled rows
        wgmma<0, 0>(d, desc_sw128(a + kk * 32, 16, 1024), desc_sw128(b + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (prev >= 0) release(&empty[prev]);
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(d);
    release(&empty[prev]);
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kBM + cw * 64;  // this warpgroup's first point
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 16 * w + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
        float2 v = make_float2(0.f, 0.f);
        if (p < n) v = *reinterpret_cast<const float2*>(g + (size_t)p * W + c);
        acc[4 * j + 2 * h] = v.x;
        acc[4 * j + 2 * h + 1] = v.y;
      }
    data_epilogue<W>(acc, mask, gs, dbw, mfull, mempty, mi, &gmap,
                     db_blk + (size_t)(layers - 1) * W, cw, row0, n, layers - 1,
                     tile != (int)blockIdx.x);
    bool partial = false;  // gxs holds this tile's gx so far
    for (int l = layers - 1; l >= 0; --l) {
      if (l == 0 || ((skip_mask >> l) & 1u)) {
        // gx += g_l W_x^T; between two such layers the f32 partial waits in
        // gxs, so that gx and acc are never live together
#pragma unroll
        for (int j = 0; j < kFPad / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = row0 + 16 * w + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
            float2 v = make_float2(0.f, 0.f);
            if (partial && p < n)
              v = *reinterpret_cast<const float2*>(gxs + (size_t)p * kFPad + c);
            gx[4 * j + 2 * h] = v.x;
            gx[4 * j + 2 * h + 1] = v.y;
          }
        chunks(gx);
#pragma unroll
        for (int j = 0; j < kFPad / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = row0 + 16 * w + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
            if (p >= n) continue;
            if (l > 0)
              *reinterpret_cast<float2*>(gxs + (size_t)p * kFPad + c) =
                  make_float2(gx[4 * j + 2 * h], gx[4 * j + 2 * h + 1]);
            else
              *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)p * kFPad + c) =
                  __floats2bfloat162_rn(gx[4 * j + 2 * h], gx[4 * j + 2 * h + 1]);
          }
        partial = true;
      }
      if (l > 0) {  // g_{l-1} = mask(g_l W_h^T)
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
        chunks(acc);
        data_epilogue<W>(acc, mask, gs, dbw, mfull, mempty, mi, &gmap,
                         db_blk + (size_t)(l - 1) * W, cw, row0, n, l - 1,
                         tile != (int)blockIdx.x);
      }
    }
  }
  if (t == 0) tma_store_wait();
}

// ------------------------------------------------- split-K weight pass

// dW = A^T B over all points for a list of jobs: the trunk's layers
// (mlp_train.cu, field_train.cu) and the field's head blocks
// (field_train.cu) go through the same kernel. A job's dW rows come in
// 64-row slices, each the 64 columns of one [point][column] bf16 tensor
// from a given column (or rows the job does not read: zeros); B is one
// [point][column] tensor of nc columns. Block (x, y) takes one job's pair
// of slices (one per consumer warpgroup) and NB of its columns over the
// points of split y, and writes its f32 partial to the job's `part`
// (splits x slices x 64 x nc) with plain stores.
constexpr int kWP = 64;  // points per ring stage
constexpr int kMaxSlices = 5, kMaxMaps = 10, kMaxJobs = 32;
constexpr uint32_t kZeroRows = 15;

// A slice: tensor map (bits 0-3; kZeroRows: zeros), depth (bits 4-11),
// first column (bits 16-31).
inline uint32_t wslice(int map, int z, int col) {
  return (uint32_t)map | ((uint32_t)z << 4) | ((uint32_t)col << 16);
}

struct WgradJob {
  uint32_t slice[kMaxSlices];
  int slices, nc, b_map, b_z, cta0, cblocks;
  float* part;
  long long split_stride;
};

struct WgradArgs {
  CUtensorMap map[kMaxMaps];
  WgradJob job[kMaxJobs];
  int njobs, n, chunk;
};

template <int NB>
struct WgradSmem {
  // stage: the two A slices [kWP points][64], then B's NB / 64 blocks [kWP][64]
  static constexpr int kStageBytes = 2 * kWP * 128 + NB * kWP * 2;
  static constexpr int kFree = kSmemMax - 1024 - 256;
  static constexpr int kStages = kFree / kStageBytes < 4 ? kFree / kStageBytes : 4;
  static constexpr int kBar = kStages * kStageBytes;
  static constexpr int kBytes = kBar + 256 + 1024;
};

template <int NB>
__global__ void __launch_bounds__(kWsThreads, 1)
    wgrad_kernel(const __grid_constant__ WgradArgs args) {
  using S = WgradSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* empty = full + S::kStages;
  int j = 0;
  while (j + 1 < args.njobs && args.job[j + 1].cta0 <= (int)blockIdx.x) ++j;
  const WgradJob& job = args.job[j];
  const int local = blockIdx.x - job.cta0, pair = local / job.cblocks;
  const int n0 = (local % job.cblocks) * NB;
  const int split = blockIdx.y, p0 = split * args.chunk, p1 = min(args.n, p0 + args.chunk);
  const bool live0 = 2 * pair < job.slices && (job.slice[2 * pair] & 15) != kZeroRows;
  const bool live1 = 2 * pair + 1 < job.slices && (job.slice[2 * pair + 1] & 15) != kZeroRows;
  // a block with no slice to read writes zeros and loads nothing
  const int steps = (live0 || live1) && p1 > p0 ? (p1 - p0 + kWP - 1) / kWP : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      // B blocks wholly past nc are not loaded: their columns are not written
      uint32_t bytes = ((live0 ? 1 : 0) + (live1 ? 1 : 0)) * kWP * 128;
      for (int b = 0; b < NB / 64; ++b)
        if (n0 + 64 * b < job.nc) bytes += kWP * 128;
      for (int st = 0; st < steps; ++st) {
        const int s = st % S::kStages;
        mbar_wait(&empty[s], ((st / S::kStages) & 1) ^ 1);
        unsigned char* dst = sm + s * S::kStageBytes;
        mbar_expect_tx(&full[s], bytes);
        const int p = p0 + st * kWP;
        for (int i = 0; i < 2; ++i) {
          if (!(i ? live1 : live0)) continue;
          const uint32_t e = job.slice[2 * pair + i];
          tma_load(dst + i * kWP * 128, &args.map[e & 15], &full[s], (int)(e >> 16), p,
                   (int)((e >> 4) & 255));
        }
        for (int b = 0; b < NB / 64; ++b)
          if (n0 + 64 * b < job.nc)
            tma_load(dst + (2 + b) * kWP * 128, &args.map[job.b_map], &full[s], n0 + 64 * b, p,
                     job.b_z);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x & 127, w = t >> 5;
  const bool live = cw ? live1 : live0;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int s = st % S::kStages;
    mbar_wait(&full[s], (st / S::kStages) & 1);
    if (live) {
      const unsigned char* a = sm + s * S::kStageBytes + cw * kWP * 128;
      const unsigned char* b = sm + s * S::kStageBytes + 2 * kWP * 128;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWP / 16; ++kk)  // k16 steps: 16 rows of 128 bytes
        wgmma<1, 1>(acc, desc_sw128(a + kk * 2048, kWP * 128, 1024),
                    desc_sw128(b + kk * 2048, kWP * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    release(&empty[s]);
  }
  const int slice = 2 * pair + cw;
  if (slice >= job.slices) return;
  float* out = job.part + (size_t)split * job.split_stride + (size_t)slice * 64 * job.nc;
#pragma unroll
  for (int jj = 0; jj < NB / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + (lane >> 2) + 8 * h, c = n0 + 8 * jj + 2 * (lane & 3);
      if (c < job.nc)
        *reinterpret_cast<float2*>(out + (size_t)r * job.nc + c) =
            make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
}

// Appends a job to `a` (blocks from `ctas` on): dW (slices x 64 rows, nc
// columns) = A^T B, A's slices `sl` (wslice), B from map b_map at depth
// b_z; partials at `part`, split_stride floats apart.
inline void add_wgrad_job(WgradArgs& a, int& ctas, int nb, const uint32_t* sl, int slices,
                          int b_map, int b_z, int nc, float* part, long long split_stride) {
  WgradJob& j = a.job[a.njobs++];
  for (int i = 0; i < slices; ++i) j.slice[i] = sl[i];
  j.slices = slices;
  j.nc = nc;
  j.b_map = b_map;
  j.b_z = b_z;
  j.cta0 = ctas;
  j.cblocks = (nc + nb - 1) / nb;
  j.part = part;
  j.split_stride = split_stride;
  ctas += (slices + 1) / 2 * j.cblocks;
}

template <int NB>
int wgrad(const WgradArgs& a, int ctas, int splits, cudaStream_t s) {
  using S = WgradSmem<NB>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = allow_smem((const void*)wgrad_kernel<NB>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<NB><<<dim3(ctas, splits), kWsThreads, S::kBytes, s>>>(a);
  return (int)cudaGetLastError();
}

// out[e] = sum over the splits of part[k * stride + e], in order, for e <
// total, stored as DW (bf16 or float): the last pass of every split-K
// weight gradient (the trunk's and the heads').
template <typename DW>
__global__ void reduce_splits_kernel(const float* __restrict__ part, int splits, size_t stride,
                                     size_t total, DW* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * stride + e];
    store_val(out + e, s);
  }
}

// db = sum over the data pass's partials, in order.
__global__ void reduce_db_kernel(const float* __restrict__ db_part, float* __restrict__ dbp,
                                 int parts, int lw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lw) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += db_part[(size_t)b * lw + e];
  dbp[e] = s;
}

// Kernel B''s three passes: data pass from g (N, W) f32, split-K weight
// pass over every layer in one launch, in-order reductions. dW is stored
// as DW. `chunk` (points per split) is a multiple of kWP; `db_part` holds
// at least 2 x min(ceil(N / 128), SMs) x L x W floats, `gxs` N x 64,
// `dw_part` S x L x (W + 64) x W. `amap` receives the TMA descriptor of
// `acts`, for a caller that reads them again.
template <int W, typename DW>
int trunk_bwd(const bf16* x, const bf16* wp, const bf16* acts, const float* g, bf16* gbuf,
              float* db_part, float* gxs, float* dw_part, bf16* dx, DW* dwp, float* dbp, int n,
              int layers, unsigned skip_mask, int splits, int chunk, CUtensorMap& amap,
              cudaStream_t s) {
  using S = DataSmem<W>;
  constexpr int KB = W / 64;
  if (chunk % kWP != 0 || layers > kMaxJobs) return (int)cudaErrorInvalidValue;
  // every layer's dW: rows [0, W) from acts[l - 1] (map 0), rows [W, W + 64)
  // from x (map 1), against g (map 2)
  WgradArgs a{};
  CUtensorMap wmap;
  int err;
  if ((err = make_tma_map(&wmap, wp, W, W + kFPad, layers)) ||
      (err = make_tma_map(&amap, acts, W, n, layers)) ||
      (err = make_tma_map(&a.map[2], gbuf, W, n, layers)) ||
      (err = make_tma_map(&a.map[1], x, kFPad, n, 1)))
    return err;
  a.map[0] = amap;
  const int tiles = (n + kBM - 1) / kBM, sms = sm_count();
  const int grid = sms > 0 && sms < tiles ? sms : tiles;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = allow_smem((const void*)trunk_bwd_data_kernel<W>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_data_kernel<W><<<grid, kWsThreads, S::kBytes, s>>>(
      wmap, amap, a.map[2], g, db_part, gxs, dx, n, layers, skip_mask, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  a.n = n;
  a.chunk = chunk;
  int ctas = 0;
  for (int l = 0; l < layers; ++l) {
    uint32_t sl[kMaxSlices];
    for (int i = 0; i < KB; ++i) sl[i] = l > 0 ? wslice(0, l - 1, 64 * i) : kZeroRows;
    sl[KB] = l == 0 || ((skip_mask >> l) & 1u) ? wslice(1, 0, 0) : kZeroRows;
    add_wgrad_job(a, ctas, W, sl, KB + 1, 2, l, W, dw_part + (size_t)l * (W + kFPad) * W,
                  (long long)layers * (W + kFPad) * W);
  }
  if ((err = wgrad<W>(a, ctas, splits, s))) return err;
  const size_t dw_len = (size_t)layers * (W + kFPad) * W;
  reduce_splits_kernel<DW><<<1024, 256, 0, s>>>(dw_part, splits, dw_len, dw_len, dwp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int lw = layers * W;
  reduce_db_kernel<<<(lw + 255) / 256, 256, 0, s>>>(db_part, dbp, 2 * grid, lw);
  return (int)cudaGetLastError();
}

}  // namespace
