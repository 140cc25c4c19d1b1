// Fused NeRF trunk for the training step, forward (kernel B) and backward
// (kernel B'), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of panopticnerf_tpu/ops/pallas_mlp_train.py:
//   B  = `trunk_train`'s forward (`_trunk_fwd_impl` -> `_fwd_kernel`),
//   B' = its backward (`_trunk_bwd_rule` -> `_bwd_kernel`).
// It computes what those compute, with the same rounding placement (plain
// version: ops/mlp_train.py trunk_forward_plain / trunk_backward_plain):
// bf16 matmul inputs with f32 accumulation, f32 bias and ReLU, activations
// rounded to bf16 only as the next layer's input; backward: ReLU mask from
// the activation, g rounded to bf16 before both products, db from the f32
// g, dx in bf16, dW summed in f32 over all points and rounded to bf16.
//
// Packed layout (ops/mlp_train.py): x (N, 64) bf16; weights (L, W + 64, W)
// bf16, rows [0, W) multiply h, rows [W, W + 64) multiply x (layer 0 reads
// only those, a skip layer reads all W + 64); biases (L, W) f32.
//
// What bounds it: per point the 8x256 trunk is ~1 MFLOP forward; the
// training step runs 393,216 points (131,072 coarse + 262,144 fine) through
// the forward, dW = inp^T g and g_in = g W^T: ~1.2 TFLOP, against ~4 GB of
// activation traffic — the function is compute-bound on the tensor cores
// (989 TFLOP/s bf16 peak, ~300 FLOP/byte needed); the backward as planned
// here, with saved activations, is HBM-bound. What the design does:
//   - all products are bf16 with f32 accumulators;
//   - forward: mma.sync.m16n8k16 fed by ldmatrix from shared memory (rows
//     padded by 16 bytes: no bank conflicts); one block per 128-point tile
//     keeps the tile's activations in shared memory across all L layers
//     ([h | x] side by side, so a skip layer is one K = W + 64 product with
//     no concat); weights stream through a double-buffered cp.async ring
//     of 32-row chunks (the packed weights, 1.3 MB, stay in L2); bias +
//     ReLU + bf16 rounding run in the accumulator epilogue;
//   - backward: the TPU kernel carries dW across its sequential grid in
//     VMEM; Hopper blocks run in parallel, so B' is three passes
//     (mlp_common.cuh), each warp-specialised (a producer warpgroup issues
//     TMA loads into mbarrier rings, two consumer warpgroups run wgmma):
//       1. data pass, persistent over 128-point tiles: the tile's bf16 g
//          stays in shared memory as wgmma's A operand; g -> mask -> db ->
//          bf16 -> g W^T layer by layer, each layer's packed weight
//          streamed by TMA in 64-column chunks, each mask tile (the saved
//          activation) loaded by TMA one layer ahead, each layer's bf16 g
//          stored to global memory by TMA; per-warpgroup db partials, dx;
//       2. weight pass: dW_l = inp_l^T g_l as a split-K product (both
//          operands MN-major wgmma), one block per (pair of 64-row slices
//          of W + 64, layer) and point split, all layers in one launch,
//          each block writing its partial to a (S, L, W + 64, W) f32
//          buffer with plain stores;
//       3. a reduction over the S splits and the db partials in a fixed
//          order (deterministic: no atomics), rounding dW to bf16.
//     Activations are not recomputed: kernel B saves every layer's bf16
//     activation (L x N x W: 1.07 GB for the fine field at N = 262,144,
//     0.54 GB for the coarse); the values are those a recompute would give.
//     With them the backward is HBM-bound, not compute-bound (mlp_common.cuh).
//
// The forward is still the first design: mma.sync at one 8-warp block per
// SM. The GEMM loops, the trunk's tile forward and B''s passes live in
// mlp_common.cuh, which kernels C / C' (field_train.cu) share.

#include "mlp_common.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_fwd_kernel(const bf16* __restrict__ x,    // (N, 64)
                     const bf16* __restrict__ wp,   // (L, W + 64, W)
                     const float* __restrict__ bp,  // (L, W)
                     bf16* __restrict__ acts,       // (L, N, W)
                     int n, int layers, unsigned skip_mask) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);  // kBM x (W + 64 + kPad): [h | x]
  bf16* wbuf = act + kBM * (W + kFPad + kPad);    // 2 x kKC x (W + kPad)
  trunk_forward_tile<W>(act, wbuf, x, wp, bp, acts, n, layers, skip_mask, blockIdx.x * kBM);
}

template <int W>
int fwd(const bf16* x, const bf16* wp, const float* bp, bf16* acts, int n, int layers,
        unsigned skip_mask, cudaStream_t s) {
  const size_t smem = trunk_fwd_smem<W>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t e = allow_smem((const void*)trunk_fwd_kernel<W>, (int)smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  trunk_fwd_kernel<W><<<(n + kBM - 1) / kBM, kThreads, smem, s>>>(x, wp, bp, acts, n, layers,
                                                                  skip_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). The Python wrapper
// (ops/mlp_train_cuda.py) checks dtypes, shapes and contiguity, allocates
// every output and scratch buffer, and requires W in {64, 128, 256},
// 1 <= L <= 32 and n >= 1 (and for the backward a split size that is a
// multiple of 64 points). Each returns 0 when every launch was accepted,
// else the CUDA error code (kTmaEncodeFailed when a TMA descriptor cannot
// be encoded); nothing synchronises.
extern "C" int trunk_fwd_launch(const void* x, const void* wp, const void* bp, void* acts,
                                int n, int width, int layers, unsigned skip_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* ww = static_cast<const bf16*>(wp);
  const float* bb = static_cast<const float*>(bp);
  bf16* aa = static_cast<bf16*>(acts);
  switch (width) {
    case 64: return fwd<64>(xx, ww, bb, aa, n, layers, skip_mask, s);
    case 128: return fwd<128>(xx, ww, bb, aa, n, layers, skip_mask, s);
    case 256: return fwd<256>(xx, ww, bb, aa, n, layers, skip_mask, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int trunk_bwd_launch(const void* x, const void* wp, const void* acts, const void* g,
                                void* gbuf, void* db_part, void* gx_part, void* dw_part, void* dx,
                                void* dwp, void* dbp, int n, int width, int layers,
                                unsigned skip_mask, int splits, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap amap;
#define PNT_BWD(WW)                                                                             \
  trunk_bwd<WW, bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(wp),                \
                      static_cast<const bf16*>(acts), static_cast<const float*>(g),             \
                      static_cast<bf16*>(gbuf), static_cast<float*>(db_part),                   \
                      static_cast<float*>(gx_part), static_cast<float*>(dw_part),               \
                      static_cast<bf16*>(dx), static_cast<bf16*>(dwp), static_cast<float*>(dbp), \
                      n, layers, skip_mask, splits, chunk, amap, s)
  switch (width) {
    case 64: return PNT_BWD(64);
    case 128: return PNT_BWD(128);
    case 256: return PNT_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PNT_BWD
}
