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
// (989 TFLOP/s bf16 peak, ~300 FLOP/byte needed); the plan here, with
// saved activations, adds 4,096 bytes per point written by B and read by
// B', which makes the backward HBM-bound and sets B's own floor (0.33 ms at
// the fine N against 0.26 ms of products). What the design does:
//   - all products are bf16 wgmma with f32 accumulators, operands in
//     shared memory;
//   - forward: the tile engine of mlp_common.cuh, persistent over
//     128-point tiles: the tile's [h | x] stays in shared memory across
//     all L layers (a skip layer is one K = W + 64 product with no
//     concat); a producer warpgroup streams the packed weights (1.3 MB,
//     from L2) by TMA through a 4-stage mbarrier ring and loads the next
//     tile's x while the current tile's last layers run; two consumer
//     warpgroups of 64 points each run wgmma, the epilogue (bias, ReLU,
//     bf16) goes back into the tile by stmatrix, and a TMA store saves
//     each activation while the next layer's products run;
//   - backward: the TPU kernel carries dW across its sequential grid in
//     VMEM; Hopper blocks run in parallel, so B' is three passes
//     (mlp_common.cuh), each warp-specialised the same way:
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
//
// The engine and B''s passes live in mlp_common.cuh, which kernels C / C'
// (field_train.cu) share.

#include "mlp_common.cuh"

namespace {

struct TrunkFwdParams {
  CUtensorMap x, wp, acts;  // x (N, 64), wp (L, W + 64, W), acts (L, N, W) out
  const float* bp;          // (L, W)
  int n, layers;
  unsigned skip_mask;
  int tiles;
};

template <int W>
__global__ void __launch_bounds__(kWsThreads, 1)
    trunk_fwd_kernel(const __grid_constant__ TrunkFwdParams p) {
  using S = FwdSmem<W, false>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm = fwd_setup<S>(smem_raw);
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t it = 0, xi = 0;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
        push_trunk<S, W>(sm, it, &p.wp, p.layers, p.skip_mask);
    } else if (warp == 1 && lane == 0) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
        push_rows<S>(sm, xi, &p.x, tile * kBM, p.n);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  float acc[W / 2];
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
    trunk_tile<S, W>(acc, sm, it, xi, &p.acts, p.bp, p.layers, p.skip_mask, cw,
                     tile * kBM + cw * 64, p.n);
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int W>
int fwd(const bf16* x, const bf16* wp, const float* bp, bf16* acts, int n, int layers,
        unsigned skip_mask, cudaStream_t s) {
  using S = FwdSmem<W, false>;
  TrunkFwdParams p{};
  int err;
  if ((err = make_tma_map(&p.x, x, kFPad, n, 1)) ||
      (err = make_tma_map(&p.wp, wp, W, W + kFPad, layers)) ||
      (err = make_tma_map(&p.acts, acts, W, n, layers)))
    return err;
  p.bp = bp;
  p.n = n;
  p.layers = layers;
  p.skip_mask = skip_mask;
  p.tiles = (n + kBM - 1) / kBM;
  const int sms = sm_count(), grid = sms > 0 && sms < p.tiles ? sms : p.tiles;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t e = allow_smem((const void*)trunk_fwd_kernel<W>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  trunk_fwd_kernel<W><<<grid, kWsThreads, S::kBytes, s>>>(p);
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
