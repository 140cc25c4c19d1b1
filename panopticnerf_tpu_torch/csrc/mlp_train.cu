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
// activation traffic — compute-bound on the tensor cores (989 TFLOP/s bf16
// peak, ~300 FLOP/byte needed). What the design does about it:
//   - all products are bf16 mma.sync.m16n8k16 with f32 accumulators, fed by
//     ldmatrix from shared memory (rows padded by 16 bytes: no bank
//     conflicts);
//   - forward: one block per 128-point tile keeps the tile's activations in
//     shared memory across all L layers ([h | x] side by side, so a skip
//     layer is one K = W + 64 product with no concat); weights stream
//     through a double-buffered cp.async ring of 32-row chunks (the packed
//     weights, 1.3 MB, stay in L2); bias + ReLU + bf16 rounding run in the
//     accumulator epilogue;
//   - backward: the TPU kernel carries dW across its sequential grid in
//     VMEM; Hopper blocks run in parallel, so B' is three passes:
//       1. data pass, one block per 128-point tile: g -> mask -> bf16 ->
//          g W^T layer by layer (the chain runs like the forward, with W^T),
//          writing each layer's bf16 g to global memory, per-block db
//          partials, and dx;
//       2. weight pass: dW_l = inp_l^T g_l as a split-K product, grid
//          (64-row slices of W + 64, S point splits, L layers), each block
//          writing its partial to a (S, L, W + 64, W) f32 buffer with plain
//          stores;
//       3. a reduction over the S splits and the db partials in a fixed
//          order (deterministic: no atomics), rounding dW to bf16.
//     Activations are not recomputed: kernel B saves every layer's bf16
//     activation (L x N x W: 1.07 GB for the fine field at N = 262,144,
//     0.54 GB for the coarse); the values are those a recompute would give.
//
// Simple first: no wgmma/TMA and one 8-warp block per SM; those are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // points per block (forward, backward data pass)
constexpr int kThreads = 256;  // 8 warps: 2 along points x 4 along columns
constexpr int kFPad = 64;      // x_enc columns
constexpr int kKC = 32;        // reduction depth of one staged chunk
constexpr int kPad = 8;        // bf16 row padding (16 bytes)
constexpr int kTK = 64;        // weight rows per block in the weight pass

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // keeps NaN

// Layer l reads packed weight rows [row_lo, row_lo + K).
__device__ __forceinline__ int layer_row_lo(int l, int w) { return l == 0 ? w : 0; }
__device__ __forceinline__ int layer_rows(int l, bool skip, int w) {
  return l == 0 ? kFPad : (skip ? w + kFPad : w);
}

// ---------------------------------------------------------------- forward

// acc[128 x W] += act[:, a0 : a0 + K] @ wl[0 : K, :]; wl rows are W wide.
// Weights stream through `wbuf` (2 x kKC x (W + kPad)). Ends synchronised.
template <int W>
__device__ __forceinline__ void gemm_fwd(float (&acc)[4][W / 32][4], const bf16* act,
                                         bf16* wbuf, const bf16* __restrict__ wl, int a0,
                                         int K) {
  constexpr int LDA = W + kFPad + kPad, LDW = W + kPad, NI = W / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int nchunks = K / kKC;
  auto load = [&](int c) {
    bf16* dst = wbuf + (c & 1) * kKC * LDW;
    const bf16* src = wl + (size_t)c * kKC * W;
    for (int i = tid; i < kKC * (W / 8); i += kThreads) {
      const int r = i / (W / 8), seg = i % (W / 8);
      cp_async16(dst + r * LDW + seg * 8, src + (size_t)r * W + seg * 8, true);
    }
    cp_async_commit();
  };
  load(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wb = wbuf + (c & 1) * kKC * LDW;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], act + (wm * 64 + mi * 16 + (lane & 15)) * LDA + a0 + c * kKC + kk +
                           (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW + wn * (W / 4) +
                         nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_fwd_kernel(const bf16* __restrict__ x,    // (N, 64)
                     const bf16* __restrict__ wp,   // (L, W + 64, W)
                     const float* __restrict__ bp,  // (L, W)
                     bf16* __restrict__ acts,       // (L, N, W)
                     int n, int layers, unsigned skip_mask) {
  constexpr int LDA = W + kFPad + kPad, NI = W / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);  // kBM x LDA: [h | x]
  bf16* wbuf = act + kBM * LDA;                   // 2 x kKC x (W + kPad)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kBM;

  for (int i = tid; i < kBM * (kFPad / 8); i += kThreads) {
    const int r = i / (kFPad / 8), seg = i % (kFPad / 8);
    const bool ok = row0 + r < n;
    cp_async16(act + r * LDA + W + seg * 8, x + (size_t)(ok ? row0 + r : 0) * kFPad + seg * 8, ok);
  }
  cp_async_commit();  // waited for with the first weight chunk

  for (int l = 0; l < layers; ++l) {
    const bool skip = (skip_mask >> l) & 1u;
    const int lo = layer_row_lo(l, W);
    float acc[4][NI][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    gemm_fwd<W>(acc, act, wbuf, wp + (size_t)l * (W + kFPad) * W + (size_t)lo * W, lo,
                layer_rows(l, skip, W));
    const float* bl = bp + (size_t)l * W;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = wn * (W / 4) + ni * 8 + 2 * tq;
      const float b0 = bl[col], b1 = bl[col + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + mi * 16 + gq + h * 8;
          *reinterpret_cast<__nv_bfloat162*>(act + r * LDA + col) = __floats2bfloat162_rn(
              relu(acc[mi][ni][2 * h] + b0), relu(acc[mi][ni][2 * h + 1] + b1));
        }
    }
    __syncthreads();
    bf16* dst = acts + (size_t)l * n * W;
    for (int i = tid; i < kBM * (W / 8); i += kThreads) {
      const int r = i / (W / 8), seg = i % (W / 8);
      if (row0 + r < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * W + seg * 8) =
            *reinterpret_cast<const uint4*>(act + r * LDA + seg * 8);
    }
  }
}

// ------------------------------------------------------ backward, data pass

// acc[128 x NCOLS] += gs[128 x W] @ wl[0 : NCOLS, 0 : W]^T (wl rows are W
// wide). Weight chunks of 32 columns stream through `wbuf`. Ends synchronised.
template <int W, int NIX>
__device__ __forceinline__ void gemm_bwd(float (&acc)[4][NIX][4], const bf16* gs, bf16* wbuf,
                                         const bf16* __restrict__ wl) {
  constexpr int LDG = W + kPad, LDT = kKC + kPad, NCOLS = NIX * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  constexpr int nchunks = W / kKC;
  auto load = [&](int c) {
    bf16* dst = wbuf + (c & 1) * NCOLS * LDT;
    for (int i = tid; i < NCOLS * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8), seg = i % (kKC / 8);
      cp_async16(dst + r * LDT + seg * 8, wl + (size_t)r * W + c * kKC + seg * 8, true);
    }
    cp_async_commit();
  };
  load(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wb = wbuf + (c & 1) * NCOLS * LDT;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi],
                gs + (wm * 64 + mi * 16 + (lane & 15)) * LDG + c * kKC + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NIX / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4(b, wb + (wn * (NCOLS / 4) + nj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDT +
                       kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

// g (f32, fragment layout in acc) -> g * (act_l > 0) -> bf16 into gs; this
// block's db partial of layer l. Ends synchronised.
template <int W>
__device__ __forceinline__ void mask_round_store(float (&acc)[4][W / 32][4], bf16* gs,
                                                 float* dbw, const bf16* __restrict__ act_l,
                                                 float* __restrict__ db_out, int row0, int n) {
  constexpr int LDG = W + kPad, NI = W / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = wn * (W / 4) + ni * 8 + 2 * tq;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + gq + h * 8;
        float v0 = 0.f, v1 = 0.f;
        if (row0 + r < n) {
          const __nv_bfloat162 m =
              *reinterpret_cast<const __nv_bfloat162*>(act_l + (size_t)(row0 + r) * W + col);
          v0 = __bfloat162float(m.x) > 0.f ? acc[mi][ni][2 * h] : 0.f;
          v1 = __bfloat162float(m.y) > 0.f ? acc[mi][ni][2 * h + 1] : 0.f;
        }
        s0 += v0;
        s1 += v1;
        *reinterpret_cast<__nv_bfloat162*>(gs + r * LDG + col) = __floats2bfloat162_rn(v0, v1);
      }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (gq == 0) {
      dbw[wm * W + col] = s0;
      dbw[wm * W + col + 1] = s1;
    }
  }
  __syncthreads();
  for (int c = tid; c < W; c += kThreads) db_out[c] = dbw[c] + dbw[W + c];
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_bwd_data_kernel(const bf16* __restrict__ wp,    // (L, W + 64, W)
                          const bf16* __restrict__ acts,  // (L, N, W)
                          const float* __restrict__ g,    // (N, W)
                          bf16* __restrict__ gbuf,        // (L, N, W) out: bf16 g per layer
                          float* __restrict__ db_part,    // (blocks, L, W) out
                          bf16* __restrict__ dx,          // (N, 64) out
                          int n, int layers, unsigned skip_mask) {
  constexpr int LDG = W + kPad, LDT = kKC + kPad, NI = W / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // kBM x LDG
  bf16* wbuf = gs + kBM * LDG;                   // 2 x W x LDT
  float* dbw = reinterpret_cast<float*>(wbuf + 2 * W * LDT);  // 2 x W
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kBM;
  float* db_blk = db_part + (size_t)blockIdx.x * layers * W;

  float acc[4][NI][4];
  float gx[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + gq + h * 8;
        const int col = wn * (W / 4) + ni * 8 + 2 * tq;
        float2 v = make_float2(0.f, 0.f);
        if (row0 + r < n) v = *reinterpret_cast<const float2*>(g + (size_t)(row0 + r) * W + col);
        acc[mi][ni][2 * h] = v.x;
        acc[mi][ni][2 * h + 1] = v.y;
      }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) gx[mi][ni][j] = 0.f;
  }
  mask_round_store<W>(acc, gs, dbw, acts + (size_t)(layers - 1) * n * W,
                      db_blk + (size_t)(layers - 1) * W, row0, n);

  for (int l = layers - 1; l >= 0; --l) {
    // gs holds layer l's bf16 g: keep it for the weight pass
    bf16* gl = gbuf + (size_t)l * n * W;
    for (int i = tid; i < kBM * (W / 8); i += kThreads) {
      const int r = i / (W / 8), seg = i % (W / 8);
      if (row0 + r < n)
        *reinterpret_cast<uint4*>(gl + (size_t)(row0 + r) * W + seg * 8) =
            *reinterpret_cast<const uint4*>(gs + r * LDG + seg * 8);
    }
    const bool skip = (skip_mask >> l) & 1u;
    const bf16* wl = wp + (size_t)l * (W + kFPad) * W;
    if (l == 0 || skip) gemm_bwd<W, 2>(gx, gs, wbuf, wl + (size_t)W * W);  // x rows
    if (l > 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      gemm_bwd<W, NI>(acc, gs, wbuf, wl);  // h rows
      mask_round_store<W>(acc, gs, dbw, acts + (size_t)(l - 1) * n * W,
                          db_blk + (size_t)(l - 1) * W, row0, n);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + gq + h * 8;
        const int col = wn * 16 + ni * 8 + 2 * tq;
        if (row0 + r < n)
          *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)(row0 + r) * kFPad + col) =
              __floats2bfloat162_rn(gx[mi][ni][2 * h], gx[mi][ni][2 * h + 1]);
      }
}

// ---------------------------------------------------- backward, weight pass

template <int W>
__global__ void __launch_bounds__(kThreads)
    trunk_bwd_weight_kernel(const bf16* __restrict__ x,     // (N, 64)
                            const bf16* __restrict__ acts,  // (L, N, W)
                            const bf16* __restrict__ gbuf,  // (L, N, W)
                            float* __restrict__ dw_part,    // (S, L, W + 64, W) out
                            int n, int layers, unsigned skip_mask, int chunk) {
  constexpr int LDA = kTK + kPad, LDB = W + kPad, NI = W / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* abuf = reinterpret_cast<bf16*>(smem_raw);  // 2 x kKC x LDA: [point][k]
  bf16* bbuf = abuf + 2 * kKC * LDA;               // 2 x kKC x LDB: [point][o]
  const int kt = blockIdx.x, s = blockIdx.y, l = blockIdx.z;
  const bool skip = (skip_mask >> l) & 1u;
  const int lo = layer_row_lo(l, W);
  const int r0 = lo + kt * kTK;
  if (r0 >= lo + layer_rows(l, skip, W)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;

  const bf16* asrc;
  int lda_g;
  if (r0 < W) {
    asrc = acts + (size_t)(l - 1) * n * W + r0;
    lda_g = W;
  } else {
    asrc = x + (r0 - W);
    lda_g = kFPad;
  }
  const bf16* bsrc = gbuf + (size_t)l * n * W;
  const int p_begin = s * chunk;
  const int p_end = min(n, p_begin + chunk);
  const int nsteps = p_end > p_begin ? (p_end - p_begin + kKC - 1) / kKC : 0;

  auto load = [&](int st) {
    bf16* da = abuf + (st & 1) * kKC * LDA;
    bf16* db = bbuf + (st & 1) * kKC * LDB;
    for (int i = tid; i < kKC * (kTK / 8); i += kThreads) {
      const int r = i / (kTK / 8), seg = i % (kTK / 8);
      const int p = p_begin + st * kKC + r;
      const bool ok = p < p_end;
      cp_async16(da + r * LDA + seg * 8, asrc + (size_t)(ok ? p : 0) * lda_g + seg * 8, ok);
    }
    for (int i = tid; i < kKC * (W / 8); i += kThreads) {
      const int r = i / (W / 8), seg = i % (W / 8);
      const int p = p_begin + st * kKC + r;
      const bool ok = p < p_end;
      cp_async16(db + r * LDB + seg * 8, bsrc + (size_t)(ok ? p : 0) * W + seg * 8, ok);
    }
    cp_async_commit();
  };

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  if (nsteps > 0) load(0);
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      load(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = abuf + (st & 1) * kKC * LDA;
    const bf16* sb = bbuf + (st & 1) * kKC * LDB;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // A = inp^T: rows k, reduction over points
        ldsm_x4_t(a[mi], sa + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LDA + wm * 32 +
                             mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * (W / 4) +
                         nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = dw_part + ((size_t)(s * layers + l) * (W + kFPad) + r0) * W;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + gq + h * 8;
        const int col = wn * (W / 4) + ni * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (size_t)r * W + col) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

// dW = bf16(sum over splits, in order); rows a layer does not read are 0.
__global__ void trunk_reduce_dw_kernel(const float* __restrict__ dw_part,
                                       bf16* __restrict__ dwp, int splits, int layers, int w,
                                       unsigned skip_mask) {
  const size_t per_layer = (size_t)(w + kFPad) * w;
  const size_t total = per_layer * layers;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int l = (int)(e / per_layer);
    const int r = (int)((e % per_layer) / w);
    const int lo = layer_row_lo(l, w);
    const bool used = r >= lo && r < lo + layer_rows(l, (skip_mask >> l) & 1u, w);
    float s = 0.f;
    if (used)
      for (int k = 0; k < splits; ++k) s += dw_part[(size_t)k * total + e];
    dwp[e] = __float2bfloat16_rn(s);
  }
}

// db = sum over the data pass's blocks, in order.
__global__ void trunk_reduce_db_kernel(const float* __restrict__ db_part, float* __restrict__ dbp,
                                       int blocks, int lw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lw) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += db_part[(size_t)b * lw + e];
  dbp[e] = s;
}

template <int W>
size_t fwd_smem() {
  return (size_t)(kBM * (W + kFPad + kPad) + 2 * kKC * (W + kPad)) * sizeof(bf16);
}
template <int W>
size_t bwd_data_smem() {
  return (size_t)(kBM * (W + kPad) + 2 * W * (kKC + kPad)) * sizeof(bf16) + 2 * W * sizeof(float);
}
template <int W>
size_t bwd_weight_smem() {
  return (size_t)(2 * kKC * (kTK + kPad) + 2 * kKC * (W + kPad)) * sizeof(bf16);
}

template <int W>
int fwd(const bf16* x, const bf16* wp, const float* bp, bf16* acts, int n, int layers,
        unsigned skip_mask, cudaStream_t s) {
  const size_t smem = fwd_smem<W>();
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  trunk_fwd_kernel<W><<<(n + kBM - 1) / kBM, kThreads, smem, s>>>(x, wp, bp, acts, n, layers,
                                                                  skip_mask);
  return (int)cudaGetLastError();
}

template <int W>
int bwd(const bf16* x, const bf16* wp, const bf16* acts, const float* g, bf16* gbuf,
        float* db_part, float* dw_part, bf16* dx, bf16* dwp, float* dbp, int n, int layers,
        unsigned skip_mask, int splits, int chunk, cudaStream_t s) {
  const int blocks = (n + kBM - 1) / kBM;
  size_t smem = bwd_data_smem<W>();
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_data_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_data_kernel<W><<<blocks, kThreads, smem, s>>>(wp, acts, g, gbuf, db_part, dx, n,
                                                          layers, skip_mask);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  smem = bwd_weight_smem<W>();
  e = cudaFuncSetAttribute(trunk_bwd_weight_kernel<W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kFPad) / kTK, splits, layers);
  trunk_bwd_weight_kernel<W><<<grid, kThreads, smem, s>>>(x, acts, gbuf, dw_part, n, layers,
                                                         skip_mask, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  trunk_reduce_dw_kernel<<<1024, 256, 0, s>>>(dw_part, dwp, splits, layers, W, skip_mask);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int lw = layers * W;
  trunk_reduce_db_kernel<<<(lw + 255) / 256, 256, 0, s>>>(db_part, dbp, blocks, lw);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). The Python wrapper
// (ops/mlp_train_cuda.py) checks dtypes, shapes and contiguity, allocates
// every output and scratch buffer, and requires W in {64, 128, 256},
// 1 <= L <= 32 and n >= 1. Each returns 0 when every launch was accepted,
// else the CUDA error code; nothing synchronises.
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
                                void* gbuf, void* db_part, void* dw_part, void* dx, void* dwp,
                                void* dbp, int n, int width, int layers, unsigned skip_mask,
                                int splits, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PNT_BWD(WW)                                                                           \
  bwd<WW>(static_cast<const bf16*>(x), static_cast<const bf16*>(wp),                          \
          static_cast<const bf16*>(acts), static_cast<const float*>(g),                       \
          static_cast<bf16*>(gbuf), static_cast<float*>(db_part), static_cast<float*>(dw_part), \
          static_cast<bf16*>(dx), static_cast<bf16*>(dwp), static_cast<float*>(dbp), n, layers, \
          skip_mask, splits, chunk, s)
  switch (width) {
    case 64: return PNT_BWD(64);
    case 128: return PNT_BWD(128);
    case 256: return PNT_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PNT_BWD
}
