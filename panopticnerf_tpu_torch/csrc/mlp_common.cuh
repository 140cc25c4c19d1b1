// Device code shared by the trunk kernels (mlp_train.cu: B, B') and the
// whole-field kernels (field_train.cu: C, C'), for NVIDIA Hopper (sm_90a).
//
// - cp.async / ldmatrix / mma.sync.m16n8k16 (bf16 in, f32 accumulators)
//   helpers;
// - two block-wide GEMM loops over a 128-row tile held in shared memory,
//   8 warps as 2 along rows x 4 along columns, the right operand streamed
//   from global memory through a double-buffered cp.async ring of 32-deep
//   chunks: `gemm_nn` (right operand K x NC, row-major) and `gemm_nt` (its
//   transpose given, NC x K row-major). NC is a multiple of 32: each
//   column warp holds NC / 32 m16n8 tiles. With kFull the width is the
//   template's; otherwise `nc` (<= 32 * NT) is read at run time;
// - the trunk's forward over one tile (kernel B's body, also C's first
//   half) and the trunk's backward passes (kernel B', also C''s second
//   half), with dW written as bf16 or as float32.
//
// Everything sits in an anonymous namespace: each .cu file that includes
// it compiles its own copy.

#pragma once

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
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ void store_val(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
}

// Columns of a block-wide GEMM's accumulator: accumulator [mi][nt][j]
// holds row wm * 64 + mi * 16 + gq + (j >> 1) * 8, column
// tile_col0<...>(nc) + nt * 8 + 2 * tq + (j & 1).
template <int NT, bool kFull>
__device__ __forceinline__ int gemm_cols(int nc) {
  return kFull ? NT * 32 : nc;
}
template <int NT, bool kFull>
__device__ __forceinline__ int tile_col0(int nc) {
  return (threadIdx.x >> 5 & 3) * (gemm_cols<NT, kFull>(nc) / 4);
}

// acc[128 x NC] += A[:, a0 : a0 + K] @ B; A in shared memory (row stride
// lda), B (K x NC) row-major in global memory (row stride ldb). K is a
// multiple of 32; `wbuf` holds 2 x 32 x (NC + kPad). Ends synchronised.
template <int NT, bool kFull>
__device__ __forceinline__ void gemm_nn(float (&acc)[4][NT][4], const bf16* A, int lda, int a0,
                                        bf16* wbuf, const bf16* __restrict__ B, int ldb, int K,
                                        int nc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;
  const int ncols = gemm_cols<NT, kFull>(nc), nta = ncols / 32, ldw = ncols + kPad;
  const int wcol = tile_col0<NT, kFull>(nc);
  const int nchunks = K / kKC;
  auto load = [&](int c) {
    bf16* dst = wbuf + (c & 1) * kKC * ldw;
    const bf16* src = B + (size_t)c * kKC * ldb;
    const int segs = ncols / 8;
    for (int i = tid; i < kKC * segs; i += kThreads) {
      const int r = i / segs, seg = i % segs;
      cp_async16(dst + r * ldw + seg * 8, src + (size_t)r * ldb + seg * 8, true);
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
    const bf16* wb = wbuf + (c & 1) * kKC * ldw;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], A + (wm * 64 + mi * 16 + (lane & 15)) * lda + a0 + c * kKC + kk +
                           (lane >> 4) * 8);
      const bf16* brow = wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldw + wcol;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const int nt = 2 * p;
        if (kFull || nt + 1 < nta) {
          uint32_t b[4];
          ldsm_x4_t(b, brow + nt * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][nt], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][nt + 1], a[mi], b[2], b[3]);
          }
        } else if (nt < nta) {
          uint32_t b[2];
          ldsm_x2_t(b, brow + nt * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][nt], a[mi], b[0], b[1]);
        }
      }
      if ((NT & 1) && (kFull || NT - 1 < nta)) {
        uint32_t b[2];
        ldsm_x2_t(b, brow + (NT - 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][NT - 1], a[mi], b[0], b[1]);
      }
    }
    __syncthreads();
  }
}

// acc[128 x NC] += A[:, a0 : a0 + K] @ Bt^T; Bt (NC x K) row-major in
// global memory (row stride ldb): a weight whose rows are the product's
// output columns, i.e. g @ W^T. `wbuf` holds 2 x NC x (32 + kPad). Ends
// synchronised.
template <int NT, bool kFull>
__device__ __forceinline__ void gemm_nt(float (&acc)[4][NT][4], const bf16* A, int lda, int a0,
                                        bf16* wbuf, const bf16* __restrict__ Bt, int ldb, int K,
                                        int nc) {
  constexpr int LDT = kKC + kPad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;
  const int ncols = gemm_cols<NT, kFull>(nc), nta = ncols / 32;
  const int wcol = tile_col0<NT, kFull>(nc);
  const int nchunks = K / kKC;
  auto load = [&](int c) {
    bf16* dst = wbuf + (c & 1) * ncols * LDT;
    for (int i = tid; i < ncols * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8), seg = i % (kKC / 8);
      cp_async16(dst + r * LDT + seg * 8, Bt + (size_t)r * ldb + c * kKC + seg * 8, true);
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
    const bf16* wb = wbuf + (c & 1) * ncols * LDT;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], A + (wm * 64 + mi * 16 + (lane & 15)) * lda + a0 + c * kKC + kk +
                           (lane >> 4) * 8);
      const bf16* bcol = wb + (wcol + (lane & 7)) * LDT + kk + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const int nt = 2 * p;
        if (kFull || nt + 1 < nta) {
          uint32_t b[4];
          ldsm_x4(b, bcol + (nt * 8 + ((lane >> 4) & 1) * 8) * LDT);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][nt], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][nt + 1], a[mi], b[2], b[3]);
          }
        } else if (nt < nta) {
          uint32_t b[2];
          ldsm_x2(b, bcol + nt * 8 * LDT);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][nt], a[mi], b[0], b[1]);
        }
      }
      if ((NT & 1) && (kFull || NT - 1 < nta)) {
        uint32_t b[2];
        ldsm_x2(b, bcol + (NT - 1) * 8 * LDT);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][NT - 1], a[mi], b[0], b[1]);
      }
    }
    __syncthreads();
  }
}

// Calls f(row, col, v0, v1) for each pair of adjacent accumulator columns
// (col even) of a block-wide GEMM of width nc (or NT * 32 with kFull).
template <int NT, bool kFull, typename F>
__device__ __forceinline__ void for_each_pair(float (&acc)[4][NT][4], int nc, F&& f) {
  const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7, gq = lane >> 2, tq = lane & 3;
  const int nta = gemm_cols<NT, kFull>(nc) / 32, c0 = tile_col0<NT, kFull>(nc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!kFull && nt >= nta) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(wm * 64 + mi * 16 + gq + h * 8, c0 + nt * 8 + 2 * tq, acc[mi][nt][2 * h],
          acc[mi][nt][2 * h + 1]);
  }
}

// dst[col] = sum over the tile's 128 rows of the accumulator's column, in
// a fixed order (a shuffle tree inside each warp, then the two row warps).
// `dbw` holds 2 x NC floats. Starts and ends synchronised.
template <int NT, bool kFull>
__device__ __forceinline__ void col_sums(float (&acc)[4][NT][4], int nc, float* dbw,
                                         float* __restrict__ dst) {
  const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7, gq = lane >> 2, tq = lane & 3;
  const int ncols = gemm_cols<NT, kFull>(nc), nta = ncols / 32;
  const int c0 = tile_col0<NT, kFull>(nc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!kFull && nt >= nta) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s0 += acc[mi][nt][2 * h];
        s1 += acc[mi][nt][2 * h + 1];
      }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (gq == 0) {
      const int col = c0 + nt * 8 + 2 * tq;
      dbw[wm * ncols + col] = s0;
      dbw[wm * ncols + col + 1] = s1;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += kThreads) dst[c] = dbw[c] + dbw[ncols + c];
  __syncthreads();
}

// Layer l reads packed weight rows [row_lo, row_lo + K).
__device__ __forceinline__ int layer_row_lo(int l, int w) { return l == 0 ? w : 0; }
__device__ __forceinline__ int layer_rows(int l, bool skip, int w) {
  return l == 0 ? kFPad : (skip ? w + kFPad : w);
}

// ---------------------------------------------------------- trunk forward

// The trunk over one 128-point tile (rows row0 ...): x into act[:, W : W +
// 64] (async; waited for with the first weight chunk), then every layer's
// bias + ReLU + bf16 rounding in the accumulator epilogue, into act[:, 0 :
// W] and into acts (L, N, W). `act` is kBM x (W + 64 + kPad), `wbuf` 2 x
// kKC x (W + kPad). Every read of x is over when it returns.
template <int W>
__device__ __forceinline__ void trunk_forward_tile(bf16* act, bf16* wbuf,
                                                   const bf16* __restrict__ x,
                                                   const bf16* __restrict__ wp,
                                                   const float* __restrict__ bp,
                                                   bf16* __restrict__ acts, int n, int layers,
                                                   unsigned skip_mask, int row0) {
  constexpr int LDA = W + kFPad + kPad, NI = W / 32;
  const int tid = threadIdx.x;

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
    zero_acc(acc);
    gemm_nn<NI, true>(acc, act, LDA, lo, wbuf, wp + (size_t)l * (W + kFPad) * W + (size_t)lo * W,
                      W, layer_rows(l, skip, W), W);
    const float* bl = bp + (size_t)l * W;
    for_each_pair<NI, true>(acc, W, [&](int r, int col, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(act + r * LDA + col) =
          __floats2bfloat162_rn(relu(v0 + bl[col]), relu(v1 + bl[col + 1]));
    });
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

template <int W>
size_t trunk_fwd_smem() {
  return (size_t)(kBM * (W + kFPad + kPad) + 2 * kKC * (W + kPad)) * sizeof(bf16);
}

// ------------------------------------------------ trunk backward, data pass

// g (f32 accumulators) * (act > 0), act (N, ld) bf16 global; rows past n
// are zero.
template <int NT, bool kFull>
__device__ __forceinline__ void mask_by(float (&acc)[4][NT][4], int nc,
                                        const bf16* __restrict__ act, int ld, int row0, int n) {
  for_each_pair<NT, kFull>(acc, nc, [&](int r, int col, float& v0, float& v1) {
    const int p = row0 + r;
    if (p < n) {
      const __nv_bfloat162 m =
          *reinterpret_cast<const __nv_bfloat162*>(act + (size_t)p * ld + col);
      v0 = __bfloat162float(m.x) > 0.f ? v0 : 0.f;
      v1 = __bfloat162float(m.y) > 0.f ? v1 : 0.f;
    } else {
      v0 = v1 = 0.f;
    }
  });
}

// g (f32, fragment layout in acc) -> g * (act_l > 0) -> bf16 into gs; this
// block's db partial of layer l. Ends synchronised.
template <int W>
__device__ __forceinline__ void mask_round_store(float (&acc)[4][W / 32][4], bf16* gs,
                                                 float* dbw, const bf16* __restrict__ act_l,
                                                 float* __restrict__ db_out, int row0, int n) {
  constexpr int LDG = W + kPad, NI = W / 32;
  mask_by<NI, true>(acc, W, act_l, W, row0, n);
  for_each_pair<NI, true>(acc, W, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(gs + r * LDG + col) = __floats2bfloat162_rn(v0, v1);
  });
  col_sums<NI, true>(acc, W, dbw, db_out);
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
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  float* db_blk = db_part + (size_t)blockIdx.x * layers * W;

  float acc[4][NI][4];
  float gx[4][2][4];
  zero_acc(gx);
  for_each_pair<NI, true>(acc, W, [&](int r, int col, float& v0, float& v1) {
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float2*>(g + (size_t)(row0 + r) * W + col);
    v0 = v.x;
    v1 = v.y;
  });
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
    if (l == 0 || skip) gemm_nt<2, true>(gx, gs, LDG, 0, wbuf, wl + (size_t)W * W, W, W, 64);
    if (l > 0) {
      zero_acc(acc);
      gemm_nt<NI, true>(acc, gs, LDG, 0, wbuf, wl, W, W, W);  // h rows
      mask_round_store<W>(acc, gs, dbw, acts + (size_t)(l - 1) * n * W,
                          db_blk + (size_t)(l - 1) * W, row0, n);
    }
  }
  for_each_pair<2, true>(gx, 64, [&](int r, int col, float v0, float v1) {
    if (row0 + r < n)
      *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)(row0 + r) * kFPad + col) =
          __floats2bfloat162_rn(v0, v1);
  });
}

// ---------------------------------------------- trunk backward, weight pass

template <int W>
__global__ void __launch_bounds__(kThreads)
    trunk_bwd_weight_kernel(const bf16* __restrict__ x,     // (N, 64)
                            const bf16* __restrict__ acts,  // (L, N, W)
                            const bf16* __restrict__ gbuf,  // (L, N, W)
                            float* __restrict__ dw_part,    // (S, L, W + 64, W) out, 0 where
                                                            // the layer reads no row
                            int n, int layers, unsigned skip_mask, int chunk) {
  constexpr int LDA = kTK + kPad, LDB = W + kPad, NI = W / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* abuf = reinterpret_cast<bf16*>(smem_raw);  // 2 x kKC x LDA: [point][k]
  bf16* bbuf = abuf + 2 * kKC * LDA;               // 2 x kKC x LDB: [point][o]
  const int kt = blockIdx.x, s = blockIdx.y, l = blockIdx.z;
  const bool skip = (skip_mask >> l) & 1u;
  const int lo = layer_row_lo(l, W);
  const int r0 = kt * kTK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
  float* out = dw_part + ((size_t)(s * layers + l) * (W + kFPad) + r0) * W;
  if (r0 < lo || r0 >= lo + layer_rows(l, skip, W)) {  // rows the layer does not read: 0
    for (int i = tid; i < kTK * W / 4; i += kThreads)
      reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

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
  zero_acc(acc);

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

// db = sum over the data pass's blocks, in order.
__global__ void reduce_db_kernel(const float* __restrict__ db_part, float* __restrict__ dbp,
                                 int blocks, int lw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lw) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += db_part[(size_t)b * lw + e];
  dbp[e] = s;
}

template <int W>
size_t trunk_bwd_data_smem() {
  return (size_t)(kBM * (W + kPad) + 2 * W * (kKC + kPad)) * sizeof(bf16) + 2 * W * sizeof(float);
}
template <int W>
size_t trunk_bwd_weight_smem() {
  return (size_t)(2 * kKC * (kTK + kPad) + 2 * kKC * (W + kPad)) * sizeof(bf16);
}

// Kernel B''s three passes: data pass from g (N, W) f32, split-K weight
// pass, in-order reductions. dW is stored as DW.
template <int W, typename DW>
int trunk_bwd(const bf16* x, const bf16* wp, const bf16* acts, const float* g, bf16* gbuf,
              float* db_part, float* dw_part, bf16* dx, DW* dwp, float* dbp, int n, int layers,
              unsigned skip_mask, int splits, int chunk, cudaStream_t s) {
  const int blocks = (n + kBM - 1) / kBM;
  size_t smem = trunk_bwd_data_smem<W>();
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_data_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_data_kernel<W><<<blocks, kThreads, smem, s>>>(wp, acts, g, gbuf, db_part, dx, n,
                                                          layers, skip_mask);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  smem = trunk_bwd_weight_smem<W>();
  e = cudaFuncSetAttribute(trunk_bwd_weight_kernel<W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kFPad) / kTK, splits, layers);
  trunk_bwd_weight_kernel<W><<<grid, kThreads, smem, s>>>(x, acts, gbuf, dw_part, n, layers,
                                                         skip_mask, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t dw_len = (size_t)layers * (W + kFPad) * W;
  reduce_splits_kernel<DW><<<1024, 256, 0, s>>>(dw_part, splits, dw_len, dw_len, dwp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int lw = layers * W;
  reduce_db_kernel<<<(lw + 255) / 256, 256, 0, s>>>(db_part, dbp, blocks, lw);
  return (int)cudaGetLastError();
}

}  // namespace
