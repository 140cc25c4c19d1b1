// The NeRF field's forward for the evaluation render (kernel E), for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package renders its evaluation field with
// plain XLA ops (panopticnerf_tpu/models/nerf.py under jit), and so did the
// port (models/nerf.py NeRFMLP.forward) until E. It computes what that
// forward computes in bf16, with flax's rounding placement (plain version:
// ops/field_eval.py field_eval_plain):
//   - the encodings [v, sin(2^k v), cos(2^k v), ...] of the point and of its
//     ray's direction in f32, each sine and cosine its own sinf / cosf call
//     (as ATen's torch.sin / torch.cos), rounded to bf16;
//   - every Dense layer (the trunk, sigma, sem_hidden, sem_out, feature,
//     color_hidden, color_out): the f32 product rounded to bf16, then the
//     bf16 bias added and the sum rounded, ReLU where the model has it; the
//     colour branch one product over [feature | d_enc];
//   - sigma and the semantic logits the bf16 values promoted to f32; rgb =
//     bf16(1 / (1 + expf(-logit))) promoted (torch.sigmoid on bf16).
// Kernel C (field_train.cu) computes the same field for training in the TPU
// kernel's placement (one rounding, f32 biases) and saves its activations:
// E is a separate kernel on the same engine, not a mode of C.
//
// Inputs: pts (P, 3) f32, the points scene-normalised; dirs (R, 3) f32, the
// rays' directions, P = R x S (point p lies on ray p / S); the packed
// weights of ops/field_train.py (kernel C's layout), the biases rounded to
// bf16 and held as f32. Outputs: sigma (P), rgb (P, 3), sem (P, classes), f32.
//
// A hybrid field (PanopticNeRF-360: a hash grid beside the MLP) adds g
// (P, 32) bf16, the grid's features that kernel G (hash_grid.cu) wrote, and
// its sigma, sem_hidden and feature heads read [h | g]: their packed block
// has W + 32 rows, and each of their products one more K chunk, the x box,
// into which the consumers load g (columns 0-31, zeros after) before each of
// the two products (s, then d_enc, take the box in between). The kGrid
// instantiations; a field without a grid runs the others, unchanged.
//
// What bounds it: the products, ~1.26 MFLOP per point for the 8x256 field
// (2 x in x out per Dense layer, heads included; 1.29 on the packed shapes),
// against 104 bytes of its own I/O per point (pts 12, outputs 92): ~12,000
// FLOP per byte, far above the H100's ~295, so the tensor cores are the
// limit (17.3 M points, a 188x704 KITTI-360 view's fine level, 22 ms at 989
// TFLOP/s); then the encodings on the CUDA cores: 60 sinf / cosf per point,
// 24 per ray. What the design does about it: kernel C's forward tile engine
// (mlp_common.cuh): persistent over 128-point tiles, a producer warp
// streaming every packed weight through a TMA ring in the consumers' order,
// two consumer warpgroups of 64 points each running every product as a
// wgmma chain from shared memory. Unlike C it stores nothing but the
// outputs: each tile's encodings, h, s, feature and r live in shared memory
// only (h in the tile's W / 64 boxes, x_enc then s then d_enc then r in the
// x box and the box after it), each warpgroup writing its own 64 rows. The
// consumers compute the encodings themselves into the x box (64 columns,
// zeros past 63; d_enc 27 columns, zeros past them), so no encoding crosses
// device memory; flax's two roundings cost three instructions per pair of
// columns (bf16x2). No split-K, no atomics: a second call gives the same
// bits. At the fine tile of a 188x704 view (524,288 points) E reaches 51 %
// of the bf16 peak; without the encodings, 58 % (PERF.md §6).

#include "mlp_common.cuh"

namespace {

template <int W>
struct EvalDims {
  static constexpr int SH = W / 2, SA = SH + 32;  // [sem_hidden | sigma | 0]: SA columns
  static constexpr int NCMAX = W > kHeadMax ? W : kHeadMax;
};

struct EvalParams {
  // wp (L, W + 64, W), hw (W, HO), wso (SH, CP), wch (W + 32, CWP), wco (CWP, 32)
  CUtensorMap wp, hw, wso, wch, wco;
  const float *pts, *dirs;
  const float *bp, *hb, *bso, *bch, *bco;  // bf16 values held as f32
  float *sigma, *rgb, *sem;
  int n, samples, layers;
  unsigned skip_mask;
  int x_freqs, d_freqs;  // bands of each encoding; d_freqs < 0: no view directions
  int classes, cwp, cp, use_sem, tiles;
  const bf16* grid;  // (n, 32): the hash grid's features (kGrid only)
};

// flax Dense's two roundings: the f32 product to bf16, then + the bf16 bias,
// rounded again.
__device__ __forceinline__ float flax_dense(float acc, float b) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(acc)) + b));
}

// torch.sigmoid on a bf16 value (ATen: 1 / (1 + exp(-x)) in f32), promoted.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(1.f / (1.f + expf(-x))));
}

// Column c of positional_encoding(v, freqs): v, then per band k the three
// sin(2^k v), then the three cos(2^k v); 0 past the last band and for
// freqs < 0.
__device__ __forceinline__ float enc_col(const float* v, int c, int freqs) {
  if (freqs < 0) return 0.f;
  if (c < 3) return v[c];
  const int k = (c - 3) / 6, j = c - 3 - 6 * k;
  if (k >= freqs) return 0.f;
  const float a = v[j < 3 ? j : j - 3] * __int_as_float((127 + k) << 23);  // x 2^k: exact
  return j < 3 ? sinf(a) : cosf(a);
}

__device__ __forceinline__ void st_shared_v4(uint32_t at, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(w[0]), "r"(w[1]),
               "r"(w[2]), "r"(w[3])
               : "memory");
}

// bf16(v) into column c of a swizzled box row (`row`: its address, sw128_row).
__device__ __forceinline__ void st_col(uint32_t row, int c, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"((row ^ ((c >> 3) << 4)) + (c & 7) * 2),
               "h"(*reinterpret_cast<const unsigned short*>(&h))
               : "memory");
}

// x_enc of this warpgroup's 64 points into its rows of the x box (at `box`),
// 63 columns and a zero: thread t takes row t % 64, threads 0-63 the point
// and bands 0-4 (columns 0-32), threads 64-127 bands 5-9 and the zero (a
// warp-uniform split). A band's three sines and three cosines are six
// independent sinf / cosf; the bands run in a loop that is not unrolled, so
// that the long inline code of the two functions stays in the instruction
// cache.
__device__ __forceinline__ void encode_x(const EvalParams& p, uint32_t box, int cw, int row0) {
  const int t = threadIdx.x & 127, r = t & 63, half = t >> 6;
  const int pt = row0 + r;
  float v[3] = {0.f, 0.f, 0.f};  // rows past n: finite values, never stored
  if (pt < p.n) {
    v[0] = p.pts[(size_t)pt * 3];
    v[1] = p.pts[(size_t)pt * 3 + 1];
    v[2] = p.pts[(size_t)pt * 3 + 2];
  }
  const uint32_t row = box + sw128_row(cw * 64 + r);
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) st_col(row, j, v[j]);
  } else {
    st_col(row, 63, 0.f);
  }
#pragma unroll 1
  for (int k = 5 * half; k < 5 * half + 5; ++k) {
    const bool on = k < p.x_freqs;
    const float m = __int_as_float((127 + k) << 23);  // 2^k
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a = v[j] * m;  // exact
      st_col(row, 3 + 6 * k + j, on ? sinf(a) : 0.f);
      st_col(row, 6 + 6 * k + j, on ? cosf(a) : 0.f);
    }
  }
  fence_proxy_async();  // for the products (async proxy) that read them
}

// d_enc into this warpgroup's rows of the x box (at `box`): 27 columns (of
// d_freqs = 4; none for d_freqs < 0), then zeros. Each distinct ray of the
// 64 points is encoded once, into rows of the box after the x box (free
// here: s has been read), one column a thread; then every row copies its
// ray's 32 columns.
__device__ __forceinline__ void encode_d(const EvalParams& p, uint32_t box, int cw, int row0) {
  const int t = threadIdx.x & 127, r = t & 63, half = t >> 6;
  const uint32_t scratch = box + kBox + cw * 64 * 128;  // row i: ray ray0 + i, 32 columns
  const int ray0 = row0 / p.samples;
  const int rays = row0 < p.n ? (min(row0 + 63, p.n - 1) / p.samples) - ray0 + 1 : 0;
#pragma unroll 1
  for (int i = t; i < rays * 32; i += 128) {
    const float* d = p.dirs + (size_t)(ray0 + (i >> 5)) * 3;
    const __nv_bfloat16 h = __float2bfloat16_rn(enc_col(d, i & 31, p.d_freqs));
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(scratch + (i >> 5) * 128 + (i & 31) * 2),
                 "h"(*reinterpret_cast<const unsigned short*>(&h))
                 : "memory");
  }
  named_bar(1 + cw, 128);
  const int pt = row0 + r;
  const uint32_t src = scratch + (pt < p.n ? pt / p.samples - ray0 : 0) * 128;
  const uint32_t row = box + sw128_row(cw * 64 + r);
  const uint32_t z[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // chunks 2 half + q: columns [16 half + 8 q, + 8)
    uint32_t w[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(src + (2 * half + q) * 16)
                 : "memory");
    st_shared_v4(row ^ ((2 * half + q) << 4), w);
    st_shared_v4(row ^ ((4 + 2 * half + q) << 4), z);
  }
  fence_proxy_async();  // for the products (async proxy) that read them
}

// g of this warpgroup's 64 points into their rows of the x box (at `box`):
// columns 0-31, then zeros (rows past n: zeros). Thread t takes row t % 64
// and half t / 64 of its 64-byte row of g: two 16-byte chunks.
__device__ __forceinline__ void load_grid(const EvalParams& p, uint32_t box, int cw, int row0) {
  const int t = threadIdx.x & 127, r = t & 63, half = t >> 6;
  const int pt = row0 + r;
  const uint32_t row = box + sw128_row(cw * 64 + r);
  const uint32_t z[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // chunk 2 half + q: columns [16 half + 8 q, + 8)
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (pt < p.n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p.grid + (size_t)pt * 32) + 2 * half + q);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
    st_shared_v4(row ^ ((2 * half + q) << 4), w);
    st_shared_v4(row ^ ((4 + 2 * half + q) << 4), z);
  }
  fence_proxy_async();  // for the products (async proxy) that read them
}

// The epilogue of one product into a tile at `buf`: this warpgroup's rows of
// flax_dense(acc, bias), ReLU if kRelu, bf16, into columns [0, 16 jps) by
// stmatrix; then the writes fenced for the async proxy and the warpgroup
// synchronised (the tile is the next product's A operand). On pairs of
// columns: the products rounded (cvt.rn.bf16x2), the bias added in bf16
// (add.rn.bf16x2: the sum rounded once, which is flax_dense's f32 sum
// rounded again, f32 holding every bit of a sum of two bf16 values that
// a bf16 rounding can see), ReLU by a max that keeps NaN.
template <bool kRelu, int R>
__device__ __forceinline__ void eval_epilogue(const float (&acc)[R], const float* __restrict__ bias,
                                              uint32_t buf, int cw, int jps) {
  const int tq = threadIdx.x & 3;
  const uint32_t row = buf + lane_row(cw);
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int jp = 0; jp < R / 8; ++jp) {
    if (jp >= jps) break;
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 2 * tq));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 8 + 2 * tq));
    const __nv_bfloat162 bb[2] = {__floats2bfloat162_rn(b0.x, b0.y),  // exact: bf16 values
                                  __floats2bfloat162_rn(b1.x, b1.y)};
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns 16 jp + 8 (q / 2) + 2 tq, + 1
      __nv_bfloat162 h = __hadd2(__floats2bfloat162_rn(acc[8 * jp + 2 * q], acc[8 * jp + 2 * q + 1]),
                                 bb[q / 2]);
      if (kRelu) h = __hmax2_nan(h, zero2);
      v[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    stsm_x4_at(at_jp(row, jp), v);
  }
  fence_proxy_async();
  named_bar(1 + cw, 128);
}

// Sets the accumulators before a chain whose first product overwrites them:
// their old values are then dead over the code before it (the encodings),
// whose registers they would hold, as wgmma's operands read them, otherwise.
template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// This thread's two points: row0 + 16 w + (lane / 4) + 8 h, h = 0, 1.
__device__ __forceinline__ int eval_point(int row0, int h) {
  return row0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// out[pt * cols + c] = flax_dense(acc, bias[c]) (kSigmoid: then the sigmoid)
// for this warpgroup's points pt < n and accumulator columns c < cols.
template <bool kSigmoid, int R>
__device__ __forceinline__ void store_eval(const float (&acc)[R], const float* __restrict__ bias,
                                           float* __restrict__ out, int cols, int row0, int n) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (8 * j >= cols) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pt = eval_point(row0, h);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        if (pt < n && c < cols) {
          const float v = flax_dense(acc[4 * j + 2 * h + e], bias[c]);
          out[(size_t)pt * cols + c] = kSigmoid ? sigmoid_bf16(v) : v;
        }
      }
    }
  }
}

// r = relu(flax([feature | d_enc] @ W_ch, b_ch)) into the x box (and the box
// after it): K = W + 64 (the tile's h boxes, then the x box), N = 2R columns.
template <class S, int W, int R>
__device__ __forceinline__ void colour_eval(float (&acc)[R], uint32_t sm, uint32_t& it,
                                            const EvalParams& p, int cw) {
  fwd_product<S>(acc, sm, it, sm + cw * 64 * 128, 0, W / 64 + 1);
  named_bar(1 + cw, 128);  // every warp's product has read d_enc
  eval_epilogue<true>(acc, p.bch, sm + S::kX, cw, p.cwp / 16);
}

// Persistent: block b takes tiles b, b + gridDim.x, ... Warp 0 of the
// producer pushes every weight chunk in the consumers' order (kernel C's):
// the trunk, W_head's [sem_hidden | sigma] columns, W_so, W_head's feature
// columns, W_ch (its W h rows and its d_enc rows), W_co. Each consumer
// warpgroup, on its 64 points of a tile:
//   x_enc into the x box; the trunk, each layer's epilogue over h;
//   [sem_hidden | sigma] = h @ W_head[:, :SA]: sigma out; s into the x box;
//   sem = s @ W_so: out;
//   d_enc into the x box; feature = h @ W_head[:, SA:] over h (no ReLU);
//   r = [feature | d_enc] @ W_ch into the x box; rgb = sigmoid(r @ W_co): out.
// kGrid: g into the x box before [sem_hidden | sigma] and before feature,
// each reading [h | g] (KB + 1 chunks); d_enc after the feature product.
template <int W, bool kGrid>
__global__ void __launch_bounds__(kWsThreads, 1)
    field_eval_kernel(const __grid_constant__ EvalParams p) {
  using D = EvalDims<W>;
  using S = FwdSmem<W, true>;
  constexpr int SH = D::SH, SA = D::SA, KB = W / 64;
  constexpr int KH = kGrid ? KB + 1 : KB;  // K chunks of the heads' input
  constexpr int NS = (SA + 63) / 64 * 64;  // [sem_hidden | sigma] product: whole boxes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm = fwd_setup<S>(smem_raw);
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t it = 0;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      const int nsem = p.cp > 64 ? 2 : 1, nch = p.cwp > 64 ? 2 : 1;  // N = 128, else 64
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        push_trunk<S, W>(sm, it, &p.wp, p.layers, p.skip_mask);
        for (int kc = 0; kc < KH; ++kc) push<S>(sm, it, &p.hw, 0, 64 * kc, 0, NS / 64);
        if (p.use_sem)
          for (int kc = 0; kc < (SH + 63) / 64; ++kc) push<S>(sm, it, &p.wso, 0, 64 * kc, 0, nsem);
        for (int kc = 0; kc < KH; ++kc) push<S>(sm, it, &p.hw, SA, 64 * kc, 0, KB);
        for (int kc = 0; kc <= KB; ++kc) push<S>(sm, it, &p.wch, 0, 64 * kc, 0, nch);
        for (int kc = 0; kc < (p.cwp + 63) / 64; ++kc) push<S>(sm, it, &p.wco, 0, 64 * kc, 0, 1);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x & 127;
  const uint32_t xbox = sm + S::kX;
  {  // zeros in this warpgroup's rows of the box after the x box: the columns
     // a product reads past its K (s and r narrower than 128) then hold zeros
     // or earlier finite values
    const uint32_t z[4] = {0u, 0u, 0u, 0u};
    for (int i = t; i < 64 * 8; i += 128) st_shared_v4(xbox + kBox + cw * 64 * 128 + i * 16, z);
    fence_proxy_async();
  }
  float acc[D::NCMAX / 2];  // every product's: one of N columns uses acc[0, N / 2)
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * kBM + cw * 64;
    named_bar(1 + cw, 128);  // the last tile's color_out products have read r
    encode_x(p, xbox, cw, row0);
    named_bar(1 + cw, 128);
    zero(acc);
    for (int l = 0; l < p.layers; ++l) {  // h = relu(flax([h | x] W_l, b_l))
      auto& h = prefix<W / 2>(acc);
      const int kc1 = l == 0 || ((p.skip_mask >> l) & 1u) ? KB + 1 : KB;
      fwd_product<S>(h, sm, it, sm + cw * 64 * 128, l == 0 ? KB : 0, kc1);
      named_bar(1 + cw, 128);  // every warp's product has read h
      eval_epilogue<true>(h, p.bp + (size_t)l * W, sm, cw, W / 16);
    }
    if constexpr (kGrid) {  // g into the x box (the trunk has read x_enc)
      load_grid(p, xbox, cw, row0);
      named_bar(1 + cw, 128);
      zero(acc);  // the trunk's last h is dead over load_grid
    }
    {  // [sem_hidden | sigma]: sigma out, s = relu(flax(...)) into the x box
      auto& ho = prefix<NS / 2>(acc);
      fwd_product<S>(ho, sm, it, sm + cw * 64 * 128, 0, KH);
      if ((t & 3) == 0)  // column SH: ho[4 (SH / 8) + 2 h] of the lanes with t % 4 = 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = eval_point(row0, h);
          if (pt < p.n) p.sigma[pt] = flax_dense(ho[4 * (SH / 8) + 2 * h], p.hb[SH]);
        }
      if constexpr (kGrid) named_bar(1 + cw, 128);  // every warp's product has read g
      if (p.use_sem) eval_epilogue<true>(ho, p.hb, xbox, cw, SH / 16);
    }
    if (p.use_sem) {  // sem = flax(s W_so, b_so)
      const uint32_t s = xbox + cw * 64 * 128;
      const int kcs = (SH + 63) / 64;
      if (p.cp > 64) {
        fwd_product<S>(prefix<64>(acc), sm, it, s, 0, kcs);
        store_eval<false>(prefix<64>(acc), p.bso, p.sem, p.classes, row0, p.n);
      } else {
        fwd_product<S>(prefix<32>(acc), sm, it, s, 0, kcs);
        store_eval<false>(prefix<32>(acc), p.bso, p.sem, p.classes, row0, p.n);
      }
    }
    named_bar(1 + cw, 128);  // every warp's product has read s
    if constexpr (kGrid) {
      load_grid(p, xbox, cw, row0);
      named_bar(1 + cw, 128);
    } else {
      encode_d(p, xbox, cw, row0);  // published by the feature epilogue's barrier
    }
    zero(acc);
    {  // feature = flax([h | g] W_head[:, SA:], b), no ReLU, over h
      auto& feat = prefix<W / 2>(acc);
      fwd_product<S>(feat, sm, it, sm + cw * 64 * 128, 0, KH);
      named_bar(1 + cw, 128);
      if constexpr (kGrid) encode_d(p, xbox, cw, row0);  // g is read; published as above
      eval_epilogue<false>(feat, p.hb + SA, sm, cw, W / 16);
    }
    if (p.cwp > 64)
      colour_eval<S, W>(prefix<64>(acc), sm, it, p, cw);
    else
      colour_eval<S, W>(prefix<32>(acc), sm, it, p, cw);
    {  // rgb = sigmoid(flax(r W_co, b_co))
      auto& rgb = prefix<32>(acc);
      fwd_product<S>(rgb, sm, it, xbox + cw * 64 * 128, 0, (p.cwp + 63) / 64);
      store_eval<true>(rgb, p.bco, p.rgb, 3, row0, p.n);
    }
  }
}

// The encodings as E computes them, written out: block b fills rows 0-63 of
// a box with x_enc of points 64 b ..., copies them to x_out (n, 64) bf16, then
// fills them with d_enc and copies that to d_out, as E's consumers fill the
// x box (d_enc's scratch rows in the box after it).
__global__ void __launch_bounds__(128)
    encode_probe_kernel(const __grid_constant__ EvalParams p, bf16* x_out, bf16* d_out) {
  __shared__ __align__(1024) unsigned char box[2 * kBox];
  const uint32_t b = smem_u32(box);
  const int row0 = blockIdx.x * 64, t = threadIdx.x, r = t & 63, pt = row0 + r;
  for (int kind = 0; kind < 2; ++kind) {
    if (kind == 0)
      encode_x(p, b, 0, row0);
    else
      encode_d(p, b, 0, row0);
    __syncthreads();
    bf16* out = kind == 0 ? x_out : d_out;
    if (pt < p.n)
      for (int c = 4 * (t >> 6); c < 4 * (t >> 6) + 4; ++c)
        *reinterpret_cast<uint4*>(out + (size_t)pt * 64 + 8 * c) =
            *reinterpret_cast<const uint4*>(box + (sw128_row(r) ^ (c << 4)));
    __syncthreads();
  }
}

// The weights' TMA maps into p, its tile count, and the launch.
template <int W, bool kGrid>
int eval_fwd(EvalParams& p, const void* wp, const void* hw, const void* wso, const void* wch,
             const void* wco, cudaStream_t s) {
  using D = EvalDims<W>;
  using S = FwdSmem<W, true>;
  int err;
  if ((err = make_tma_map(&p.wp, wp, W, W + kFPad, p.layers)) ||
      (err = make_tma_map(&p.hw, hw, D::SA + W, W + (kGrid ? 32 : 0), 1)) ||
      (err = make_tma_map(&p.wch, wch, p.cwp, W + 32, 1)) ||
      (err = make_tma_map(&p.wco, wco, 32, p.cwp, 1)) ||
      (p.use_sem && (err = make_tma_map(&p.wso, wso, p.cp, D::SH, 1))))
    return err;
  p.tiles = (p.n + kBM - 1) / kBM;
  const int sms = sm_count(), grid = sms > 0 && sms < p.tiles ? sms : p.tiles;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t e = allow_smem((const void*)field_eval_kernel<W, kGrid>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  field_eval_kernel<W, kGrid><<<grid, kWsThreads, S::kBytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). The Python wrapper
// (ops/field_eval_cuda.py) checks dtypes, shapes and contiguity, allocates
// the outputs, and requires W in {64, 128, 256}, sem_hidden = W / 2, CP and
// CWP multiples of 32 up to 128, 1 <= L <= 32, x_freqs <= 10, d_freqs <= 4
// (or -1: no view directions), n = rays x samples >= 1; `grid` null, or g
// (n, 32) bf16 with hw (W + 32, HO). Returns 0 when the
// launch was accepted, else the CUDA error code (kTmaEncodeFailed when a TMA
// descriptor cannot be encoded); nothing synchronises.
extern "C" int field_eval_launch(const void* pts, const void* dirs, const void* wp, const void* bp,
                                 const void* hw, const void* hb, const void* wso, const void* bso,
                                 const void* wch, const void* bch, const void* wco,
                                 const void* bco, void* sigma, void* rgb, void* sem, int n,
                                 int samples, int width, int layers, unsigned skip_mask,
                                 int x_freqs, int d_freqs, int classes, int cwp, int cp,
                                 int use_sem, const void* grid, void* stream) {
  const auto cf = [](const void* q) { return static_cast<const float*>(q); };
  EvalParams p{};
  p.pts = cf(pts);
  p.dirs = cf(dirs);
  p.bp = cf(bp);
  p.hb = cf(hb);
  p.bso = cf(bso);
  p.bch = cf(bch);
  p.bco = cf(bco);
  p.sigma = static_cast<float*>(sigma);
  p.rgb = static_cast<float*>(rgb);
  p.sem = static_cast<float*>(sem);
  p.n = n;
  p.samples = samples;
  p.layers = layers;
  p.skip_mask = skip_mask;
  p.x_freqs = x_freqs;
  p.d_freqs = d_freqs;
  p.classes = classes;
  p.cwp = cwp;
  p.cp = cp;
  p.use_sem = use_sem;
  p.grid = static_cast<const bf16*>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid) switch (width) {
      case 64: return eval_fwd<64, true>(p, wp, hw, wso, wch, wco, s);
      case 128: return eval_fwd<128, true>(p, wp, hw, wso, wch, wco, s);
      case 256: return eval_fwd<256, true>(p, wp, hw, wso, wch, wco, s);
      default: return (int)cudaErrorInvalidValue;
    }
  switch (width) {
    case 64: return eval_fwd<64, false>(p, wp, hw, wso, wch, wco, s);
    case 128: return eval_fwd<128, false>(p, wp, hw, wso, wch, wco, s);
    case 256: return eval_fwd<256, false>(p, wp, hw, wso, wch, wco, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// E's encodings of n points on rays of `samples` points (the test of their
// bits): x_enc (n, 64) and d_enc (n, 64) bf16, as E's x box holds them.
extern "C" int field_eval_encode_launch(const void* pts, const void* dirs, void* x_out,
                                        void* d_out, int n, int samples, int x_freqs,
                                        int d_freqs, void* stream) {
  EvalParams p{};
  p.pts = static_cast<const float*>(pts);
  p.dirs = static_cast<const float*>(dirs);
  p.n = n;
  p.samples = samples;
  p.x_freqs = x_freqs;
  p.d_freqs = d_freqs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  encode_probe_kernel<<<(n + 63) / 64, 128, 0, s>>>(p, static_cast<bf16*>(x_out),
                                                   static_cast<bf16*>(d_out));
  return (int)cudaGetLastError();
}
