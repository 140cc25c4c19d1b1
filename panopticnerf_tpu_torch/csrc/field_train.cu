// The whole NeRF field for the training step, forward (kernel C) and
// backward (kernel C'), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of panopticnerf_tpu/ops/pallas_field_train.py:
//   C  = `field_train`'s forward (`_field_fwd_impl` -> `_field_fwd_kernel`),
//   C' = its backward (`_field_bwd_impl` -> `_field_bwd_kernel`), which is
//        also the backward of `field_hybrid`.
// It computes what those compute, with the same rounding placement (plain
// versions: ops/field_train.py field_forward_plain / field_backward_plain):
// the trunk as kernel B; ho = h @ W_head + b_head in f32, sigma its f32
// column, s = relu(ho_sem) rounded only as sem_out's input, sem = the f32
// product + the f32 bias; the colour input [bf16(feature) | d_enc] one
// product with K = W + 32, f32 bias, ReLU, rounded as color_out's input;
// f32 rgb logits. Backward: every upstream g rounded to bf16 before both
// of its products, db from the f32 g, the ReLU masks from the saved bf16
// activations, dx and dd in bf16, dW summed in f32 over all points and
// stored as bf16 (mode "field") or float32 (mode "hybrid").
//
// Packed layout (ops/field_train.py): x (N, 64), d (N, 32) bf16; trunk as
// mlp_train.cu; head block W_head (W, HO) with columns [sem_hidden (W/2) |
// sigma | 0 ... up to SA = W/2 + 32 | feature (W)], HO = SA + W; sem_out
// (W/2, CP); colour hidden (W + 32, CWP); color_out (CWP, 32); biases f32
// of the same widths. CP, CWP <= 128 are multiples of 32.
//
// What bounds it: per point the field forward is 1.257 MFLOP (trunk 0.982,
// heads 0.275: head block [sem_hidden | sigma | feature] 0.197, colour
// hidden 0.072, sem_out and color_out 0.006); the training step runs
// 131,072 coarse + 262,144 fine points: 0.49 TFLOP forward, twice that
// backward (dW and g W^T). The functions' own I/O (x, d, weights, outputs;
// for C' the upstream g, dx, dd, dW, db) is < 100 MB, so both are
// compute-bound on the tensor cores (989 TFLOP/s bf16): C 0.167 / 0.333 ms
// at the coarse / fine N, C' 0.333 / 0.667 ms. Two costs of this design
// come on top: the packed shapes add 2.3 % of products (1.286 MFLOP per
// point), and C writes the activations C' reads (5,120 B per point at W =
// 256, 1.34 GB at the fine N: 0.40 ms of HBM time that C' then reads
// back). What the design does about it:
//   - C: the tile engine of mlp_common.cuh (kernel B's) runs the trunk,
//     then every head out of the same shared memory, each product a wgmma
//     chain over weight stages that the producer warpgroup streams by TMA:
//     [sem_hidden | sigma] (N = 192 at W = 256, the head block's columns
//     from 0; f32 sigma to `out`, bf16 s into the s / r tile: the x box,
//     which the trunk no longer reads, and one more box), sem_out on s,
//     the feature columns (N = W from column SA; bf16, no ReLU, written
//     over h, whose last reader is that product), [feature | d_enc] @ W_ch
//     (d_enc loaded by TMA into the x box once sem_out has read s there),
//     r into the s / r tile, and color_out on r; then the next tile's x
//     goes into the x box. Sharing that box leaves room for a 4-stage ring
//     at W = 256. Head widths under 64 (CP, the 32 color_out columns)
//     run as N = 64 on boxes whose columns past the tensor are zeros. C
//     saves what C' needs by TMA stores from the tiles (the trunk's
//     activations, as B does, s, bf16(feature), r); sigma, sem and the rgb
//     logits are f32 stores from the accumulators.
//   - C': the TPU kernel carries dW across its sequential grid in VMEM;
//     Hopper blocks run in parallel, so C' is B''s three-pass plan over the
//     whole field: (1) a data pass per 128-point tile for the heads — g_rgb
//     -> color_out^T -> mask -> W_ch^T -> g_feature, dd; g_sem -> sem_out^T
//     -> mask; [g_s | g_sigma | g_feature] -> W_head^T — writing each
//     product's bf16 g, db partials and the trunk's f32 upstream g; then
//     B''s data pass for the trunk (wgmma, TMA and mbarrier rings,
//     mlp_common.cuh); (2) split-K weight passes: B''s for the trunk, and
//     the same kernel once more for the four head blocks together (the
//     head block, sem_out, [feature | d_enc] with its two A sources, and
//     color_out), plain stores of partials; (3) reductions over the splits
//     and the db partials in a fixed order (no atomics: the step stays
//     deterministic).
//   Without saved activations (mode "hybrid", whose forward is plain
//   GEMMs in flax's placement) C' first runs C's forward to recompute them
//   in the kernel's placement, as the TPU kernel recomputes in VMEM.
//
// C''s heads data pass is still the first design: mma.sync at one 8-warp
// block per tile, the heads' column passes re-reading the tile from
// shared memory.

#include "mlp_common.cuh"

namespace {

constexpr int kDPad = 32;     // d_enc columns
constexpr int kCO = 32;       // color_out columns (3 used)

template <int W>
struct Dims {
  static constexpr int SH = W / 2, SA = SH + 32, HO = SA + W;
  static constexpr int NCMAX = W > kHeadMax ? W : kHeadMax;
};

// ------------------------------------------------------------ forward (C)

// sem = bf16(s) @ W_so + b_so in f32, to `sem` (N, classes): K = SH,
// N = 2R columns (64 or 128).
template <class S, int R>
__device__ __forceinline__ void sem_head(float (&acc)[R], uint32_t sm, uint32_t& it, int sh,
                                         const float* __restrict__ bso, float* __restrict__ sem,
                                         int classes, int cw, int row0, int n) {
  fwd_product<S>(acc, sm, it, sm + S::kX + cw * 64 * 128, 0, (sh + 63) / 64);
  store_cols(acc, bso, sem, classes, 0, classes, row0, n);
}

// r = bf16(relu([feature | d_enc] @ W_ch + b_ch)) into the s / r tile (the
// x box, once the product has read d_enc there, and the box after it) and
// to `rmap`: K = W + 64 (the tile's h boxes, then d_enc, its columns past
// 32 zeros), N = 2R columns (64 or 128).
template <class S, int W, int R>
__device__ __forceinline__ void colour_hidden(float (&acc)[R], uint32_t sm, uint32_t& it,
                                              const CUtensorMap* rmap,
                                              const float* __restrict__ bch, int cwp, int cw,
                                              int row0, int n) {
  fwd_product<S>(acc, sm, it, sm + cw * 64 * 128, 0, W / 64 + 1);
  tile_free(cw);
  fwd_epilogue<true>(acc, bch, sm + S::kX, cw, cwp / 16);
  tile_written(rmap, sm + S::kX, (cwp + 63) / 64, cw, row0, 0, n);
}

struct FwdArgs {
  const bf16 *x, *d, *wp;
  const float* bp;
  const bf16* hw;
  const float* hb;
  const bf16* wso;
  const float* bso;
  const bf16* wch;
  const float* bch;
  const bf16* wco;
  const float* bco;
  float *out, *sem;
  bf16 *acts, *s_sv, *feat, *r_sv;
  int n, layers;
  unsigned skip_mask;
  int classes, cwp, cp, use_sem;
};

struct FieldFwdParams {
  // x (N, 64), d (N, 32), wp (L, W + 64, W), hw (W, HO), wso (SH, CP), wch
  // (W + 32, CWP), wco (CWP, 32); out: acts (L, N, W), s (N, SH), feat (N,
  // W), r (N, CWP)
  CUtensorMap x, d, wp, hw, wso, wch, wco, acts, s, feat, r;
  const float *bp, *hb, *bso, *bch, *bco;
  float* out;  // (N, 4): sigma, rgb logits
  float* sem;  // (N, classes) or null
  int n, layers;
  unsigned skip_mask;
  int classes, cwp, cp, use_sem, tiles;
};

template <int W>
__global__ void __launch_bounds__(kWsThreads, 1)
    field_fwd_kernel(const __grid_constant__ FieldFwdParams p) {
  using D = Dims<W>;
  using S = FwdSmem<W, true>;
  constexpr int SH = D::SH, SA = D::SA, KB = W / 64;
  constexpr int NS = (SA + 63) / 64 * 64;  // [sem_hidden | sigma] product: whole boxes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm = fwd_setup<S>(smem_raw);
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t it = 0, xi = 0;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      const int nsem = p.cp > 64 ? 2 : 1, nch = p.cwp > 64 ? 2 : 1;  // N = 128, else 64
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        push_trunk<S, W>(sm, it, &p.wp, p.layers, p.skip_mask);
        for (int kc = 0; kc < KB; ++kc) push<S>(sm, it, &p.hw, 0, 64 * kc, 0, NS / 64);
        if (p.use_sem)
          for (int kc = 0; kc < (SH + 63) / 64; ++kc) push<S>(sm, it, &p.wso, 0, 64 * kc, 0, nsem);
        for (int kc = 0; kc < KB; ++kc) push<S>(sm, it, &p.hw, SA, 64 * kc, 0, KB);
        for (int kc = 0; kc <= KB; ++kc) push<S>(sm, it, &p.wch, 0, 64 * kc, 0, nch);
        for (int kc = 0; kc < (p.cwp + 63) / 64; ++kc)
          push<S>(sm, it, &p.wco, 0, 64 * kc, 0, 1);
      }
    } else if (warp == 1 && lane == 0) {  // x, then d_enc, into the x box
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        push_rows<S>(sm, xi, &p.x, tile * kBM, p.n);
        push_rows<S>(sm, xi, &p.d, tile * kBM, p.n);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x & 127;
  {  // zeros in this warpgroup's rows of the s / r tile's second box: the
     // columns a product reads past its K (s and r narrower than 128) then
     // hold zeros or earlier finite values (the first box: x, d_enc, s, r)
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = t; i < 64 * 8; i += 128) {
      const uint32_t at = sm + S::kX + kBox + cw * 64 * 128 + i * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(z.x), "r"(z.y),
                   "r"(z.z), "r"(z.w)
                   : "memory");
    }
    fence_proxy_async();
    named_bar(1 + cw, 128);
  }
  float acc[D::NCMAX / 2];  // every product's: one of N columns uses acc[0, N / 2)
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * kBM + cw * 64;
    trunk_tile<S, W>(prefix<W / 2>(acc), sm, it, xi, &p.acts, p.bp, p.layers,
                     p.skip_mask, cw, row0, p.n);
    {  // [sem_hidden | sigma]: sigma = ho in f32, s = bf16(relu(ho))
      auto& ho = prefix<NS / 2>(acc);
      fwd_product<S>(ho, sm, it, sm + cw * 64 * 128, 0, KB);
      if ((t & 3) == 0)  // column SH: ho[4 (SH / 8) + 2 h] of the lanes with t % 4 = 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = row0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8 * h;
          if (pt < p.n) p.out[(size_t)pt * 4] = ho[4 * (SH / 8) + 2 * h] + p.hb[SH];
        }
      if (p.use_sem) {
        tile_free(cw);
        fwd_epilogue<true>(ho, p.hb, sm + S::kX, cw, SH / 16);
        tile_written(&p.s, sm + S::kX, (SH + 63) / 64, cw, row0, 0, p.n);
      }
    }
    if (p.use_sem) {  // sem = bf16(s) @ W_so + b_so, f32
      if (p.cp > 64)
        sem_head<S>(prefix<64>(acc), sm, it, SH, p.bso, p.sem, p.classes, cw, row0,
                    p.n);
      else
        sem_head<S>(prefix<32>(acc), sm, it, SH, p.bso, p.sem, p.classes, cw, row0,
                    p.n);
    }
    if (t == 0) tma_store_wait_read();  // s's store has read the x box
    release(S::xempty(sm));             // x, then s: the x box is free for d_enc
    ++xi;
    {  // feature = bf16(ho + b), no ReLU, over h
      auto& feat = prefix<W / 2>(acc);
      fwd_product<S>(feat, sm, it, sm + cw * 64 * 128, 0, KB);
      tile_free(cw);
      fwd_epilogue<false>(feat, p.hb + SA, sm, cw, W / 16);
      tile_written(&p.feat, sm, KB, cw, row0, 0, p.n);
    }
    // r = bf16(relu([feature | d_enc] @ W_ch + b_ch)); d_enc is in the x box
    mbar_wait(S::xfull(sm), xi & 1);
    if (p.cwp > 64)
      colour_hidden<S, W>(prefix<64>(acc), sm, it, &p.r, p.bch, p.cwp, cw, row0, p.n);
    else
      colour_hidden<S, W>(prefix<32>(acc), sm, it, &p.r, p.bch, p.cwp, cw, row0, p.n);
    {  // rgb logits = bf16(r) @ W_co + b_co, f32
      auto& rgb = prefix<32>(acc);
      fwd_product<S>(rgb, sm, it, sm + S::kX + cw * 64 * 128, 0, (p.cwp + 63) / 64);
      store_cols(rgb, p.bco, p.out, 4, 1, 3, row0, p.n);
    }
    if (t == 0) tma_store_wait_read();  // r's store has read the x box
    release(S::xempty(sm));             // d_enc, then r: free for the next tile's x
    ++xi;
  }
  if (t == 0) tma_store_wait();
}

// ------------------------------------------- backward (C'), heads data pass

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_heads_kernel(const float* __restrict__ g_out,  // (N, 4) g_sigma, g_rgb logits
                           const float* __restrict__ g_sem,  // (N, classes) or null
                           const bf16* __restrict__ s_sv, const bf16* __restrict__ r_sv,
                           const bf16* __restrict__ hw, const bf16* __restrict__ wso,
                           const bf16* __restrict__ wch, const bf16* __restrict__ wco,
                           float* __restrict__ g_h,     // (N, W) out: the trunk's upstream g
                           bf16* __restrict__ gb_co,    // (N, 32) out: bf16 g of each product
                           bf16* __restrict__ gb_r,     // (N, cwp)
                           bf16* __restrict__ gb_sem,   // (N, cp)
                           bf16* __restrict__ gb_ho,    // (N, HO)
                           bf16* __restrict__ dd,       // (N, 32) out
                           float* __restrict__ db_part, // (blocks, HO + cp + cwp + 32) out
                           int n, int classes, int cwp, int cp, int use_sem) {
  using D = Dims<W>;
  constexpr int SH = D::SH, SA = D::SA, HO = D::HO;
  constexpr int LDH = HO + kPad, LDC = kCO + kPad, LDS = kHeadMax + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gho = reinterpret_cast<bf16*>(smem_raw);  // kBM x LDH: [g_s | g_sigma | 0 | g_feature]
  bf16* gco = gho + kBM * LDH;                     // kBM x LDC
  bf16* gr = gco + kBM * LDC;                      // kBM x LDS
  bf16* gsem = gco;                                // kBM x LDS, once g_co and g_r are consumed
  bf16* wbuf = gr + kBM * LDS;                     // 2 x NCMAX x (kKC + kPad)
  float* dbw = reinterpret_cast<float*>(wbuf + 2 * D::NCMAX * (kKC + kPad));  // 2 x NCMAX
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int hb_len = HO + cp + cwp + kCO;
  float* db_ho = db_part + (size_t)blockIdx.x * hb_len;
  float* db_so = db_ho + HO;
  float* db_ch = db_so + cp;
  float* db_co = db_ch + cwp;

  // db of the biases the upstream g feeds directly (sigma, rgb, sem), rows
  // in order; every other entry is written below or stays 0
  for (int c = tid; c < hb_len; c += kThreads) db_ho[c] = 0.f;
  __syncthreads();
  if (tid < 4 || (use_sem && tid >= 32 && tid < 32 + classes)) {
    const bool rgb = tid < 4;
    const float* src = rgb ? g_out + tid : g_sem + (tid - 32);
    const int ld = rgb ? 4 : classes;
    float s = 0.f;
    for (int r = 0; r < kBM && row0 + r < n; ++r) s += src[(size_t)(row0 + r) * ld];
    if (!rgb)
      db_so[tid - 32] = s;
    else if (tid == 0)
      db_ho[SH] = s;
    else
      db_co[tid - 1] = s;
  }

  // g_co = [g_rgb | 0] -> bf16
  for (int i = tid; i < kBM * kCO; i += kThreads) {
    const int r = i / kCO, c = i % kCO, p = row0 + r;
    const bf16 b = __float2bfloat16_rn(p < n && c < 3 ? g_out[(size_t)p * 4 + 1 + c] : 0.f);
    gco[r * LDC + c] = b;
    if (p < n) gb_co[(size_t)p * kCO + c] = b;
  }
  {  // g_r = (g_co @ W_co^T) * (r > 0) -> bf16
    float acc[4][kHeadMax / 32][4];
    zero_acc(acc);
    gemm_nt<kHeadMax / 32, false>(acc, gco, LDC, 0, wbuf, wco, kCO, kCO, cwp);
    mask_by<kHeadMax / 32, false>(acc, cwp, r_sv, cwp, row0, n);
    for_each_pair<kHeadMax / 32, false>(acc, cwp, [&](int r, int col, float v0, float v1) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(gr + r * LDS + col) = b;
      if (row0 + r < n) *reinterpret_cast<__nv_bfloat162*>(gb_r + (size_t)(row0 + r) * cwp + col) = b;
    });
    col_sums<kHeadMax / 32, false>(acc, cwp, dbw, db_ch);
  }
  {  // g_feature = (g_r @ W_ch^T)[:, :W] -> bf16 into gho
    float acc[4][W / 32][4];
    zero_acc(acc);
    gemm_nt<W / 32, true>(acc, gr, LDS, 0, wbuf, wch, cwp, cwp, W);
    for_each_pair<W / 32, true>(acc, W, [&](int r, int col, float& v0, float& v1) {
      if (row0 + r >= n) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(gho + r * LDH + SA + col) = __floats2bfloat162_rn(v0, v1);
    });
    col_sums<W / 32, true>(acc, W, dbw, db_ho + SA);
  }
  {  // dd = (g_r @ W_ch^T)[:, W : W + 32] -> bf16
    float acc[4][1][4];
    zero_acc(acc);
    gemm_nt<1, true>(acc, gr, LDS, 0, wbuf, wch + (size_t)W * cwp, cwp, cwp, kDPad);
    for_each_pair<1, true>(acc, kDPad, [&](int r, int col, float v0, float v1) {
      if (row0 + r < n)
        *reinterpret_cast<__nv_bfloat162*>(dd + (size_t)(row0 + r) * kDPad + col) =
            __floats2bfloat162_rn(v0, v1);
    });
  }
  if (use_sem) {  // g_s = (bf16(g_sem) @ W_so^T) * (s > 0) -> bf16 into gho
    for (int i = tid; i < kBM * cp; i += kThreads) {
      const int r = i / cp, c = i % cp, p = row0 + r;
      const bf16 b = __float2bfloat16_rn(p < n && c < classes ? g_sem[(size_t)p * classes + c] : 0.f);
      gsem[r * LDS + c] = b;
      if (p < n) gb_sem[(size_t)p * cp + c] = b;
    }
    float acc[4][SH / 32][4];
    zero_acc(acc);
    gemm_nt<SH / 32, true>(acc, gsem, LDS, 0, wbuf, wso, cp, cp, SH);
    mask_by<SH / 32, true>(acc, SH, s_sv, SH, row0, n);
    for_each_pair<SH / 32, true>(acc, SH, [&](int r, int col, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(gho + r * LDH + col) = __floats2bfloat162_rn(v0, v1);
    });
    col_sums<SH / 32, true>(acc, SH, dbw, db_ho);
  } else {
    for (int i = tid; i < kBM * SH; i += kThreads) gho[(i / SH) * LDH + i % SH] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < kBM * (SA - SH); i += kThreads) {  // [g_sigma | 0]
    const int r = i / (SA - SH), c = i % (SA - SH), p = row0 + r;
    gho[r * LDH + SH + c] = __float2bfloat16_rn(c == 0 && p < n ? g_out[(size_t)p * 4] : 0.f);
  }
  __syncthreads();
  for (int i = tid; i < kBM * (HO / 8); i += kThreads) {  // for the head block's weight pass
    const int r = i / (HO / 8), seg = i % (HO / 8);
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(gb_ho + (size_t)(row0 + r) * HO + seg * 8) =
          *reinterpret_cast<const uint4*>(gho + r * LDH + seg * 8);
  }
  {  // the trunk's upstream g = bf16(g_ho) @ W_head^T, f32
    float acc[4][W / 32][4];
    zero_acc(acc);
    gemm_nt<W / 32, true>(acc, gho, LDH, 0, wbuf, hw, HO, HO, W);
    for_each_pair<W / 32, true>(acc, W, [&](int r, int col, float v0, float v1) {
      if (row0 + r < n)
        *reinterpret_cast<float2*>(g_h + (size_t)(row0 + r) * W + col) = make_float2(v0, v1);
    });
  }
}

template <int W>
size_t heads_smem() {
  using D = Dims<W>;
  return (size_t)(kBM * (D::HO + kPad) + kBM * (kCO + kPad) + kBM * (kHeadMax + kPad) +
                  2 * D::NCMAX * (kKC + kPad)) *
             sizeof(bf16) +
         2 * D::NCMAX * sizeof(float);
}


template <int W>
int fwd(const FwdArgs& a, cudaStream_t s) {
  using D = Dims<W>;
  using S = FwdSmem<W, true>;
  FieldFwdParams p{};
  int err;
  if ((err = make_tma_map(&p.x, a.x, kFPad, a.n, 1)) ||
      (err = make_tma_map(&p.d, a.d, kDPad, a.n, 1)) ||
      (err = make_tma_map(&p.wp, a.wp, W, W + kFPad, a.layers)) ||
      (err = make_tma_map(&p.hw, a.hw, D::HO, W, 1)) ||
      (err = make_tma_map(&p.wch, a.wch, a.cwp, W + kDPad, 1)) ||
      (err = make_tma_map(&p.wco, a.wco, kCO, a.cwp, 1)) ||
      (err = make_tma_map(&p.acts, a.acts, W, a.n, a.layers)) ||
      (err = make_tma_map(&p.feat, a.feat, W, a.n, 1)) ||
      (err = make_tma_map(&p.r, a.r_sv, a.cwp, a.n, 1)))
    return err;
  if (a.use_sem && ((err = make_tma_map(&p.wso, a.wso, a.cp, D::SH, 1)) ||
                    (err = make_tma_map(&p.s, a.s_sv, D::SH, a.n, 1))))
    return err;
  p.bp = a.bp;
  p.hb = a.hb;
  p.bso = a.bso;
  p.bch = a.bch;
  p.bco = a.bco;
  p.out = a.out;
  p.sem = a.sem;
  p.n = a.n;
  p.layers = a.layers;
  p.skip_mask = a.skip_mask;
  p.classes = a.classes;
  p.cwp = a.cwp;
  p.cp = a.cp;
  p.use_sem = a.use_sem;
  p.tiles = (a.n + kBM - 1) / kBM;
  const int sms = sm_count(), grid = sms > 0 && sms < p.tiles ? sms : p.tiles;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t e = allow_smem((const void*)field_fwd_kernel<W>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  field_fwd_kernel<W><<<grid, kWsThreads, S::kBytes, s>>>(p);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const bf16 *x, *d, *wp, *hw, *wso, *wch, *wco, *acts, *s_sv, *feat, *r_sv;
  const float *g_out, *g_sem;
  float* g_h;
  bf16 *gbuf, *gb_co, *gb_r, *gb_sem, *gb_ho;
  float *db_part_t, *db_part_h, *gx_part, *dw_part_t, *part;
  bf16 *dx, *dd;
  void *dwp, *dhw, *dwso, *dwch, *dwco;
  float *dbp, *db_h;
  int n, layers;
  unsigned skip_mask;
  int classes, cwp, cp, use_sem, splits, chunk;
};

template <int W, typename DW>
int bwd(const BwdArgs& a, cudaStream_t s) {
  using D = Dims<W>;
  const int blocks = (a.n + kBM - 1) / kBM;
  const size_t smem = heads_smem<W>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = allow_smem((const void*)field_bwd_heads_kernel<W>, (int)smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  field_bwd_heads_kernel<W><<<blocks, kThreads, smem, s>>>(
      a.g_out, a.g_sem, a.s_sv, a.r_sv, a.hw, a.wso, a.wch, a.wco, a.g_h, a.gb_co, a.gb_r,
      a.gb_sem, a.gb_ho, a.dd, a.db_part_h, a.n, a.classes, a.cwp, a.cp, a.use_sem);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // the head blocks' dW, one launch of the trunk's weight pass; `part`
  // holds each block's splits x rows (64-row slices) x columns in turn;
  // map 0 (acts) is the one the trunk's passes encode
  WgradArgs wa{};
  wa.n = a.n;
  wa.chunk = a.chunk;
  int err = trunk_bwd<W, DW>(a.x, a.wp, a.acts, a.g_h, a.gbuf, a.db_part_t, a.gx_part,
                             a.dw_part_t, a.dx, static_cast<DW*>(a.dwp), a.dbp, a.n, a.layers,
                             a.skip_mask, a.splits, a.chunk, wa.map[0], s);
  if (err) return err;
  if ((err = make_tma_map(&wa.map[2], a.feat, W, a.n, 1)) ||
      (err = make_tma_map(&wa.map[3], a.d, kDPad, a.n, 1)) ||
      (err = make_tma_map(&wa.map[4], a.r_sv, a.cwp, a.n, 1)) ||
      (err = make_tma_map(&wa.map[5], a.gb_ho, D::HO, a.n, 1)) ||
      (err = make_tma_map(&wa.map[7], a.gb_r, a.cwp, a.n, 1)) ||
      (err = make_tma_map(&wa.map[8], a.gb_co, kCO, a.n, 1)))
    return err;
  if (a.use_sem && ((err = make_tma_map(&wa.map[1], a.s_sv, D::SH, a.n, 1)) ||
                    (err = make_tma_map(&wa.map[6], a.gb_sem, a.cp, a.n, 1))))
    return err;
  struct Reduce {
    const float* part;
    size_t stride, total;
    DW* dw;
  } red[4];
  int nred = 0, ctas = 0;
  float* part = a.part;
  uint32_t sl[kMaxSlices];
  auto job = [&](int slices, int b_map, int nc, int m_out, void* dw) {
    const size_t stride = (size_t)slices * 64 * nc;
    add_wgrad_job(wa, ctas, W, sl, slices, b_map, 0, nc, part, (long long)stride);
    red[nred++] = {part, stride, (size_t)m_out * nc, static_cast<DW*>(dw)};
    part += stride * a.splits;
  };
  // the head block: dW (W x HO) = h^T g_ho, h = acts[L - 1]
  for (int i = 0; i < W / 64; ++i) sl[i] = wslice(0, a.layers - 1, 64 * i);
  job(W / 64, 5, D::HO, W, a.dhw);
  if (a.use_sem) {  // sem_out: (SH x cp) = s^T g_sem
    for (int i = 0; i < (D::SH + 63) / 64; ++i) sl[i] = wslice(1, 0, 64 * i);
    job((D::SH + 63) / 64, 6, a.cp, D::SH, a.dwso);
  }
  // colour hidden: ((W + 32) x cwp) = [feature | d]^T g_r
  for (int i = 0; i < W / 64; ++i) sl[i] = wslice(2, 0, 64 * i);
  sl[W / 64] = wslice(3, 0, 0);
  job(W / 64 + 1, 7, a.cwp, W + kDPad, a.dwch);
  // color_out: (cwp x 32) = r^T g_co
  for (int i = 0; i < (a.cwp + 63) / 64; ++i) sl[i] = wslice(4, 0, 64 * i);
  job((a.cwp + 63) / 64, 8, kCO, a.cwp, a.dwco);
  if ((err = wgrad<W>(wa, ctas, a.splits, s))) return err;
  for (int i = 0; i < nred; ++i) {
    reduce_splits_kernel<DW><<<512, 256, 0, s>>>(red[i].part, a.splits, red[i].stride,
                                                 red[i].total, red[i].dw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int hb_len = D::HO + a.cp + a.cwp + kCO;
  reduce_db_kernel<<<(hb_len + 255) / 256, 256, 0, s>>>(a.db_part_h, a.db_h, blocks, hb_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). The Python wrapper
// (ops/field_train_cuda.py) checks dtypes, shapes and contiguity, allocates
// every output and scratch buffer, and requires W in {64, 128, 256},
// sem_hidden = W / 2, CP and CWP multiples of 32 up to 128, 1 <= L <= 32
// and n >= 1. Each returns 0 when every launch was accepted, else the CUDA
// error code (kTmaEncodeFailed when a TMA descriptor cannot be encoded);
// nothing synchronises.
extern "C" int field_fwd_launch(const void* x, const void* d, const void* wp, const void* bp,
                                const void* hw, const void* hb, const void* wso, const void* bso,
                                const void* wch, const void* bch, const void* wco,
                                const void* bco, void* out, void* sem, void* acts, void* s_sv,
                                void* feat, void* r_sv, int n, int width, int layers,
                                unsigned skip_mask, int classes, int cwp, int cp, int use_sem,
                                void* stream) {
  const FwdArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(d),
                  static_cast<const bf16*>(wp),   static_cast<const float*>(bp),
                  static_cast<const bf16*>(hw),   static_cast<const float*>(hb),
                  static_cast<const bf16*>(wso),  static_cast<const float*>(bso),
                  static_cast<const bf16*>(wch),  static_cast<const float*>(bch),
                  static_cast<const bf16*>(wco),  static_cast<const float*>(bco),
                  static_cast<float*>(out),       static_cast<float*>(sem),
                  static_cast<bf16*>(acts),       static_cast<bf16*>(s_sv),
                  static_cast<bf16*>(feat),       static_cast<bf16*>(r_sv),
                  n, layers, skip_mask, classes, cwp, cp, use_sem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return fwd<64>(a, s);
    case 128: return fwd<128>(a, s);
    case 256: return fwd<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int field_bwd_launch(const void* x, const void* d, const void* wp, const void* hw,
                                const void* wso, const void* wch, const void* wco,
                                const void* acts, const void* s_sv, const void* feat,
                                const void* r_sv, const void* g_out, const void* g_sem, void* g_h,
                                void* gbuf, void* gb_co, void* gb_r, void* gb_sem, void* gb_ho,
                                void* db_part_t, void* db_part_h, void* gx_part, void* dw_part_t,
                                void* part, void* dx, void* dd, void* dwp, void* dbp, void* dhw,
                                void* dwso, void* dwch, void* dwco, void* db_h, int n, int width,
                                int layers, unsigned skip_mask, int classes, int cwp, int cp,
                                int use_sem, int splits, int chunk, int dw_f32, void* stream) {
  const auto cb = [](const void* p) { return static_cast<const bf16*>(p); };
  const BwdArgs a{cb(x), cb(d), cb(wp), cb(hw), cb(wso), cb(wch), cb(wco), cb(acts), cb(s_sv),
                  cb(feat), cb(r_sv), static_cast<const float*>(g_out),
                  static_cast<const float*>(g_sem), static_cast<float*>(g_h),
                  static_cast<bf16*>(gbuf), static_cast<bf16*>(gb_co), static_cast<bf16*>(gb_r),
                  static_cast<bf16*>(gb_sem), static_cast<bf16*>(gb_ho),
                  static_cast<float*>(db_part_t), static_cast<float*>(db_part_h),
                  static_cast<float*>(gx_part), static_cast<float*>(dw_part_t),
                  static_cast<float*>(part), static_cast<bf16*>(dx), static_cast<bf16*>(dd), dwp,
                  dhw, dwso, dwch, dwco, static_cast<float*>(dbp), static_cast<float*>(db_h), n,
                  layers, skip_mask, classes, cwp, cp, use_sem, splits, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PNT_FIELD_BWD(WW) \
  (dw_f32 ? bwd<WW, float>(a, s) : bwd<WW, bf16>(a, s))
  switch (width) {
    case 64: return PNT_FIELD_BWD(64);
    case 128: return PNT_FIELD_BWD(128);
    case 256: return PNT_FIELD_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PNT_FIELD_BWD
}
