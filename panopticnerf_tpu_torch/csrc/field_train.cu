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
//     B''s data pass for the trunk; (2) split-K weight passes: B''s for the
//     trunk, and the same kernel once more for the four head blocks
//     together (the head block, sem_out, [feature | d_enc] with its two A
//     sources, and color_out), plain stores of partials; (3) reductions over
//     the splits and the db partials in a fixed order (no atomics: the step
//     stays deterministic). Every pass is written for Hopper with wgmma,
//     TMA and mbarrier rings (mlp_common.cuh). The heads' data pass moves
//     2,908 bytes per point at W = 256 (`heads_data_plan_bytes`: g_h in f32
//     1,024, gb_ho 832) against ~0.33 MFLOP of products: HBM bound (0.23 ms
//     at the fine N). Its design: persistent over tiles, one producer
//     warpgroup streaming the head weights through a ring (re-read from L2
//     for every tile, ~300 KB) and loading each tile's saved s and r into
//     the tiles where the masked g of their products is written, two
//     consumer warpgroups of 64 points whose products read every operand
//     from shared memory, every bf16 g leaving by a TMA store that overlaps
//     the next product.
//   Without saved activations (mode "hybrid", whose forward is plain
//   GEMMs in flax's placement) C' first runs C's forward to recompute them
//   in the kernel's placement, as the TPU kernel recomputes in VMEM.

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

// Shared memory of the heads' data pass (offsets from a 1024-aligned base),
// each tile 128 rows in 64-column boxes (wgmma's K-major A operand): the
// [g_s | g_sigma | 0] tile (SA columns in whole boxes; s loads into its
// first boxes, the mask of g_s), right after it the feature tile (g_feature;
// before that g_co, then g_sem), so that the product with W_head runs over
// both as one chain; the g_r tile (r loads into it, the mask of g_r); the
// weight ring, each stage up to 128 rows (N) of a head weight by 64 K
// columns (the K-major B operand of g W^T: four 16 KB stages at every
// width); each consumer warp's column sums; barriers.
constexpr int kHeadsDbw = kHeadMax;  // a consumer warp's column sums: the widest product's

template <int W>
struct HeadsSmem {
  static constexpr int kSaBoxes = (Dims<W>::SA + 63) / 64;
  static constexpr int kFBoxes = W / 64 > kHeadMax / 64 ? W / 64 : kHeadMax / 64;
  static constexpr int kSa = 0, kF = kSaBoxes * kBox, kGr = kF + kFBoxes * kBox;
  static constexpr int kRing = kGr + (kHeadMax / 64) * kBox;
  static constexpr int kStageBytes = kHeadMax * 128;
  static constexpr int kDbwBytes = 2 * 4 * kHeadsDbw * 4;
  static constexpr int kFree = kSmemMax - kRing - kDbwBytes - 256 - 1024;
  static constexpr int kStages = kFree / kStageBytes < 4 ? kFree / kStageBytes : 4;
  static constexpr int kDbw = kRing + kStages * kStageBytes;
  static constexpr int kBar = kDbw + kDbwBytes;  // full[], empty[], rfull[2], rempty[2], sfull[2], sempty[2]
  static constexpr int kBytes = kBar + 256 + 1024;  // + slack for the alignment
  static_assert(kStages >= 2, "the heads' data pass needs two ring stages");
  static __device__ __forceinline__ uint32_t stage(uint32_t sm, int st) {
    return sm + kRing + st * kStageBytes;
  }
  static __device__ __forceinline__ uint32_t full(uint32_t sm, int st) { return sm + kBar + 8 * st; }
  static __device__ __forceinline__ uint32_t empty(uint32_t sm, int st) {
    return sm + kBar + 8 * (kStages + st);
  }
  // per consumer warpgroup: its half of the r tile / of the s boxes
  static __device__ __forceinline__ uint32_t rfull(uint32_t sm, int cw) {
    return sm + kBar + 16 * kStages + 8 * cw;
  }
  static __device__ __forceinline__ uint32_t rempty(uint32_t sm, int cw) { return rfull(sm, cw) + 16; }
  static __device__ __forceinline__ uint32_t sfull(uint32_t sm, int cw) { return rfull(sm, cw) + 32; }
  static __device__ __forceinline__ uint32_t sempty(uint32_t sm, int cw) { return rfull(sm, cw) + 48; }
};

// Producer: rows [row0, row0 + 64 boxes) of `map` at column col (64 K
// columns) into the next ring stage.
template <class S>
__device__ __forceinline__ void push_k(uint32_t sm, uint32_t& it, const CUtensorMap* map, int col,
                                       int row0, int boxes) {
  const int st = it % S::kStages;
  mbar_wait(S::empty(sm, st), ((it / S::kStages) & 1) ^ 1);
  mbar_expect_tx(S::full(sm, st), boxes * 64 * 128);
  for (int b = 0; b < boxes; ++b)
    tma_load(S::stage(sm, st) + b * 64 * 128, map, S::full(sm, st), col, row0 + 64 * b, 0);
  ++it;
}

// Producer: this warpgroup's 64 rows of `boxes` boxes of `map` (a saved
// activation) into a tile at `dst`, once the consumers released them; a
// half past n is not loaded (its g is 0).
__device__ __forceinline__ void push_half(uint32_t full, uint32_t empty, uint32_t parity,
                                          const CUtensorMap* map, uint32_t dst, int boxes,
                                          int row0, int n) {
  mbar_wait(empty, parity ^ 1);
  mbar_expect_tx(full, row0 < n ? boxes * 64 * 128 : 0);
  if (row0 < n)
    for (int b = 0; b < boxes; ++b) tma_load(dst + b * kBox, map, full, 64 * b, row0, 0);
}

struct HeadsParams {
  // loads: the head weights, wco (CWP, 32), wch (W + 32, CWP), wso (SH, CP),
  // hw (W, HO), and the saved s (N, SH), r (N, CWP); stores: gb_co (N, 32),
  // gb_r (N, CWP), gb_sem (N, CP), gb_ho (N, HO) and its first SA columns
  CUtensorMap wco, wch, wso, hw, s, r, gco, gr, gsem, gho, gsa;
  const float* g_out;  // (N, 4): g_sigma, g_rgb logits
  const float* g_sem;  // (N, classes) or null
  float* g_h;          // (N, W) out: the trunk's upstream g
  bf16* dd;            // (N, 32) out
  float* db_part;      // (2 x blocks, HO + CP + CWP + 32) out
  int n, classes, cwp, cp, use_sem, tiles;
};

// The epilogue of one head product (or of an upstream g loaded into the
// accumulator layout) on a consumer warpgroup's 64 x 2R f32 g: mask by the
// tile's own bytes (the saved activation loaded there) in the first
// `mask_jps` groups of 16 columns, bf16 rounding written over them by
// stmatrix (the next product's A operand), the async-proxy fence, a TMA
// store of `boxes` boxes of this warpgroup's rows of the tile at `src` to
// `map` at column col0 (none if map is null), and the column sums of the
// f32 g into db_out[0, cols <= 128): this block's earlier tiles plus this
// one, in order.
template <int R>
__device__ __forceinline__ void heads_epilogue(float (&acc)[R], uint32_t tile, int mask_jps,
                                               float* dbw, float* __restrict__ db_out, int cols,
                                               bool add, const CUtensorMap* map, uint32_t src,
                                               int boxes, int col0, int cw, int row0, int n) {
  static_assert(2 * R <= kHeadsDbw, "a head product of at most 128 columns");
  const int t = threadIdx.x & 127, w = t >> 5;
  // this block's sum of its earlier tiles, loaded early
  const float prev = add && t < cols ? db_out[t] : 0.f;
  const uint32_t row = tile + lane_row(cw);
#pragma unroll
  for (int jp = 0; jp < R / 8; ++jp) {
    const uint32_t at = at_jp(row, jp);
    if (jp < mask_jps) {
      uint32_t m[4];
      ldsm_x4_at(m, at);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // act > 0: bf16 bits in [0x0001, 0x7f80] (NaN is not)
          const uint32_t bits = (m[q] >> (16 * e)) & 0xffffu;
          acc[8 * jp + 2 * q + e] = bits - 1u < 0x7f80u ? acc[8 * jp + 2 * q + e] : 0.f;
        }
    }
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(acc[8 * jp + 2 * q], acc[8 * jp + 2 * q + 1]);
      v[q] = *reinterpret_cast<const uint32_t*>(&b);
    }
    stsm_x4_at(at, v);
  }
  fence_proxy_async();
  named_bar(1 + cw, 128);  // the tile is written; the last epilogue's sums are read
  if (map && t == 0 && row0 < n) {
    for (int kb = 0; kb < boxes; ++kb)
      tma_store(map, src + kb * kBox + cw * 64 * 128, col0 + 64 * kb, row0, 0);
    tma_store_commit();
  }
  warp_col_sums(acc, dbw + w * kHeadsDbw);
  named_bar(1 + cw, 128);
  if (t < cols) {
    const float v =
        ((dbw[t] + dbw[kHeadsDbw + t]) + dbw[2 * kHeadsDbw + t]) + dbw[3 * kHeadsDbw + t];
    db_out[t] = add ? prev + v : v;
  }
}

// This thread's two points: row0 + 16 w + (lane / 4) + 8 h, h = 0, 1.
__device__ __forceinline__ int my_point(int row0, int h) {
  return row0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// g_r = mask_r(bf16([g_rgb | 0]) @ W_co^T) -> the g_r tile, gb_r, db_ch:
// g_co (written by the caller into the feature tile's first box) times the
// ring's W_co stage, N = 2R columns (64 or 128).
template <class S, int R, int RA>
__device__ __forceinline__ void colour_out_bwd(float (&acc)[RA], uint32_t sm, uint32_t& it,
                                               float* dbw, const HeadsParams& p, float* db,
                                               bool add, int ti, int cw, int row0) {
  auto& a = prefix<R>(acc);
  fwd_product<S, R, true>(a, sm, it, sm + S::kF + cw * 64 * 128, 0, 1);
  mbar_wait(S::rfull(sm, cw), ti & 1);
  heads_epilogue(a, sm + S::kGr, R / 8, dbw, db, p.cwp, add, &p.gr, sm + S::kGr, R / 32, 0, cw,
                 row0, p.n);
}

// g_sem (f32) into the accumulator layout -> bf16 in the feature tile's
// first boxes, gb_sem, db_so; then g_s = bf16(g_sem) @ W_so^T (NS columns).
template <class S, int R, int NS, int RA>
__device__ __forceinline__ void sem_out_bwd(float (&acc)[RA], uint32_t sm, uint32_t& it,
                                            float* dbw, const HeadsParams& p, float* db, bool add,
                                            int cw, int row0) {
  {
    auto& a = prefix<R>(acc);
    const int tq = threadIdx.x & 3;
    const float* rows[2];  // this thread's two rows of g_sem from column 2 tq
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pt = my_point(row0, h);
      in[h] = pt < p.n;
      rows[h] = p.g_sem + (size_t)(in[h] ? pt : 0) * p.classes + 2 * tq;
    }
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          a[4 * j + 2 * h + e] =
              in[h] && 8 * j + 2 * tq + e < p.classes ? rows[h][8 * j + e] : 0.f;
    tile_free(cw);  // the feature tile's first box: gb_co's store has read it
    heads_epilogue(a, sm + S::kF, 0, dbw, db, p.cp, add, &p.gsem, sm + S::kF, R / 32, 0, cw,
                   row0, p.n);
  }
  fwd_product<S, NS / 2, true>(prefix<NS / 2>(acc), sm, it, sm + S::kF + cw * 64 * 128, 0,
                               (p.cp + 63) / 64);
}

// Persistent over 128-point tiles (block b takes tiles b, b + gridDim.x,
// ...). Warp 0 of the producer streams the head weights in the consumers'
// order (W_co, W_so, W_ch's first W rows, its d_enc rows, W_head's
// [sem_hidden | sigma | 0] columns then its feature columns), each chunk
// the rows of one product's N by 64 K columns; warp 1 loads each consumer
// warpgroup's rows of r into the g_r tile and of s into the first boxes of
// the [g_s | g_sigma | 0] tile, once that warpgroup has finished with the
// last tile's (after dd, after the product with W_head). Each consumer
// warpgroup takes 64 points of the tile:
//   g_co = [g_rgb | 0] (f32, read from global memory into the accumulator
//     layout) -> bf16 into the feature tile, gb_co, db_co;
//   g_r = mask_r(g_co W_co^T) -> the g_r tile, gb_r, db_ch;
//   g_sem -> bf16 into the feature tile, gb_sem, db_so; g_s = mask_s(g_sem
//     W_so^T) -> the [g_s | ...] tile, db_ho[0, SH); [g_sigma | 0] beside
//     it (within g_s's box at W = 64) -> db_ho[SH, SA); that tile -> gb_ho's
//     first SA columns;
//   g_feature = g_r W_ch^T (rows [0, W)) -> the feature tile, gb_ho from
//     column SA, db_ho[SA, HO); dd = g_r W_ch^T (rows [W, W + 32)) -> dd;
//   g_h = [g_s | g_sigma | 0 | g_feature] W_head^T, one chain over both
//     tiles (hw's columns from 0, then from SA) -> g_h in f32.
// Every product is a wgmma chain from shared memory; the bf16 g of each is
// written by stmatrix where the next product reads it and saved by a TMA
// store that overlaps the next products. No product is wider than N = 128
// (64 accumulator registers): at W = 256, g_feature and g_h run as two
// halves of 128 output columns each (with N = 256 chains beside the
// narrow ones, ptxas serialized every chain, C7512). db: one partial per
// block and consumer warpgroup, summed over the block's tiles in order.
template <int W>
__global__ void __launch_bounds__(kWsThreads, 1)
    field_bwd_heads_kernel(const __grid_constant__ HeadsParams p) {
  using D = Dims<W>;
  using S = HeadsSmem<W>;
  constexpr int SH = D::SH, SA = D::SA, HO = D::HO, KB = W / 64;
  constexpr int NS = SH < 64 ? 64 : SH;  // g_s's product: whole boxes
  constexpr int NH = W > kHeadMax ? 2 : 1, WH = W / NH, KBH = WH / 64;  // g_feature, g_h halves
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sm = smem_u32(base);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(S::full(sm, i), 1);
      mbar_init(S::empty(sm, i), 8);
    }
    for (int cw = 0; cw < 2; ++cw) {
      mbar_init(S::rfull(sm, cw), 1);
      mbar_init(S::rempty(sm, cw), 4);
      mbar_init(S::sfull(sm, cw), 1);
      mbar_init(S::sempty(sm, cw), 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cwc = (p.cwp + 63) / 64;  // K chunks of the products with W_ch

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        push_k<S>(sm, it, &p.wco, 0, 0, cwc);
        if (p.use_sem)
          for (int kc = 0; kc < (p.cp + 63) / 64; ++kc)
            push_k<S>(sm, it, &p.wso, 64 * kc, 0, NS / 64);
        for (int hf = 0; hf < NH; ++hf)
          for (int kc = 0; kc < cwc; ++kc) push_k<S>(sm, it, &p.wch, 64 * kc, WH * hf, KBH);
        for (int kc = 0; kc < cwc; ++kc) push_k<S>(sm, it, &p.wch, 64 * kc, W, 1);
        for (int hf = 0; hf < NH; ++hf) {  // W_head's [g_s | g_sigma | 0] columns, then SA + ...
          for (int kc = 0; kc < S::kSaBoxes; ++kc)
            push_k<S>(sm, it, &p.hw, 64 * kc, WH * hf, KBH);
          for (int kc = 0; kc < KB; ++kc) push_k<S>(sm, it, &p.hw, SA + 64 * kc, WH * hf, KBH);
        }
      }
    } else if (warp == 1 && lane == 0) {
      uint32_t ti = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
        for (int cw = 0; cw < 2; ++cw)
          push_half(S::rfull(sm, cw), S::rempty(sm, cw), ti & 1, &p.r,
                    sm + S::kGr + cw * 64 * 128, cwc, tile * kBM + cw * 64, p.n);
        for (int cw = 0; p.use_sem && cw < 2; ++cw)
          push_half(S::sfull(sm, cw), S::sempty(sm, cw), ti & 1, &p.s,
                    sm + S::kSa + cw * 64 * 128, (SH + 63) / 64, tile * kBM + cw * 64, p.n);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x & 127, tq = threadIdx.x & 3;
  float* dbw = reinterpret_cast<float*>(base + S::kDbw) + cw * 4 * kHeadsDbw;
  const int hb_len = HO + p.cp + p.cwp + kCO;
  float* db = p.db_part + (size_t)(2 * blockIdx.x + cw) * hb_len;
  // db row: [db_head (HO) | db_so (CP) | db_ch (CWP) | db_co (32)], its
  // parts addressed from `db` where they are used (fewer live registers)
  float acc[kHeadMax / 2];  // every product's: a prefix each
  uint32_t it = 0;
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    const int row0 = tile * kBM + cw * 64;
    const bool add = tile != (int)blockIdx.x;
    // g_sigma of this thread's point h, loaded where it is used
    const auto gsig = [&](int h) {
      const int pt = my_point(row0, h);
      return pt < p.n ? p.g_out[(size_t)pt * 4] : 0.f;
    };
    {  // g_co = [g_rgb | 0]: columns 0, 1 (tq = 0) and 2 (tq = 1) of each row
      auto& a = prefix<32>(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pt = my_point(row0, h);
        if (pt < p.n && tq < 2) {
          a[2 * h] = p.g_out[(size_t)pt * 4 + 1 + 2 * tq];
          if (tq == 0) a[2 * h + 1] = p.g_out[(size_t)pt * 4 + 2];
        }
      }
      tile_free(cw);  // the feature tile: the last tile's products and stores are done with it
      heads_epilogue(a, sm + S::kF, 0, dbw, db + HO + p.cp + p.cwp, kCO, add, &p.gco, sm + S::kF,
                     1, 0, cw, row0, p.n);
    }
    if (p.cwp > 64)
      colour_out_bwd<S, 64>(acc, sm, it, dbw, p, db + HO + p.cp, add, ti, cw, row0);
    else
      colour_out_bwd<S, 32>(acc, sm, it, dbw, p, db + HO + p.cp, add, ti, cw, row0);
    auto& gs = prefix<NS / 2>(acc);
    if (p.use_sem) {
      if (p.cp > 64)
        sem_out_bwd<S, 64, NS>(acc, sm, it, dbw, p, db + HO, add, cw, row0);
      else
        sem_out_bwd<S, 32, NS>(acc, sm, it, dbw, p, db + HO, add, cw, row0);
      mbar_wait(S::sfull(sm, cw), ti & 1);
    } else {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) gs[i] = 0.f;
      if (!add)
        for (int c = t; c < p.cp; c += 128) db[HO + c] = 0.f;
    }
    if (SH < 64 && tq == 0) {  // W = 64: g_sigma is column SH of g_s's box
#pragma unroll
      for (int h = 0; h < 2; ++h) gs[4 * (SH / 8) + 2 * h] = gsig(h);
    }
    tile_free(cw);  // the [g_s | ...] tile: the last tile's store has read it
    heads_epilogue(gs, sm + S::kSa, p.use_sem ? SH / 16 : 0, dbw, db, SH < 64 ? SA : SH, add,
                   SH < 64 ? &p.gsa : nullptr, sm + S::kSa, S::kSaBoxes, 0, cw, row0, p.n);
    if (SH >= 64) {  // [g_sigma | 0] in the box after g_s's
      auto& a = prefix<32>(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = 0.f;
      if (tq == 0) {
        a[0] = gsig(0);
        a[2] = gsig(1);
      }
      heads_epilogue(a, sm + S::kSa + (SH / 64) * kBox, 0, dbw, db + SH, SA - SH, add, &p.gsa,
                     sm + S::kSa, S::kSaBoxes, 0, cw, row0, p.n);
    }
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {  // g_feature = g_r W_ch^T, columns [WH hf, WH (hf + 1))
      auto& a = prefix<WH / 2>(acc);
      fwd_product<S, WH / 2, true>(a, sm, it, sm + S::kGr + cw * 64 * 128, 0, cwc);
      tile_free(cw);  // the feature tile: gb_sem's store has read it
      const uint32_t f = sm + S::kF + hf * KBH * kBox;
      heads_epilogue(a, f, 0, dbw, db + SA + WH * hf, WH, add, &p.gho, f, KBH, SA + WH * hf, cw,
                     row0, p.n);
    }
    {  // dd = g_r W_ch^T, columns [W, W + 32), bf16
      auto& a = prefix<32>(acc);
      fwd_product<S, 32, true>(a, sm, it, sm + S::kGr + cw * 64 * 128, 0, cwc);
#pragma unroll
      for (int j = 0; j < kDPad / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = my_point(row0, h);
          if (pt < p.n)
            *reinterpret_cast<__nv_bfloat162*>(p.dd + (size_t)pt * kDPad + 8 * j + 2 * tq) =
                __floats2bfloat162_rn(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }
    }
    tile_free(cw);  // gb_r's store has read the g_r tile: free for the next r
    release(S::rempty(sm, cw));
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {  // g_h = bf16(g_ho) W_head^T, f32, columns [WH hf, ...)
      auto& a = prefix<WH / 2>(acc);
      fwd_product<S, WH / 2, true>(a, sm, it, sm + S::kSa + cw * 64 * 128, 0, S::kSaBoxes + KB);
#pragma unroll
      for (int j = 0; j < WH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = my_point(row0, h);
          if (pt < p.n)
            *reinterpret_cast<float2*>(p.g_h + (size_t)pt * W + WH * hf + 8 * j + 2 * tq) =
                make_float2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }
    }
    if (p.use_sem) {
      tile_free(cw);  // the [g_s | ...] store has read it: free for the next s
      release(S::sempty(sm, cw));
    }
  }
  if (t == 0) tma_store_wait();
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
  using S = HeadsSmem<W>;
  HeadsParams hp{};
  int err;
  if ((err = make_tma_map(&hp.wco, a.wco, kCO, a.cwp, 1)) ||
      (err = make_tma_map(&hp.wch, a.wch, a.cwp, W + kDPad, 1)) ||
      (err = make_tma_map(&hp.hw, a.hw, D::HO, W, 1)) ||
      (err = make_tma_map(&hp.r, a.r_sv, a.cwp, a.n, 1)) ||
      (err = make_tma_map(&hp.gco, a.gb_co, kCO, a.n, 1)) ||
      (err = make_tma_map(&hp.gr, a.gb_r, a.cwp, a.n, 1)) ||
      (err = make_tma_map(&hp.gho, a.gb_ho, D::HO, a.n, 1)) ||
      (err = make_tma_map(&hp.gsa, a.gb_ho, D::SA, a.n, 1, D::HO)))
    return err;
  if (a.use_sem && ((err = make_tma_map(&hp.wso, a.wso, a.cp, D::SH, 1)) ||
                    (err = make_tma_map(&hp.s, a.s_sv, D::SH, a.n, 1)) ||
                    (err = make_tma_map(&hp.gsem, a.gb_sem, a.cp, a.n, 1))))
    return err;
  hp.g_out = a.g_out;
  hp.g_sem = a.g_sem;
  hp.g_h = a.g_h;
  hp.dd = a.dd;
  hp.db_part = a.db_part_h;
  hp.n = a.n;
  hp.classes = a.classes;
  hp.cwp = a.cwp;
  hp.cp = a.cp;
  hp.use_sem = a.use_sem;
  hp.tiles = (a.n + kBM - 1) / kBM;
  const int sms = sm_count(), grid = sms > 0 && sms < hp.tiles ? sms : hp.tiles;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = allow_smem((const void*)field_bwd_heads_kernel<W>, S::kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  field_bwd_heads_kernel<W><<<grid, kWsThreads, S::kBytes, s>>>(hp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // the head blocks' dW, one launch of the trunk's weight pass; `part`
  // holds each block's splits x rows (64-row slices) x columns in turn;
  // map 0 (acts) is the one the trunk's passes encode, the others the
  // heads' data pass encoded
  WgradArgs wa{};
  wa.n = a.n;
  wa.chunk = a.chunk;
  err = trunk_bwd<W, DW>(a.x, a.wp, a.acts, a.g_h, a.gbuf, a.db_part_t, a.gx_part,
                         a.dw_part_t, a.dx, static_cast<DW*>(a.dwp), a.dbp, a.n, a.layers,
                         a.skip_mask, a.splits, a.chunk, wa.map[0], s);
  if (err) return err;
  wa.map[4] = hp.r;
  wa.map[5] = hp.gho;
  wa.map[7] = hp.gr;
  wa.map[8] = hp.gco;
  if ((err = make_tma_map(&wa.map[2], a.feat, W, a.n, 1)) ||
      (err = make_tma_map(&wa.map[3], a.d, kDPad, a.n, 1)))
    return err;
  if (a.use_sem) {
    wa.map[1] = hp.s;
    wa.map[6] = hp.gsem;
  }
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
  reduce_db_kernel<<<(hb_len + 255) / 256, 256, 0, s>>>(a.db_part_h, a.db_h, 2 * grid, hb_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). The Python wrapper
// (ops/field_train_cuda.py) checks dtypes, shapes and contiguity, allocates
// every output and scratch buffer, and requires W in {64, 128, 256},
// sem_hidden = W / 2, CP and CWP multiples of 32 up to 128, 1 <= L <= 32
// and n >= 1; for C' it sizes db_part_t and db_part_h for two partials per
// 128-point tile (the data passes run min(SMs, tiles) blocks of two). Each
// returns 0 when every launch was accepted, else the CUDA error code
// (kTmaEncodeFailed when a TMA descriptor cannot be encoded); nothing
// synchronises.
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
                                int use_sem, int splits, int chunk, int dw_f32,
                                void* stream) {
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
