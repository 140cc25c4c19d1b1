// Ray x primitive interval intersection: slab test + convex cut planes +
// per-ray top-K nearest-entry intervals, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `intersect_rays_pallas` (its body `_kernel` ->
// `_intersect_tile`) in panopticnerf_tpu/ops/pallas_intersect.py. Computes
// what that kernel computes; it is not a block-by-block translation:
//   - L lanes per ray (L = 4, 8, 16 or 32, at least K and min(P, 32)); lane
//     s of a ray tests primitives s, s + L, s + 2L, ... one round at a time,
//     so at P <= 32 every primitive has its own lane and there is one round;
//   - the ray keeps a list of its L first hits, entry s in lane s. After a
//     round, each hit of the round and each list entry finds its rank in
//     the merged order by counting the items before it, on the key (t_in,
//     primitive index) compared lexicographically: the round's hits are
//     broadcast one by one (a loop over the warp's ballot of hits, one
//     shuffle each), then the list's entries. Every item whose rank is
//     below L goes to its slot in the warp's shared scratch, and lane s
//     reads entry s back. Most (ray, primitive) pairs miss, so the work
//     follows the hits, not P. Equal entry depths keep the lowest primitive
//     index first: the TPU kernel's "min, then first index" rule, lax.top_k's
//     and the plain version's stable sort;
//   - lane s writes entry s of its ray (s < K), so a warp's stores cover
//     whole runs of K entries;
//   - the block stages its group's primitive table (and cut planes, F > 0)
//     in shared memory as one row per field, so that the lanes of a ray
//     read neighbouring words; the grid (ops/intersect_cuda.py
//     `intersect_plan`) gives every group enough blocks to fill the card,
//     each block walking its share of the group's rays;
//   - labels are written as int32 directly (the TPU kernel carried them as
//     f32 through its one-hot selects).
//
// What bounds it on the card: per ray it does 3*P slab tests plus F*P plane
// tests (P = 32, F = 0 on the synthetic flagship views: ~100 flops per
// primitive) and writes N*K*(4+4+4+4+1) bytes (about 9 MB per 33,088-ray
// view at K = 16): about 3 us of HBM traffic at 3.35 TB/s and 0.1 GFLOP of
// fp32 work. A2's 2,048 rays need ~0.2 us of either, so the launch is most
// of its time.
//
// Arithmetic: the slab math keeps the reference's association
// (o_l = ((x0 r0 + x1 r1) + x2 r2) + t, inv = 1 / d_l, t1 = (-1 - o_l) inv,
// t2 = (1 - o_l) inv), and the library is built with -fmad=false, so it
// agrees bit for bit with the plain PyTorch version (ops/intersect.py,
// whose eager ops round after every multiply and add).
//
// The table is indexed by group (blockIdx.y): G = 1 is the single-table
// evaluation path (A1); G view groups of M rays each is the grouped
// training path (A2, the TPU kernel `intersect_groups_pallas`), the same
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // allow_smem

namespace {

constexpr float kBig = 1e9f;
constexpr float kParEps = 1e-9f;    // axis-parallel slab test
constexpr float kPlaneEps = 1e-9f;  // plane-parallel test
constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;
constexpr int kTableMax = 48 * 1024;  // the wrapper's limit on the staged table

// Shared memory: the table, then the merge scratch (a slot per thread:
// t_in, t_out, primitive index).
inline size_t table_bytes(int p, int f) {
  return (size_t)p * (12 + 4 * f) * sizeof(float) + 3 * (size_t)p * sizeof(int32_t);
}
constexpr size_t kScratchBytes = 3 * kThreads * sizeof(float);

template <int L>
__global__ void __launch_bounds__(kThreads)
intersect_kernel(const float* __restrict__ rays_o,   // (G, M, 3)
                 const float* __restrict__ rays_d,   // (G, M, 3)
                 const float* __restrict__ w2p,      // (G, P, 12)
                 const int32_t* __restrict__ sem,    // (G, P)
                 const int32_t* __restrict__ inst,   // (G, P)
                 const uint8_t* __restrict__ valid,  // (G, P)
                 const float* __restrict__ planes,   // (G, P, F, 4) or null
                 int m, int p, int f, int k, float near, float far,
                 float* __restrict__ t_in_out,       // (G, M, K)
                 float* __restrict__ t_out_out,
                 int32_t* __restrict__ sem_out,
                 int32_t* __restrict__ inst_out,
                 uint8_t* __restrict__ mask_out) {
  extern __shared__ float smem[];
  float* s_aff = smem;                  // [12][P]: row i * 4 + c of every primitive
  float* s_planes = s_aff + p * 12;     // [F * 4][P]
  int32_t* s_sem = reinterpret_cast<int32_t*>(s_planes + p * f * 4);
  int32_t* s_inst = s_sem + p;
  int32_t* s_valid = s_inst + p;
  float* x_key = reinterpret_cast<float*>(s_valid + p);  // [kThreads] each
  float* x_tout = x_key + kThreads;
  int32_t* x_q = reinterpret_cast<int32_t*>(x_tout + kThreads);

  const int g = blockIdx.y;
  for (int i = threadIdx.x; i < p * 12; i += kThreads)
    s_aff[(i % 12) * p + i / 12] = w2p[(size_t)g * p * 12 + i];
  for (int i = threadIdx.x; i < p * f * 4; i += kThreads)
    s_planes[(i % (f * 4)) * p + i / (f * 4)] = planes[(size_t)g * p * f * 4 + i];
  for (int i = threadIdx.x; i < p; i += kThreads) {
    s_sem[i] = sem[(size_t)g * p + i];
    s_inst[i] = inst[(size_t)g * p + i];
    s_valid[i] = valid[(size_t)g * p + i];
  }
  __syncthreads();

  constexpr int kRays = kThreads / L;  // rays per block and pass
  const int lane = threadIdx.x & 31, s = threadIdx.x & (L - 1);
  const int slot0 = threadIdx.x - s;  // the ray's L scratch slots
  // the lanes of this lane's ray within the warp
  const unsigned seg = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane - s);
  // every lane of the block runs the same passes: the shuffles need whole warps
  for (int base = blockIdx.x * kRays; base < m; base += gridDim.x * kRays) {
    const int r = base + threadIdx.x / L;
    const bool live = r < m;
    const size_t ray = (size_t)g * m + (live ? r : 0);
    const float ox = rays_o[ray * 3 + 0], oy = rays_o[ray * 3 + 1], oz = rays_o[ray * 3 + 2];
    const float dx = rays_d[ray * 3 + 0], dy = rays_d[ray * 3 + 1], dz = rays_d[ray * 3 + 2];
    int cnt = 0;                       // hits in the ray's list
    float key = 0.f, tout = 0.f;       // list entry s (s < cnt): t_in, t_out,
    int qs = 0;                        // primitive index
    for (int q0 = 0; q0 < p; q0 += L) {
      const int q = q0 + s;
      float tin = 0.f, to = 0.f;
      bool hit = false;
      if (q < p && s_valid[q]) {
        float lo = -kBig, hi = kBig;
        float o_l[3], d_l[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float a0 = s_aff[(4 * i + 0) * p + q], a1 = s_aff[(4 * i + 1) * p + q];
          const float a2 = s_aff[(4 * i + 2) * p + q], a3 = s_aff[(4 * i + 3) * p + q];
          const float ol = ((ox * a0 + oy * a1) + oz * a2) + a3;
          const float dl = (dx * a0 + dy * a1) + dz * a2;
          o_l[i] = ol;
          d_l[i] = dl;
          const bool par = fabsf(dl) < kParEps;
          const float safe = par ? (dl >= 0.f ? kParEps : -kParEps) : dl;
          const float inv = 1.0f / safe;
          const float t1 = (-1.0f - ol) * inv;
          const float t2 = (1.0f - ol) * inv;
          const bool par_out = par && fabsf(ol) > 1.0f;
          lo = fmaxf(lo, par_out ? kBig : fminf(t1, t2));
          hi = fminf(hi, par_out ? -kBig : fmaxf(t1, t2));
        }
        bool miss = false;
        for (int j = 0; j < f; ++j) {
          const float* pl = s_planes + 4 * j * p + q;
          const float n0 = pl[0], n1 = pl[p], n2 = pl[2 * p], b = pl[3 * p];
          const float a = (n0 * d_l[0] + n1 * d_l[1]) + n2 * d_l[2];
          const float cc = b - ((n0 * o_l[0] + n1 * o_l[1]) + n2 * o_l[2]);
          const float safe_a = fabsf(a) < kPlaneEps ? kPlaneEps : a;
          const float tp = cc / safe_a;
          if (a < -kPlaneEps) lo = fmaxf(lo, tp);
          if (a > kPlaneEps) hi = fminf(hi, tp);
          miss = miss || (fabsf(a) <= kPlaneEps && cc < 0.f);
        }
        if (miss) hi = -kBig;
        tin = fmaxf(lo, near);
        to = fminf(hi, far);
        hit = to > tin;
      }
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits == 0u) continue;  // the warp's rays keep their lists
      // rank of this lane's hit among the round's hits of its ray and the
      // list; shift of its list entry by the round's hits before it (a list
      // entry has a lower primitive index than any hit of this round, so it
      // goes first on equal t_in)
      int rank = 0, shift = 0;
      for (unsigned b = hits; b; b &= b - 1u) {
        const int j = __ffs(b) - 1;
        const float kj = __shfl_sync(0xffffffffu, tin, j);
        if ((seg >> j) & 1u) {
          rank += kj < tin || (kj == tin && j < lane);
          shift += kj < key;
        }
      }
      const int most = __reduce_max_sync(0xffffffffu, cnt);
      for (int j = 0; j < most; ++j) {
        const float kj = __shfl_sync(0xffffffffu, key, j, L);
        rank += j < cnt && kj <= tin;
      }
      if (s < cnt && s + shift < L) {
        x_key[slot0 + s + shift] = key;
        x_tout[slot0 + s + shift] = tout;
        x_q[slot0 + s + shift] = qs;
      }
      if (hit && rank < L) {
        x_key[slot0 + rank] = tin;
        x_tout[slot0 + rank] = to;
        x_q[slot0 + rank] = q;
      }
      cnt = min(L, cnt + __popc(hits & seg));
      __syncwarp();
      if (s < cnt) {
        key = x_key[threadIdx.x];
        tout = x_tout[threadIdx.x];
        qs = x_q[threadIdx.x];
      }
      __syncwarp();  // read before the next round writes
    }
    if (live && s < k) {
      const size_t at = ray * k + s;
      const bool in = s < cnt;
      t_in_out[at] = in ? key : kBig;
      t_out_out[at] = in ? tout : kBig;
      sem_out[at] = in ? s_sem[qs] : -1;
      inst_out[at] = in ? s_inst[qs] : -1;
      mask_out[at] = in ? 1 : 0;
    }
  }
}

template <int L>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const float* rays_o,
           const float* rays_d, const float* w2p, const int32_t* sem,
           const int32_t* inst, const uint8_t* valid, const float* planes, int m,
           int p, int f, int k, float near, float far, float* t_in, float* t_out,
           int32_t* sem_out, int32_t* inst_out, uint8_t* mask) {
  static std::atomic<unsigned long long> smem_set{0};
  if (smem > 48 * 1024) {  // a table near its limit and the scratch: raise the ceiling once
    const cudaError_t e = allow_smem((const void*)intersect_kernel<L>,
                                     (int)(kTableMax + kScratchBytes), smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  intersect_kernel<L><<<grid, kThreads, smem, stream>>>(
      rays_o, rays_d, w2p, sem, inst, valid, planes, m, p, f, k, near, far, t_in,
      t_out, sem_out, inst_out, mask);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes: rays (G, M, 3); table
// (G, P, 3, 4) + (G, P) labels/valid (+ (G, P, F, 4) planes, null when
// F == 0); outputs (G, M, K). The Python wrapper checks 1 <= K <= 32, that
// the shared-memory table fits in 48 KB, and gives the plan (`lanes` per
// ray, at least K; `blocks` along each group's rays). Returns the CUDA
// error of the launch (0 = launched).
extern "C" int intersect_rays_launch(const void* rays_o, const void* rays_d,
                                     const void* w2p, const void* sem,
                                     const void* inst, const void* valid,
                                     const void* planes, int g, int m, int p,
                                     int f, int k, float near, float far,
                                     void* t_in, void* t_out, void* sem_out,
                                     void* inst_out, void* mask, int lanes, int blocks,
                                     void* stream) {
  if (g <= 0 || m <= 0) return 0;
  if (k < 1 || k > lanes || lanes > kMaxLanes || blocks < 1 || p < 0 ||
      table_bytes(p, f) > kTableMax)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, g);
  const size_t smem = table_bytes(p, f) + kScratchBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PNT_LAUNCH(LL)                                                                          \
  launch<LL>(grid, smem, s, (const float*)rays_o, (const float*)rays_d, (const float*)w2p,      \
             (const int32_t*)sem, (const int32_t*)inst, (const uint8_t*)valid,                \
             (const float*)planes, m, p, f, k, near, far, (float*)t_in, (float*)t_out,        \
             (int32_t*)sem_out, (int32_t*)inst_out, (uint8_t*)mask)
  switch (lanes) {
    case 4: return PNT_LAUNCH(4);
    case 8: return PNT_LAUNCH(8);
    case 16: return PNT_LAUNCH(16);
    case 32: return PNT_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PNT_LAUNCH
}
