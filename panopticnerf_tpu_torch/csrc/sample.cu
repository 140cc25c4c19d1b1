// The evaluation render's sampling (kernel Z), for NVIDIA Hopper (sm_90a): a
// tile's guided coarse depths, and its inverse-CDF fine depths merged with
// them, one launch a level, a warp a ray.
//
// Replaces no TPU kernel: the JAX package samples with plain XLA ops. It
// computes what the plain ops of ops/sampling.py compute without `perturb`,
// in float32, each product, quotient and sum rounded once (the library is
// built with -fmad=false); only the order of three sums differs (below).
//   - coarse (`guided_z`): from A1's (N, K) t_in, t_out, mask, the union
//     segments: prev_end_k = max(-1e9, masked exits before k), seg_in =
//     max(t_in, prev_end), seg_len = max(0, t_out - seg_in) where masked
//     (else 0); cdf = the inclusive sums of seg_len, total its last entry; at
//     each of the S_in positions u_j = frac_j total, idx = #{cdf <= u_j}
//     clamped to K - 1 (searchsorted right), z = seg_in[idx] + (u_j -
//     cdf_prev[idx]); a ray whose total is <= 1e-8 takes the stratified
//     fallback row; then the stable merge with the S_bg background depths
//     (none: the in-interval depths as they are);
//   - fine (`sample_pdf` over the coarse midpoints and interior weights, then
//     `merge_z`): bins b_i = 0.5 (z_{i+1} + z_i); w_i = weight_{i+1} + 1e-5,
//     pdf = w / sum w, cdf = [0, inclusive sums of pdf]; at u_j = (j + 1) /
//     (M + 1): inds = #{cdf <= u_j}, below = clamp(inds - 1, 0, B - 1), above
//     = clamp(inds, 1, B), denom = cdf_hi - cdf_lo (1 where that is below
//     1e-5), z = b_lo + ((u_j - cdf_lo) / denom) (b_hi - b_lo); then the
//     stable merge of the coarse depths ahead of equal fine ones.
// The rows that are the same for every ray without `perturb` (the fractions
// frac_j, the fallback and background depths, the fine u_j) are computed once
// by the plain functions themselves and passed in (ops/sampling_cuda.py), so
// they are those functions' own roundings. The sums: the coarse cdf runs in
// index order (one sequential sum per lane, so it never decreases); the sum
// of w runs per lane over a stride of 32, then a butterfly; the cdf of the
// pdf in index order. ATen orders all three otherwise.
//
// The merges are stable rank sorts: an element's output position is the
// count of elements strictly smaller plus the count of equal ones earlier
// in the concatenation [first list, second list], which is torch.sort(stable)
// of the concatenation for any finite input. Where both lists are sorted
// (as the sampler's lists are, unless a rounding at a segment or bin edge
// puts two neighbours out of order) the rank of the i-th element of one list
// is i plus a binary search in the other; a warp vote finds any pair out of
// order, and that ray counts all pairs instead.
//
// What bounds it: bytes. A kitti360 ray reads its K = 16 intervals (9 bytes
// each) and writes 64 depths; the fine pass reads 64 depths and 64 weights
// and writes 128: ~1.4 KB a ray, 0.056 ms a 132,352-ray view at HBM's 3.35
// TB/s. The plain ops took a hundred times that, in ~30 launches of short
// rows (scans of 16 and 62 entries, a radix sort of 64 and of 128 keys). The
// design reads and writes each row once: a warp per ray, several rays a
// block; a row is staged in shared memory by coalesced loads, the scans run
// across lanes (shuffles), the searches and ranks read shared memory, and the
// merged row goes out by coalesced stores. No atomics, every sum in a fixed
// order: a call repeats bit for bit.
//
// Shapes (runtime): coarse 1 <= K <= 32 (a lane an interval), S_in >= 1,
// S_in + S_bg <= 1024; fine 3 <= S, M >= 1, S + M <= 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxIntervals = 32;
constexpr int kMaxRow = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNoEnd = -1e9f;     // the running max's start (the plain version's -1e9)
constexpr float kMinTotal = 1e-8f;  // a ray with no more union length hits nothing
constexpr int kSmemLimit = 48 * 1024;

// #{i < n: a[i] < x} for a non-decreasing a (the first index with a[i] >= x)
__device__ __forceinline__ int count_below(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// #{i < n: a[i] <= x} for a non-decreasing a (torch.searchsorted(right=True)'s search)
__device__ __forceinline__ int count_upto(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The stable merge of a = v[0, na) and b = v[na, na + nb) (shared memory) into
// the global row dst, staged through o (shared memory, na + nb floats).
__device__ void merge_rows(const float* v, int na, int nb, float* o, float* dst, int lane) {
  const int n = na + nb;
  bool out_of_order = false;
  for (int e = lane; e + 1 < n; e += 32)
    if (e + 1 != na && !(v[e] <= v[e + 1])) out_of_order = true;
  const bool sorted = !__any_sync(kFull, out_of_order);
  for (int e = lane; e < n; e += 32) {
    const float x = v[e];
    int r = 0;
    if (sorted) {
      r = e < na ? e + count_below(v + na, nb, x) : (e - na) + count_upto(v, na, x);
    } else {
      for (int j = 0; j < n; ++j) {
        const float y = v[j];
        r += (y < x) || (y == x && j < e);
      }
    }
    o[r] = x;
  }
  __syncwarp();
  for (int e = lane; e < n; e += 32) dst[e] = o[e];
}

struct CoarseParams {
  const float* t_in;        // (n, k)
  const float* t_out;       // (n, k)
  const uint8_t* mask;      // (n, k) bool
  const float* frac;        // (s_in,): u_j = frac_j total
  const float* z_fallback;  // (s_in,): the depths of a ray that hits nothing
  const float* z_bg;        // (s_bg,)
  float* z;                 // (n, s_in + s_bg)
  int n, k, s_in, s_bg;
};

__global__ void __launch_bounds__(32 * kMaxWarps)
    sample_coarse_kernel(const __grid_constant__ CoarseParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= p.n) return;  // the whole warp
  const int K = p.k, S = p.s_in + p.s_bg;
  float* const v = smem + (size_t)warp * 2 * S;
  float* const o = v + S;

  // lane k holds interval k
  float tin = 0.f, tout = 0.f;
  bool m = false;
  if (lane < K) {
    const size_t e = (size_t)ray * K + lane;
    tin = p.t_in[e];
    tout = p.t_out[e];
    m = p.mask[e] != 0;
  }
  // prev_end: the running max of the masked exits, exclusive (a max is exact in any order)
  float run = m ? tout : kNoEnd;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, run, d);
    if (lane >= d) run = fmaxf(run, y);
  }
  float prev_end = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) prev_end = kNoEnd;
  const float seg_in = fmaxf(tin, prev_end);
  float seg_len = 0.f;
  if (m) {
    const float d = __fsub_rn(tout, seg_in);
    seg_len = d > 0.f ? d : 0.f;
  }
  // cdf_k: seg_len_0 + ... + seg_len_k in index order
  float cdf = 0.f;
  for (int i = 0; i < K; ++i) {
    const float y = __shfl_sync(kFull, seg_len, i);
    if (i <= lane) cdf = __fadd_rn(cdf, y);
  }
  const float total = __shfl_sync(kFull, cdf, K - 1);
  const bool any_hit = total > kMinTotal;
  float cdf_prev = __shfl_up_sync(kFull, cdf, 1);
  if (lane == 0) cdf_prev = 0.f;

  for (int j0 = 0; j0 < p.s_in; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < p.s_in;
    const float u = valid ? __fmul_rn(p.frac[j], total) : 0.f;
    int cnt = 0;  // #{cdf <= u}: cdf never decreases
    for (int i = 0; i < K; ++i) cnt += __shfl_sync(kFull, cdf, i) <= u;
    const int idx = min(cnt, K - 1);
    const float si = __shfl_sync(kFull, seg_in, idx);
    const float cp = __shfl_sync(kFull, cdf_prev, idx);
    if (valid) v[j] = any_hit ? __fadd_rn(si, __fsub_rn(u, cp)) : p.z_fallback[j];
  }
  for (int j = lane; j < p.s_bg; j += 32) v[p.s_in + j] = p.z_bg[j];
  __syncwarp();
  float* const dst = p.z + (size_t)ray * S;
  if (p.s_bg == 0) {
    for (int e = lane; e < S; e += 32) dst[e] = v[e];
  } else {
    merge_rows(v, p.s_in, p.s_bg, o, dst, lane);
  }
}

struct FineParams {
  const float* z;    // (n, s) coarse depths
  const float* w;    // (n, s) coarse weights
  const float* u;    // (m,) the inverse-CDF positions
  float* z_all;      // (n, s + m)
  int n, s, m;
  float w_pad;       // 1e-5 as float32, added to every interior weight
  float min_denom;   // 1e-5 as float32, the narrowest cdf step interpolated
};

// per warp: v (s + m), o (s + m), bins (s - 1), cdf (s - 1), pdf (s - 2)
__host__ __device__ __forceinline__ int fine_warp_floats(int s, int m) {
  return 2 * (s + m) + 3 * s - 4;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    sample_fine_kernel(const __grid_constant__ FineParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= p.n) return;  // the whole warp
  const int S = p.s, M = p.m, B = S - 2;
  float* const v = smem + (size_t)warp * fine_warp_floats(S, M);
  float* const o = v + S + M;
  float* const bins = o + S + M;  // B + 1 midpoints
  float* const cdf = bins + B + 1;  // B + 1 entries, cdf[0] = 0
  float* const pdf = cdf + B + 1;   // B

  const float* const zr = p.z + (size_t)ray * S;
  const float* const wr = p.w + (size_t)ray * S;
  for (int e = lane; e < S; e += 32) v[e] = zr[e];
  float part = 0.f;  // the lane's share of sum w, over a stride of 32
  for (int i = lane; i < B; i += 32) {
    const float wi = __fadd_rn(wr[i + 1], p.w_pad);
    pdf[i] = wi;
    part = __fadd_rn(part, wi);
  }
  __syncwarp();
  for (int i = lane; i <= B; i += 32) bins[i] = __fmul_rn(0.5f, __fadd_rn(v[i + 1], v[i]));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part = __fadd_rn(part, __shfl_xor_sync(kFull, part, d));
  const float sum = part;  // the same on every lane
  for (int i = lane; i < B; i += 32) pdf[i] = __fdiv_rn(pdf[i], sum);
  __syncwarp();
  // cdf in index order: every lane runs the sum, lane i % 32 stores entry i + 1
  float acc = 0.f;
  if (lane == 0) cdf[0] = 0.f;
  for (int i = 0; i < B; ++i) {
    acc = __fadd_rn(acc, pdf[i]);
    if ((i & 31) == lane) cdf[i + 1] = acc;
  }
  __syncwarp();

  for (int j = lane; j < M; j += 32) {
    const float u = p.u[j];
    const int inds = count_upto(cdf, B + 1, u);
    const int below = min(max(inds - 1, 0), B - 1);
    const int above = min(max(inds, 1), B);
    const float c_lo = cdf[below], c_hi = cdf[above];
    const float b_lo = bins[below], b_hi = bins[above];
    const float step = __fsub_rn(c_hi, c_lo);
    const float denom = step < p.min_denom ? 1.f : step;
    const float frac = __fdiv_rn(__fsub_rn(u, c_lo), denom);
    v[S + j] = __fadd_rn(b_lo, __fmul_rn(frac, __fsub_rn(b_hi, b_lo)));
  }
  __syncwarp();
  merge_rows(v, S, M, o, p.z_all + (size_t)ray * (S + M), lane);
}

// as many warps (rays) a block as the static 48 KB of shared memory holds, up to kMaxWarps
int warps_for(int warp_floats) {
  return max(1, min(kMaxWarps, (int)(kSmemLimit / (warp_floats * sizeof(float)))));
}

}  // namespace

// Plain C entry points (loaded with ctypes). The Python wrapper
// (ops/sampling_cuda.py) checks dtypes, shapes and contiguity, computes the
// constant rows and allocates the outputs. Each returns 0 when the launch
// was accepted, else the CUDA error code; nothing synchronises.
extern "C" int sample_coarse_launch(const void* t_in, const void* t_out, const void* mask,
                                    const void* frac, const void* z_fallback, const void* z_bg,
                                    int n, int k, int s_in, int s_bg, void* z, void* stream) {
  if (n < 1 || k < 1 || k > kMaxIntervals || s_in < 1 || s_bg < 0 || s_in + s_bg > kMaxRow ||
      (s_bg > 0 && z_bg == nullptr))
    return (int)cudaErrorInvalidValue;
  CoarseParams p{};
  p.t_in = static_cast<const float*>(t_in);
  p.t_out = static_cast<const float*>(t_out);
  p.mask = static_cast<const uint8_t*>(mask);
  p.frac = static_cast<const float*>(frac);
  p.z_fallback = static_cast<const float*>(z_fallback);
  p.z_bg = static_cast<const float*>(z_bg);
  p.z = static_cast<float*>(z);
  p.n = n;
  p.k = k;
  p.s_in = s_in;
  p.s_bg = s_bg;
  const int warp_floats = 2 * (s_in + s_bg);
  const int warps = warps_for(warp_floats);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  sample_coarse_kernel<<<(n + warps - 1) / warps, 32 * warps, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int sample_fine_launch(const void* z, const void* w, const void* u, int n, int s,
                                  int m, float w_pad, float min_denom, void* z_all,
                                  void* stream) {
  if (n < 1 || s < 3 || m < 1 || s + m > kMaxRow) return (int)cudaErrorInvalidValue;
  FineParams p{};
  p.z = static_cast<const float*>(z);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.z_all = static_cast<float*>(z_all);
  p.n = n;
  p.s = s;
  p.m = m;
  p.w_pad = w_pad;
  p.min_denom = min_denom;
  const int warp_floats = fine_warp_floats(s, m);
  const int warps = warps_for(warp_floats);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  sample_fine_kernel<<<(n + warps - 1) / warps, 32 * warps, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
