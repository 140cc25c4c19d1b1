// The multi-resolution hash grid's forward encoding (kernel G), for NVIDIA
// Hopper (sm_90a): the features of PanopticNeRF-360's hybrid field, which
// kernel E (field_eval.cu) reads as 32 more input columns of its heads.
//
// Replaces no TPU kernel: the JAX package has no grid. It computes what the
// plain encoding (ops/hash_grid.py hash_grid_encode) computes, in float32:
//   - u = clamp((p + 1) / 2, 0, 1) per coordinate of the scene-normalised
//     point p;
//   - at level l of resolution N_l: x = u N_l, i = min(floor(x), N_l - 1),
//     t = x - i; the 8 corners k = i + c in the order c = c0 + 2 c1 + 4 c2;
//     a dense level's row k0 + k1 (N_l + 1) + k2 (N_l + 1)^2, a hashed
//     level's (k0 * 1 ^ k1 * 2654435761 ^ k2 * 805459861) & (T - 1) in
//     uint32 arithmetic;
//   - f_l = the corners' sum of w_c theta_l[row], w_c = ((c0 ? t0 : 1 - t0)
//     (c1 ? t1 : 1 - t1)) (c2 ? t2 : 1 - t2), each product and sum rounded
//     once in the plain version's order (no multiply-add contraction), so
//     that G equals its plain version bit for bit; then rounded to bf16.
// tiny-cuda-nn's +0.5 cell offset and `scale - 1` resolutions are not
// followed: the paper's floor(N_min b^l) is (the host passes N_l).
//
// Inputs: pts (P, 3) f32; one f32 table (rows_l, 2) per level (F = 2, up to
// 16 levels). Output: g (P, 2 L) bf16, point-major, as E reads it.
//
// What bounds it: per point and level 8 gathers of 8 bytes from a table of
// up to T = 2^19 rows (4 MB), scattered, and ~60 f32 operations; its own I/O
// is 12 bytes in and 64 out per point. The gathers' sectors (32 bytes for 8
// used) set the pace: what the design does about it is locality. A block
// takes 256 consecutive points of one level (blockIdx.y), and the blocks of
// a level run together, so one level's table at a time is live in L2 (the
// 16 tables of a field, 49 MB, would not fit with the rest); consecutive
// points are neighbouring samples of one ray, whose corners share cells at
// the coarse levels. One thread per (point, level): its 8 gathers are
// independent loads in flight together (__ldg, the read-only path). The
// store is one bf16x2 per thread, 4 bytes of a point's 64-byte row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

struct GridParams {
  const float* pts;
  const float2* tables[kMaxLevels];  // F = 2: one float2 a row
  int res[kMaxLevels];               // N_l
  int dense[kMaxLevels];             // 1: the level's corners index its rows directly
  uint32_t mask;                     // T - 1
  int n, levels;
  __nv_bfloat162* out;  // (n, levels) pairs
};

__global__ void __launch_bounds__(kThreads) hash_grid_kernel(const __grid_constant__ GridParams p) {
  const int level = blockIdx.y;
  const int pt = blockIdx.x * kThreads + threadIdx.x;
  if (pt >= p.n) return;
  const int res = p.res[level];
  const float fres = (float)res;
  float t[3];
  uint32_t k[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float u = fminf(fmaxf((p.pts[(size_t)pt * 3 + j] + 1.f) / 2.f, 0.f), 1.f);
    const float x = u * fres;
    const float i = fminf(floorf(x), fres - 1.f);
    t[j] = x - i;
    k[j] = (uint32_t)i;
  }
  const float2* __restrict__ tab = p.tables[level];
  const bool dense = p.dense[level];
  const uint32_t stride = (uint32_t)res + 1u;
  uint32_t rows[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t kx = k[0] + (c & 1), ky = k[1] + ((c >> 1) & 1), kz = k[2] + ((c >> 2) & 1);
    rows[c] = dense ? kx + ky * stride + kz * stride * stride
                    : ((kx * 1u) ^ (ky * 2654435761u) ^ (kz * 805459861u)) & p.mask;
  }
  float2 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(tab + rows[c]);
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = ((c & 1) ? t[0] : 1.f - t[0]) * (((c >> 1) & 1) ? t[1] : 1.f - t[1]) *
                    (((c >> 2) & 1) ? t[2] : 1.f - t[2]);
    const float a = w * v[c].x, b = w * v[c].y;
    f0 = c ? f0 + a : a;  // the first term as it is: 0 + (-0) would be +0
    f1 = c ? f1 + b : b;
  }
  p.out[(size_t)pt * p.levels + level] = __floats2bfloat162_rn(f0, f1);
}

}  // namespace

// Plain C entry point (loaded with ctypes). The Python wrapper
// (ops/hash_grid_cuda.py) checks dtypes, shapes and contiguity, allocates
// the output and requires 1 <= levels <= 16, F = 2, n >= 1. `tables` and
// `res` / `dense` are host arrays of `levels` entries. Returns 0 when the
// launch was accepted, else the CUDA error code; nothing synchronises.
extern "C" int hash_grid_launch(const void* pts, const void* const* tables, const int* res,
                                const int* dense, int levels, int log2_table, int n, void* out,
                                void* stream) {
  if (levels < 1 || levels > kMaxLevels || log2_table < 1 || log2_table > 31 || n < 1)
    return (int)cudaErrorInvalidValue;
  GridParams p{};
  p.pts = static_cast<const float*>(pts);
  for (int l = 0; l < levels; ++l) {
    p.tables[l] = static_cast<const float2*>(tables[l]);
    p.res[l] = res[l];
    p.dense[l] = dense[l];
  }
  p.mask = (1u << log2_table) - 1u;
  p.n = n;
  p.levels = levels;
  p.out = static_cast<__nv_bfloat162*>(out);
  const dim3 grid((n + kThreads - 1) / kThreads, levels);
  hash_grid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
