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
// Inputs: pts (P, 3) f32; one f32 table (rows_l, 2) per level (F = 2, the
// 16 levels). Output: g (P, 2 L) bf16, point-major, as E reads it.
//
// What bounds it: per point and level 8 gathers of 8 bytes from a table of
// up to T = 2^19 rows (4 MB), scattered, and ~60 f32 operations; its own I/O
// is 12 bytes in and 64 out per point. Neither bytes nor operations set the
// pace, but the stores: a row written in pieces by
// several blocks (4 bytes a level) costs a partial-sector write each, which
// took three quarters of a one-level-a-block kernel's time (a 33,088 x 128
// render tile on the H100: 1.94 ms, 0.48 ms with the stores left out).
// What the design does about it:
//   - whole rows: a block takes 128 consecutive points (256 threads) and all
//     16 levels of them, so each point's 64-byte row is written whole, 32
//     bytes by each of its two lanes (two 16-byte stores), and its 12 bytes
//     are read once. Every block then reads all 16 tables (49 MB against the
//     50 MB L2); on the H100 the whole rows still win: that tile takes 0.57 ms
//     with 16 levels a block, 0.68 with 8 (one 32-byte sector a point, the 8
//     tables of a group live in L2 at a time). Consecutive points are
//     neighbouring samples of one ray, whose corners share cells at the coarse
//     levels.
//   - lane pairing: two adjacent lanes 2j and 2j + 1 take a point; lane parity
//     c0 is the x-side of the cell. Each lane fetches its four corners c = c0 +
//     2 m (m = c1 + 2 c2), so in each of the 4 load instructions of a level the
//     two x-neighbours of a cell edge are requested together. They share a
//     line: Instant-NGP's first prime is 1, so a hashed level's x-neighbours are
//     rows kx ^ H and (kx + 1) ^ H (rows r and r ^ 1 of one 16-byte pair where
//     kx is even; in two lines only where kx mod 16 = 15), and a dense level's
//     are adjacent rows. A warp load then touches about half the lines; on the
//     H100 that did not set the pace (0.4 % of G with one level a block), and
//     the exchange below costs shuffles.
//   - the exchange keeps the plain order: a lane forms w_c theta[row] of its own
//     four corners for both features (w_c rounded as the plain version rounds
//     it) and sends its partner the feature the partner sums (__shfl_xor_sync,
//     lane ^ 1); lane c0 = 0 sums feature 0 and lane c0 = 1 feature 1, each over
//     the 8 corners in the order c = 0..7, so G stays bit for bit the plain
//     version. At the end each lane sends the other the features of the levels
//     it stores (lane 0 levels 0-7, lane 1 levels 8-15).
// Lanes past n clamp their point to n - 1 and skip their loads and store: the
// full-mask shuffles need every lane of the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;  // a block encodes every level of its points
constexpr int kThreads = 256;
constexpr int kPoints = kThreads / 2;  // two lanes a point
constexpr unsigned kFull = 0xffffffffu;

struct GridParams {
  const float* pts;
  const float2* tables[kLevels];  // F = 2: one float2 a row
  int res[kLevels];               // N_l
  int dense[kLevels];             // 1: the level's corners index its rows directly
  uint32_t mask;                  // T - 1
  int n;
  __nv_bfloat162* out;  // (n, kLevels) pairs
};

// Feature c0 of level `level`'s encoding of the point x3, by the lane pair
// (see the header): this lane's corners c = c0 + 2 m, its partner's by shuffle.
__device__ __forceinline__ float encode_level(const GridParams& p, int level, const float* x3,
                                              int c0, bool live) {
  const int res = p.res[level];
  const float fres = (float)res;
  float t[3];
  uint32_t k[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float u = fminf(fmaxf((x3[j] + 1.f) / 2.f, 0.f), 1.f);
    const float x = u * fres;
    const float i = fminf(floorf(x), fres - 1.f);
    t[j] = x - i;
    k[j] = (uint32_t)i;
  }
  const float2* __restrict__ tab = p.tables[level];
  const bool dense = p.dense[level];
  const uint32_t stride = (uint32_t)res + 1u;
  const uint32_t kx = k[0] + (uint32_t)c0;
  uint32_t rows[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t ky = k[1] + (m & 1), kz = k[2] + (m >> 1);
    rows[m] = dense ? kx + ky * stride + kz * stride * stride
                    : ((kx * 1u) ^ (ky * 2654435761u) ^ (kz * 805459861u)) & p.mask;
  }
  float2 v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = live ? __ldg(tab + rows[m]) : make_float2(0.f, 0.f);
  const float wx = c0 ? t[0] : 1.f - t[0];
  // own[m] / other[m]: the term of corner c0 + 2 m / (1 - c0) + 2 m in the feature this lane sums
  float own[4], other[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float w = wx * ((m & 1) ? t[1] : 1.f - t[1]) * ((m >> 1) ? t[2] : 1.f - t[2]);
    const float a = w * v[m].x, b = w * v[m].y;
    own[m] = c0 ? b : a;
    other[m] = __shfl_xor_sync(kFull, c0 ? a : b, 1);
  }
  float f = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float a = ((c & 1) == c0) ? own[c >> 1] : other[c >> 1];
    f = c ? f + a : a;  // the first term as it is: 0 + (-0) would be +0
  }
  return f;
}

__global__ void __launch_bounds__(kThreads) hash_grid_kernel(const __grid_constant__ GridParams p) {
  const int first = blockIdx.x * kPoints + (threadIdx.x & ~31) / 2;  // the warp's first point
  if (first >= p.n) return;  // the whole warp: no shuffle is left waiting
  const int c0 = threadIdx.x & 1;
  const int raw = blockIdx.x * kPoints + threadIdx.x / 2;
  const bool live = raw < p.n;
  const int pt = live ? raw : p.n - 1;
  const float* q = p.pts + (size_t)pt * 3;
  const float x3[3] = {q[0], q[1], q[2]};
  float f[kLevels];  // feature c0 of each level
#pragma unroll
  for (int l = 0; l < kLevels; ++l) f[l] = encode_level(p, l, x3, c0, live);
  // lane c0 stores levels c0 H .. c0 H + H - 1: its own feature of them, and
  // its partner's, which the partner sends
  constexpr int H = kLevels / 2;
  __align__(16) __nv_bfloat162 r[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float mine = c0 ? f[H + j] : f[j];
    const float got = __shfl_xor_sync(kFull, c0 ? f[j] : f[H + j], 1);
    r[j] = c0 ? __floats2bfloat162_rn(got, mine) : __floats2bfloat162_rn(mine, got);
  }
  if (!live) return;
  uint4* o = reinterpret_cast<uint4*>(p.out + (size_t)pt * kLevels + c0 * H);
#pragma unroll
  for (int j = 0; j < H / 4; ++j) o[j] = reinterpret_cast<const uint4*>(r)[j];
}

}  // namespace

// Plain C entry point (loaded with ctypes). The Python wrapper
// (ops/hash_grid_cuda.py) checks dtypes, shapes and contiguity, allocates
// the output and requires levels = 16, F = 2, n >= 1. `tables` and
// `res` / `dense` are host arrays of `levels` entries. Returns 0 when the
// launch was accepted, else the CUDA error code; nothing synchronises.
extern "C" int hash_grid_launch(const void* pts, const void* const* tables, const int* res,
                                const int* dense, int levels, int log2_table, int n, void* out,
                                void* stream) {
  if (levels != kLevels || log2_table < 1 || log2_table > 31 || n < 1)
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
  p.out = static_cast<__nv_bfloat162*>(out);
  const int blocks = (n + kPoints - 1) / kPoints;
  hash_grid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
