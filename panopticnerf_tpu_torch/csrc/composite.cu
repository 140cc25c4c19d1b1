// Volume compositing of the evaluation render (kernel V), for NVIDIA Hopper
// (sm_90a): a tile and level's weights, maps, instance mass and fixed
// semantic map in one pass over the evaluation field's outputs.
//
// Replaces no TPU kernel: the JAX package composites with plain XLA ops. It
// computes what the plain ops compute (ops/composite.py `composite`,
// ops/intersect.py `samples_in_intervals`, `labeled_containment`,
// `fixed_map_from_weights`), in float32, each product and sum rounded once
// (the library is built with -fmad=false); only the order of the sums
// differs:
//   - delta_s = z_{s+1} - z_s (1e10 for the last sample) or the given delta;
//     density = max(a, 0) + log1p(exp(-|a|)) (logaddexp(a, 0), as ATen
//     computes it); tau = density delta; alpha = 1 - exp(-tau); the
//     exclusive transmittance exp(-sum_{j<s} tau_j); w = alpha trans;
//   - rgb = sum w rgb (+ 1 - acc on a white background), depth = sum w z,
//     acc = sum w, sem_logits = sum w logits;
//   - inside_sk = z_s >= t_in_k & z_s <= t_out_k & mask_k; labelled_k =
//     mask_k & semantic_k >= 0; cnt_s = sum_k inside_sk labelled_k;
//     inst_mass_k = sum_s w_s inside_sk; m_k = sum_s (w_s / max(cnt_s, 1))
//     inside_sk labelled_k; sem_fixed_c = sum_k m_k [clamp(semantic_k, 0,
//     C - 1) = c] labelled_k.
//
// What bounds it: bytes. Per point it reads the field's f32 sigma, rgb and
// C logits and z (and delta under keep-M) and writes w: 100 bytes at C = 19,
// against ~50 f32 operations; per ray the K intervals and the maps. A
// 132,352-ray view at 64 + 128 samples is 2.54 GB, 0.76 ms at HBM's 3.35
// TB/s. The plain ops took ~35 times that, almost all of it temporaries:
// (N, S, K) containments, (N, S, C) products, int64 counts. The design moves
// each byte once and keeps every temporary on the chip:
//   - a warp per ray. The ray's samples go in rounds of 32, a sample a lane;
//     each round's inputs (sigma, 33 z, delta, rgb, the round's (32, C)
//     logit rows, contiguous in memory) are copied global -> shared with
//     cp.async, one 4-byte element a lane and instruction, so every copy is
//     coalesced, needs no alignment beyond the element's and takes no
//     register; two rounds are in flight (a double buffer), the next one's
//     copies overlapping this one's arithmetic;
//   - the weights: the round's tau by a warp shuffle scan, the exclusive
//     transmittance from the scan and the rounds before; w goes out once and
//     into shared memory;
//   - the labelled count of a sample is the lane's loop over the ray's K
//     intervals, held in shared memory (broadcast reads);
//   - the per-interval sums: lane k runs interval k over the round's
//     samples in order; the learned logits: lane c (c, c + 32, ...) runs
//     class c over the round's rows, whose shared reads are consecutive
//     words; rgb, depth and acc: per-lane sums, a butterfly at the end;
//   - no (N, S, K) or (N, S, C) tensor and no int64 touches device memory;
//     no atomics, and every sum runs in a fixed order, so a call repeats bit
//     for bit.
//
// Shapes: any S >= 1 (runtime), K <= 32 intervals (a lane each), C <= 128
// classes (4 a lane). Template flags: learned logits, intervals, delta.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMaxIntervals = 32;
constexpr int kMaxClasses = 128;
constexpr int kClassSlots = kMaxClasses / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLastDelta = 1e10f;

// a round's stage, in floats: sigma, z (33: the next round's first too),
// delta, rgb, then the (32, C) logit rows
constexpr int kSig = 0, kZ = 32, kDl = 72, kRgb = 104, kLogit = 200;
// per warp after the two stages: w, w / max(cnt, 1), t_in, t_out, m, clamp(semantic)
constexpr int kTail = 6 * 32;

struct CompositeParams {
  const float* sigma;   // (n, s)
  const float* rgb;     // (n, s, 3)
  const float* logits;  // (n, s, c) or null
  const float* z;       // (n, s)
  const float* delta;   // (n, s) or null
  const float* t_in;    // (n, k)
  const float* t_out;   // (n, k)
  const int32_t* semantic;  // (n, k)
  const uint8_t* mask;      // (n, k) bool
  float* out_rgb;       // (n, 3)
  float* out_depth;     // (n,)
  float* out_acc;       // (n,)
  float* out_weights;   // (n, s)
  float* out_sem;       // (n, c)
  float* out_inst;      // (n, k)
  float* out_fixed;     // (n, c_fixed)
  int n, s, c, k, c_fixed, white_bkgd;
  int stage_floats, warp_floats;
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copies of round j of ray `ray` into `b` (the caller commits).
template <bool kLogits, bool kDelta>
__device__ __forceinline__ void prefetch(const CompositeParams& p, int ray, int j, float* b,
                                         int lane) {
  const int s0 = 32 * j;
  const int rows = min(32, p.s - s0);
  const size_t base = (size_t)ray * p.s + s0;
  if (lane < rows) copy4(b + kSig + lane, p.sigma + base + lane);
  const int zs = min(33, p.s - s0);
  for (int e = lane; e < zs; e += 32) copy4(b + kZ + e, p.z + base + e);
  if (kDelta && lane < rows) copy4(b + kDl + lane, p.delta + base + lane);
  for (int e = lane; e < 3 * rows; e += 32) copy4(b + kRgb + e, p.rgb + 3 * base + e);
  if (kLogits) {
    const float* src = p.logits + base * p.c;
    for (int e = lane; e < rows * p.c; e += 32) copy4(b + kLogit + e, src + e);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same sum (a + b == b + a)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kLogits, bool kIntervals, bool kDelta>
__global__ void __launch_bounds__(32 * kMaxWarps)
    volume_composite_kernel(const __grid_constant__ CompositeParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= p.n) return;  // the whole warp
  float* const ws = smem + (size_t)warp * p.warp_floats;
  float* const stage0 = ws;
  float* const stage1 = ws + p.stage_floats;
  float* const wbuf = ws + 2 * p.stage_floats;
  float* const wcbuf = wbuf + 32;
  float* const tin = wcbuf + 32;
  float* const tout = tin + 32;
  float* const mfix = tout + 32;
  int* const semc = reinterpret_cast<int*>(mfix + 32);
  const int S = p.s, K = p.k;
  const int rounds = (S + 31) / 32;

  prefetch<kLogits, kDelta>(p, ray, 0, stage0, lane);
  commit();
  if (rounds > 1) prefetch<kLogits, kDelta>(p, ray, 1, stage1, lane);
  commit();

  // the ray's intervals: lane k holds interval k; every lane reads them from shared memory
  float tin_k = 0.f, tout_k = 0.f;
  unsigned in_bits = 0u, lab_bits = 0u;
  if (kIntervals) {
    bool in_ok = false, lab_ok = false;
    if (lane < K) {
      const size_t e = (size_t)ray * K + lane;
      tin_k = p.t_in[e];
      tout_k = p.t_out[e];
      const int sem = p.semantic[e];
      in_ok = p.mask[e] != 0;
      lab_ok = in_ok && sem >= 0;
      tin[lane] = tin_k;
      tout[lane] = tout_k;
      semc[lane] = min(max(sem, 0), p.c_fixed - 1);
    }
    in_bits = __ballot_sync(kFull, in_ok);
    lab_bits = __ballot_sync(kFull, lab_ok);
  }
  const bool in_mine = (in_bits >> lane) & 1u, lab_mine = (lab_bits >> lane) & 1u;

  float carry = 0.f;  // sum of tau over the rounds before
  float acc = 0.f, dep = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f;
  float sacc[kClassSlots] = {0.f, 0.f, 0.f, 0.f};
  float inst = 0.f, mk = 0.f;

  for (int j = 0; j < rounds; ++j) {
    float* const b = (j & 1) ? stage1 : stage0;
    wait_all_but_one();
    __syncwarp();
    const int s0 = 32 * j;
    const int rows = min(32, S - s0);
    const bool valid = lane < rows;
    const int s = s0 + lane;

    float tau = 0.f, alpha = 0.f, zc = 0.f;
    if (valid) {
      const float a = b[kSig + lane];
      zc = b[kZ + lane];
      float delta;
      if (kDelta)
        delta = b[kDl + lane];
      else
        delta = (s + 1 < S) ? b[kZ + lane + 1] - zc : kLastDelta;
      const float density = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));
      tau = density * delta;
      alpha = 1.f - expf(-tau);
    }
    // inclusive scan of tau over the round's lanes, then the exclusive sum
    float incl = tau;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float total = __shfl_sync(kFull, incl, 31);

    float w = 0.f, wc = 0.f;
    if (valid) {
      w = alpha * expf(-(carry + excl));
      p.out_weights[(size_t)ray * S + s] = w;
      acc += w;
      dep += w * zc;
      r0 += w * b[kRgb + 3 * lane];
      r1 += w * b[kRgb + 3 * lane + 1];
      r2 += w * b[kRgb + 3 * lane + 2];
      if (kIntervals) {
        int cnt = 0;
        for (int k = 0; k < K; ++k)
          cnt += ((lab_bits >> k) & 1u) && zc >= tin[k] && zc <= tout[k];
        wc = w * (1.f / fmaxf((float)cnt, 1.f));
      }
    }
    carry = carry + total;
    wbuf[lane] = w;
    wcbuf[lane] = wc;
    __syncwarp();

    if (kIntervals && lane < K) {
      for (int t = 0; t < rows; ++t) {
        const float zt = b[kZ + t];
        const bool inside = in_mine && zt >= tin_k && zt <= tout_k;
        inst += wbuf[t] * (inside ? 1.f : 0.f);
        mk += wcbuf[t] * ((inside && lab_mine) ? 1.f : 0.f);
      }
    }
    if (kLogits) {
      const float* const rowv = b + kLogit;
#pragma unroll
      for (int i = 0; i < kClassSlots; ++i) {
        const int c = lane + 32 * i;
        if (c < p.c) {
          float v = sacc[i];
          for (int t = 0; t < rows; ++t) v += wbuf[t] * rowv[t * p.c + c];
          sacc[i] = v;
        }
      }
    }
    __syncwarp();  // the round's stage and w are read: the stage takes round j + 2
    if (j + 2 < rounds) prefetch<kLogits, kDelta>(p, ray, j + 2, b, lane);
    commit();
  }

  acc = warp_sum(acc);
  dep = warp_sum(dep);
  r0 = warp_sum(r0);
  r1 = warp_sum(r1);
  r2 = warp_sum(r2);
  if (lane == 0) {
    if (p.white_bkgd) {
      const float bg = 1.f - acc;
      r0 = r0 + bg;
      r1 = r1 + bg;
      r2 = r2 + bg;
    }
    p.out_rgb[(size_t)ray * 3] = r0;
    p.out_rgb[(size_t)ray * 3 + 1] = r1;
    p.out_rgb[(size_t)ray * 3 + 2] = r2;
    p.out_depth[ray] = dep;
    p.out_acc[ray] = acc;
  }
  if (kLogits) {
#pragma unroll
    for (int i = 0; i < kClassSlots; ++i) {
      const int c = lane + 32 * i;
      if (c < p.c) p.out_sem[(size_t)ray * p.c + c] = sacc[i];
    }
  }
  if (kIntervals) {
    if (lane < K) {
      p.out_inst[(size_t)ray * K + lane] = inst;
      mfix[lane] = mk;
    }
    __syncwarp();
    for (int c = lane; c < p.c_fixed; c += 32) {
      float f = 0.f;
      for (int k = 0; k < K; ++k)
        f += mfix[k] * ((((lab_bits >> k) & 1u) && semc[k] == c) ? 1.f : 0.f);
      p.out_fixed[(size_t)ray * p.c_fixed + c] = f;
    }
  }
}

template <bool kLogits, bool kIntervals, bool kDelta>
int launch(const CompositeParams& p, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)warps * p.warp_floats * sizeof(float);  // <= 48 KB
  const int blocks = (p.n + warps - 1) / warps;
  volume_composite_kernel<kLogits, kIntervals, kDelta><<<blocks, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). The Python wrapper
// (ops/composite_cuda.py) checks dtypes, shapes and contiguity and
// allocates the outputs. `logits` null: no learned logits (c is then 0);
// `t_in` null: no intervals (k, c_fixed 0; out_inst, out_fixed null);
// `delta` null: the deltas from z. Requires n >= 1, s >= 1, c <= 128,
// k <= 32 and 1 <= c_fixed <= 128 with intervals. Returns 0 when the
// launch was accepted, else the CUDA error code; nothing synchronises.
extern "C" int composite_launch(const void* sigma, const void* rgb, const void* logits,
                                const void* z, const void* delta, const void* t_in,
                                const void* t_out, const void* semantic, const void* mask,
                                int n, int s, int c, int k, int c_fixed, int white_bkgd,
                                void* out_rgb, void* out_depth, void* out_acc,
                                void* out_weights, void* out_sem, void* out_inst,
                                void* out_fixed, void* stream) {
  const bool has_logits = logits != nullptr, has_iv = t_in != nullptr;
  if (n < 1 || s < 1 || c < 0 || c > kMaxClasses || (has_logits != (c > 0)) || k < 0 ||
      k > kMaxIntervals || (has_iv && (k < 1 || c_fixed < 1 || c_fixed > kMaxClasses)) ||
      (!has_iv && (k != 0 || c_fixed != 0)))
    return (int)cudaErrorInvalidValue;
  CompositeParams p{};
  p.sigma = static_cast<const float*>(sigma);
  p.rgb = static_cast<const float*>(rgb);
  p.logits = static_cast<const float*>(logits);
  p.z = static_cast<const float*>(z);
  p.delta = static_cast<const float*>(delta);
  p.t_in = static_cast<const float*>(t_in);
  p.t_out = static_cast<const float*>(t_out);
  p.semantic = static_cast<const int32_t*>(semantic);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_depth = static_cast<float*>(out_depth);
  p.out_acc = static_cast<float*>(out_acc);
  p.out_weights = static_cast<float*>(out_weights);
  p.out_sem = static_cast<float*>(out_sem);
  p.out_inst = static_cast<float*>(out_inst);
  p.out_fixed = static_cast<float*>(out_fixed);
  p.n = n;
  p.s = s;
  p.c = c;
  p.k = k;
  p.c_fixed = c_fixed;
  p.white_bkgd = white_bkgd;
  p.stage_floats = kLogit + 32 * c;
  p.warp_floats = 2 * p.stage_floats + kTail;
  // as many warps a block as 48 KB of shared memory holds, up to four
  const int warps = max(1, min(kMaxWarps, (int)((48 * 1024) / (p.warp_floats * sizeof(float)))));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_delta = delta != nullptr;
#define PNT_V(L, I, D) \
  if (has_logits == L && has_iv == I && has_delta == D) return launch<L, I, D>(p, warps, st)
  PNT_V(true, true, false);
  PNT_V(true, true, true);
  PNT_V(true, false, false);
  PNT_V(true, false, true);
  PNT_V(false, true, false);
  PNT_V(false, true, true);
  PNT_V(false, false, false);
  PNT_V(false, false, true);
#undef PNT_V
  return (int)cudaErrorInvalidValue;
}
