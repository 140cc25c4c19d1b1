// Hopper (sm_90a) building blocks written as inline PTX: mbarriers, TMA
// (cp.async.bulk.tensor) loads and stores, the async-proxy fence, wgmma
// shared-memory descriptors and the m64nNk16 bf16 products, register
// reallocation (setmaxnreg), named barriers, stmatrix; and on the host,
// the encoding of a 3-D bf16 TMA descriptor with a 128-byte swizzle, and
// the per-device set-up the launchers share.
//
// Every TMA box here is 64 bf16 columns (128 bytes) by 64 rows, swizzled
// with the 128-byte pattern: within each 1024-byte block of 8 rows, the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). A wgmma descriptor
// of the same layout ("128B swizzle") reads it directly, K-major (the
// reduction dimension contiguous) or MN-major (transposed).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
// Each takes the barrier's shared-window address (a 32-bit register), or a
// pointer to it.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  mbar_init(smem_u32(bar), count);
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives once and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Returns once the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as completed: parity 1 passes at once).
// A wait of more than 2^35 cycles (~17 s) traps: a pipeline that cannot
// finish ends its launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// ------------------------------------------------------------------- TMA

// One box of `map` at element coordinates (c0 innermost, c1, c2) into
// shared memory; completes on `bar` (bytes of the whole box, out-of-bounds
// elements zero-filled).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  tma_load(smem_u32(dst), map, smem_u32(bar), c0, c1, c2);
}
// One box from shared memory to `map` at (c0, c1, c2); elements out of
// bounds are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  tma_store(map, smem_u32(src), c0, c1, c2);
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Every committed store has read its shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Every committed store is complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- warp specialisation

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// Barrier `id` (1-15) over `threads` threads (whole warps).
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8 x 8 b16 matrices between shared memory and registers: lane l
// gives the shared address of row l % 8 of matrix l / 8 (16 bytes), and
// r[i] is the pair (row l / 4, columns 2 (l % 4), + 1) of matrix i.
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void stsm_x4_at(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle. K-major: rows of 128
// bytes, `sbo` = bytes between 8-row groups (1024), `lbo` unused (16).
// MN-major: 64-element blocks of the MN dimension `lbo` bytes apart, 8-row
// groups of the K dimension `sbo` bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return desc_sw128(smem_u32(p), lbo, sbo);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = A (64 x 16) B (16 x N) + (acc ? d : 0), bf16 operands in
// shared memory (descriptors a, b); TA / TB = 1: the operand is MN-major.
// Accumulator layout: thread t of the warpgroup holds d[4j + 2h + e] = row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e.
#define PNT_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define PNT_D32(i) PNT_D8(i), PNT_D8(i + 8), PNT_D8(i + 16), PNT_D8(i + 24)
#define PNT_R32                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PNT_R64                                                                            \
  PNT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PNT_R96                                                                             \
  PNT_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
          "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define PNT_R128                                                                           \
  PNT_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
          "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
          "%123, %124, %125, %126, %127"

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PNT_R32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : PNT_D32(0)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PNT_R64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : PNT_D32(0), PNT_D32(32)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[96], uint64_t a, uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" PNT_R96
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : PNT_D32(0), PNT_D32(32), PNT_D32(64)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" PNT_R128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : PNT_D32(0), PNT_D32(32), PNT_D32(64), PNT_D32(96)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
#undef PNT_D8
#undef PNT_D32
#undef PNT_R32
#undef PNT_R64
#undef PNT_R96
#undef PNT_R128

// In a [col / 64][rows][64] bf16 buffer of 64 x 64 TMA boxes (1024-byte
// aligned), the 16-byte chunk c (< 8) of row r sits at byte
// sw128_row(r) ^ (c * 16) of its 64-column block: one XOR with a constant
// per access.
__device__ __forceinline__ uint32_t sw128_row(int r) {
  return (uint32_t)(r * 128 + ((r & 7) << 4));
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Returned when a descriptor cannot be encoded (not a CUDA runtime error
// code).
constexpr int kTmaEncodeFailed = 9001;

// map <- the bf16 tensor (depth, rows, cols), row-major, rows `ld` columns
// apart (0: contiguous, ld = cols), in boxes of 64 columns x 64 rows x 1,
// 128-byte swizzle, zero fill out of bounds (a store writes nothing there:
// with ld > cols, the map covers the first cols columns of a wider tensor).
// Returns 0 or kTmaEncodeFailed.
inline int make_tma_map(CUtensorMap* map, const void* ptr, int cols, int rows, int depth,
                        int ld = 0) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return kTmaEncodeFailed;
  const cuuint64_t row = (cuuint64_t)(ld ? ld : cols) * 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaEncodeFailed;
}

// The host launchers run on every call of a kernel; what they ask of the
// runtime that cannot change between calls is asked once per device (a
// device numbered 64 or above asks every time).
constexpr int kMaxDevices = 64;

// SMs of the current device, or 0 when they cannot be read.
inline int sm_count() {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && (sms = known[dev].load(std::memory_order_relaxed)) > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// Raises `kernel`'s dynamic shared-memory ceiling to `bytes` on the current
// device, once: `done` is the caller's static for that kernel, a bit per
// device already raised.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace
