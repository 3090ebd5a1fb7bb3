// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// shared-memory mbarriers, TMA tile loads through a tensor map, small
// asynchronous copies that arrive on an mbarrier, and the warpgroup matrix
// products (wgmma) with their shared-memory descriptors.
//
// Conventions (K1, K2 and K3 all use these and no other):
//
// - A bf16 tile is staged by TMA as boxes of [rows][64] with the 128-byte
//   swizzle: row r of a box sits at r * 128 bytes, and its 16-byte chunk c
//   at chunk c ^ (r % 8). A box is 1024-byte aligned. A tile wider than 64
//   columns is several boxes, one after another.
// - A K-major operand (its reduction dimension contiguous, as Q and K of
//   S = Q K^T are) reads k-step kk (16 columns) from the box kk / 4 at a
//   start address advanced by (kk % 4) * 32 bytes; SBO = 1024 bytes (the
//   next 8 rows), LBO unused. desc_sw128(addr, 16, 1024).
// - An MN-major operand (its output dimension contiguous, as V of O = P V
//   is: V is [keys][d]) reads k-step kk (16 rows) at a start address
//   advanced by kk * 16 * 128 bytes; SBO = 1024 bytes (the next 8 rows of
//   the reduction dimension), LBO = the bytes of one box (the next 64
//   output columns: 16 KB for K1's 128-row boxes, 8 KB for the 64-row boxes
//   K2 and K3 stream). Pass the transpose bit 1 for it.
// - The f32 accumulator of m64nNk16 in a warpgroup: warp w, lane l holds
//   rows 16 w + l / 4 and that + 8; for each 8-column group g, d[4 g + 0, 1]
//   are row 16 w + l / 4, columns 8 g + 2 (l % 4) + {0, 1}, and d[4 g + 2, 3]
//   the same columns of the row 8 below. A register A operand of k16 takes
//   the same rows: chunk c of 16 columns is the bf16 pairs of
//   d[8 c + 0..7], in order.
//
// Host side: tensor maps are encoded through cudaGetDriverEntryPoint, so a
// library that includes this header links cudart only.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); call
// after the inits and before the block's barrier that publishes them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed. A wait that has
// not completed after 10 s (a fault in a pipeline's barriers) traps, which
// fails the launch, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (globaltimer_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA: the box at coordinates (c0 innermost, c1, c2) into shared memory at
// dst, completing `bar`'s transaction count. Out-of-range elements are
// filled with zeros (and still counted).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 4-byte asynchronous copy from global to shared memory; zeros are written when
// !valid (src is then not read, but must still be an address inside its allocation).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// This thread's arrival on `bar`, made when all its cp_async copies so far have landed.
// It is one of the arrivals the barrier was initialised to expect.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses with the async
// proxy's (TMA, wgmma) before a barrier that hands the memory over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Synchronises the `threads` threads of named barrier `id` (1..15; 0 is
// __syncthreads's).
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(smem) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // layout type 1: 128-byte swizzle
  return d;
}

// The descriptor of the same operand `bytes` further on (a multiple of 16, inside the
// block's shared memory, so the address field does not carry into the next one).
__device__ __forceinline__ uint64_t desc_advance(uint64_t d, int bytes) { return d + static_cast<uint64_t>(bytes >> 4); }

// Makes the compiler take d as changed here: inside a loop, what derives from a
// loop-invariant descriptor is then recomputed (one add) and not kept in registers
// across the loop, two for every k-step.
__device__ __forceinline__ void desc_pin(uint64_t& d) { asm volatile("" : "+l"(d)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// not move their other uses across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F16(d, i) HOPPER_F4(d, i), HOPPER_F4(d, i + 4), HOPPER_F4(d, i + 8), HOPPER_F4(d, i + 12)
#define HOPPER_F32(d) HOPPER_F16(d, 0), HOPPER_F16(d, 16)
#define HOPPER_F64(d) HOPPER_F16(d, 0), HOPPER_F16(d, 16), HOPPER_F16(d, 32), HOPPER_F16(d, 48)
#define HOPPER_D32                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D64                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "  \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"

// d (+)= A B, m64 x N x k16, bf16 in, f32 accumulate; A and B both from
// shared memory. TA, TB: 0 K-major, 1 MN-major. accumulate = 0 overwrites d.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64 ", %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : HOPPER_F64(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB)
        : "memory");
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32 ", %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : HOPPER_F32(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB)
        : "memory");
  }
}

// d (+)= A B, m64 x N x k16, with A from registers (four bf16 pairs in the
// accumulator's row layout, see above) and B from shared memory.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : HOPPER_F64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate), "n"(TB)
        : "memory");
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : HOPPER_F32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate), "n"(TB)
        : "memory");
  }
}

#undef HOPPER_F4
#undef HOPPER_F16
#undef HOPPER_F32
#undef HOPPER_F64
#undef HOPPER_D32
#undef HOPPER_D64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// -------------------------------------------------------------------- host

// A 3-D bf16 tensor map over [planes][rows][cols] (contiguous), boxes of
// [1][box_rows][64] with the 128-byte swizzle; out-of-range rows read as
// zeros. Returns false if the driver entry point is missing or the encoding
// is refused (the base must be 16-byte aligned, cols * 2 a multiple of 16).
inline bool tma_map_bf16_3d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint64_t planes,
                            uint32_t box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device: `done` is the kernel's own bit mask of devices already set.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace hopper
