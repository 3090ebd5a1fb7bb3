// K5: fused RMSNorm for Hopper, CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/layers.py::rms_norm_pallas (inner
// `kernel`, layers.py:33, launched by pl.pallas_call at :38). Same
// function: per row of x [rows, d], out = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 and cast back to x's dtype. Plain version:
// ray_tpu_torch/ops/layers.py::rms_norm.
//
// What bounds it on an H100: bytes. It does ~4 flops per element against
// 2-4 bytes read and written, far below the ~295 flops/byte the card
// needs before arithmetic matters, so the bound is (read x + read w +
// write out) / 3.35 TB/s. At a few rows (a decode step's [8, 4096]) that
// bound is tens of nanoseconds and the launch is the cost: no launch may
// pay a cudaFuncSetAttribute.
//
// Design: the caller picks one of three paths (ops/layers.py::rms_norm_plan,
// passed in as `path` and `nv`):
// - warp (path 2): a warp per row, 4 rows per 128-thread block, for rows
//   of at most 16 KB whose width is a whole number of 16-byte vectors, on
//   16-byte aligned pointers. Each lane loads its nv vectors of the row
//   (vector i = lane + 32 k) with 16-byte loads, all at once, and keeps
//   them in registers; the sum of squares is a shuffle reduction; the lane
//   then reads w (L1/L2 hits after the first row) and writes x * r * w with
//   16-byte stores. No shared memory, no barrier. Small blocks let an SM
//   hold as many warps as the registers allow (a 256-thread block would
//   cap it at 16 warps for 86 registers a thread) and shorten the last wave.
// - block (paths 1 and 0): one 256-thread block per row for wider rows (up
//   to the wrapper's 200 KB), staged in dynamic shared memory so that x is
//   read once; 16-byte vectors (path 1) or elements (path 0: a width that
//   is not a whole number of vectors, or an unaligned pointer). The shared
//   memory limit is raised once per kernel and device (set_smem_once).
// Both keep IEEE sqrtf and division (no fast math), as the plain version's
// rsqrt of the mean, so the kernel stays within one bf16 ulp and 1e-5 f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;                   // block path
constexpr int NT_WARP = 128;              // warp path: 4 rows a block, so more blocks fit an SM's registers
constexpr int ROWS_PER_BLOCK = NT_WARP / 32;
constexpr int MAX_ROW_BYTES = 200 * 1024;  // block path: the row in shared memory (the wrapper's limit)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// V consecutive elements of T at p (aligned to their size, 8 or 16 bytes
// or a multiple of 16) into f32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
  } else {
    static_assert(BYTES % 16 == 0, "vector of 8 bytes or of 16-byte words");
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) f[k * PER + j] = to_f(e[j]);
    }
  }
}

// x * r * w for the V elements of the 16-byte word u, with w's V elements at wp.
template <typename TX, typename TW, int V>
__device__ __forceinline__ uint4 scale_vec(const uint4& u, float r, const TW* wp) {
  float wf[V];
  load_vec<TW, V>(wp, wf);
  const TX* e = reinterpret_cast<const TX*>(&u);
  uint4 o;
  TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
  for (int j = 0; j < V; ++j) from_f(to_f(e[j]) * r * wf[j], &oe[j]);
  return o;
}

// Warp path: NV = 16-byte vectors a lane holds, at most (a power of two,
// with nv = d / V <= 32 * NV).
template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(NT_WARP) rms_norm_warp_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = 16 / (int)sizeof(TX);
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= (size_t)rows) return;
  const int nv = d / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 buf[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) buf[k] = __ldcs(xr + i);  // read once: stream it past L1
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < nv) {
      const TX* e = reinterpret_cast<const TX*>(&buf[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  }
  ss = warp_sum(ss);
  const float r = 1.f / sqrtf(ss / (float)d + eps);
  uint4* outr = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) __stcs(outr + i, scale_vec<TX, TW, V>(buf[k], r, w + i * V));
  }
}

// Block path: one block per row, the row staged in shared memory.
template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(NT) rms_norm_block_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* row_s = reinterpret_cast<TX*>(smem_raw);  // the row, in x's dtype
  __shared__ float warp_sums[NT / 32];
  constexpr int V = 16 / (int)sizeof(TX);  // elements per 16-byte vector

  const size_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* outr = out + row * d;
  const int tid = threadIdx.x;

  float ss = 0.f;
  if (VEC) {
    const int nv = d / V;
    for (int i = tid; i < nv; i += NT) {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      reinterpret_cast<uint4*>(row_s)[i] = u;
      const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = tid; i < d; i += NT) {
      const TX e = xr[i];
      row_s[i] = e;
      const float f = to_f(e);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  if (tid < 32) {
    float v = tid < NT / 32 ? warp_sums[tid] : 0.f;
    v = warp_sum(v);
    if (tid == 0) warp_sums[0] = v;
  }
  __syncthreads();
  // IEEE sqrt and divide (no fast-math), as the plain version's rsqrt of the mean
  const float r = 1.f / sqrtf(warp_sums[0] / (float)d + eps);

  if (VEC) {
    const int nv = d / V;
    for (int i = tid; i < nv; i += NT)
      reinterpret_cast<uint4*>(outr)[i] = scale_vec<TX, TW, V>(reinterpret_cast<const uint4*>(row_s)[i], r, w + i * V);
  } else {
    for (int i = tid; i < d; i += NT) from_f(to_f(row_s[i]) * r * to_f(w[i]), &outr[i]);
  }
}

template <typename TX, typename TW, int NV>
int launch_warp(const TX* x, const TW* w, TX* out, int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  rms_norm_warp_kernel<TX, TW, NV><<<blocks, NT_WARP, 0, stream>>>(x, w, out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, bool VEC>
int launch_block(const TX* x, const TW* w, TX* out, int rows, int d, float eps, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err = hopper::set_smem_once(rms_norm_block_kernel<TX, TW, VEC>, MAX_ROW_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int smem = (d * (int)sizeof(TX) + 15) / 16 * 16;
  rms_norm_block_kernel<TX, TW, VEC><<<rows, NT, smem, stream>>>(x, w, out, d, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch(const void* xv, const void* wv, void* outv, int rows, int d, float eps, int path, int nv,
           cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(TX);
  const TX* x = static_cast<const TX*>(xv);
  const TW* w = static_cast<const TW*>(wv);
  TX* out = static_cast<TX*>(outv);
  if (d < 1 || (size_t)d * sizeof(TX) > (size_t)MAX_ROW_BYTES) return -1;
  if (path == 0) return launch_block<TX, TW, false>(x, w, out, rows, d, eps, stream);
  const bool aligned = ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (!aligned || d % V != 0) return -1;  // the vector paths need whole, aligned 16-byte vectors
  if (path == 1) return launch_block<TX, TW, true>(x, w, out, rows, d, eps, stream);
  if (path != 2 || d / V > 32 * nv) return -1;
  switch (nv) {
    case 1: return launch_warp<TX, TW, 1>(x, w, out, rows, d, eps, stream);
    case 2: return launch_warp<TX, TW, 2>(x, w, out, rows, d, eps, stream);
    case 4: return launch_warp<TX, TW, 4>(x, w, out, rows, d, eps, stream);
    case 8: return launch_warp<TX, TW, 8>(x, w, out, rows, d, eps, stream);
    case 16: return launch_warp<TX, TW, 16>(x, w, out, rows, d, eps, stream);
    case 32: return launch_warp<TX, TW, 32>(x, w, out, rows, d, eps, stream);
    default: return -1;
  }
}

}  // namespace

// x, out: [rows, d] contiguous, bf16 (x_bf16 = 1) or f32; w: [d], bf16
// (w_bf16 = 1) or f32. path: 2 = a warp per row with nv 16-byte vectors a
// lane (a power of two, 1..32), 1 = a block per row in 16-byte vectors,
// 0 = a block per row element by element. Returns cudaGetLastError() after
// the launch, or -1 for a path these inputs do not allow.
extern "C" int rt_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                           int x_bf16, int w_bf16, int path, int nv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, path, nv, st)
                  : launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, path, nv, st);
  }
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, path, nv, st)
                : launch<float, float>(x, w, out, rows, d, eps, path, nv, st);
}
