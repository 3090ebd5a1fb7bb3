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
// write out) / 3.35 TB/s.
// Design: one 256-thread block per row. The block reads the row from
// device memory once, with 16-byte vector loads when d and the pointers
// allow it (scalar loads otherwise), keeps it in shared memory and sums
// x^2 in f32 on the way in (warp shuffles, then one warp over the warp
// sums). It then writes x * r * w from shared memory with 16-byte stores.
// So x crosses device memory once each way. A block per row keeps the
// kernel simple; rows of a few KB leave the card's memory system
// under-used at small row counts, which a later version can fix by
// giving a warp a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

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

template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(NT) rms_norm_kernel(
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
    for (int i = tid; i < nv; i += NT) {
      float xf[V], wf[V];
      load_vec<TX, V>(row_s + i * V, xf);
      load_vec<TW, V>(w + i * V, wf);
      uint4 u;
      TX* o = reinterpret_cast<TX*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) from_f(xf[j] * r * wf[j], &o[j]);
      reinterpret_cast<uint4*>(outr)[i] = u;
    }
  } else {
    for (int i = tid; i < d; i += NT) from_f(to_f(row_s[i]) * r * to_f(w[i]), &outr[i]);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(TX);
  const bool vec = d % V == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   ((uintptr_t)w % 16 == 0);
  const int smem = (d * (int)sizeof(TX) + 15) / 16 * 16;
  auto kernel = vec ? rms_norm_kernel<TX, TW, true> : rms_norm_kernel<TX, TW, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, NT, smem, stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] contiguous, bf16 (x_bf16 = 1) or f32; w: [d], bf16
// (w_bf16 = 1) or f32. Returns cudaGetLastError() after the launch.
extern "C" int rt_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                           int x_bf16, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, st)
                  : launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, st);
  }
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, st)
                : launch<float, float>(x, w, out, rows, d, eps, st);
}
