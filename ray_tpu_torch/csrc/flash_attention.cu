// K1: flash-attention forward (causal or not) for Hopper, CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel,
// launched by _fwd_pallas (flash_attention.py:104). Same function: an
// online softmax with f32 m/l/acc over kv tiles, causal tiles wholly
// above the diagonal skipped, O written in the input dtype and the
// logsumexp in f32. Reference: _fwd_xla_with_lse (flash_attention.py:342),
// ported as ray_tpu_torch/ops/flash_attention.py::attention_with_lse_ref.
//
// Layout: q [B, H, T, D]; k, v [B, Hkv, T, D] (GQA is indexed, head h reads
// kv head h / (H / Hkv); nothing is repeated in memory); o [B, H, T, D] in
// q's dtype; lse [B, H, T] f32. D in {64, 128}; bf16 or f32 inputs; any T.
//
// What bounds it on an H100: at the prefill shapes (T = 64..2048, D = 128)
// attention is compute-bound (~2*T*D flops per key per query against
// 2 bytes per element), so the bound is the 989 TFLOP/s bf16 tensor-core
// rate. This first version does not reach it: it computes in f32 on the
// CUDA cores (67 TFLOP/s peak), with register tiles fed from shared memory.
// Design: one 256-thread block per (b*h, tile of 64 query rows); the block
// loops over 64-key tiles staged in shared memory as f32, each thread owns
// a 4x4 patch of the score tile and a 4 x D/16 patch of the output
// accumulator (rows ty + 16 i, so a row's 16 owners share a half-warp and
// reduce with shuffles). Moving the two products onto wgmma with TMA-fed
// bf16 tiles is the later work that approaches the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr float NEG = -1e30f;  // the reference's -inf surrogate (_NEG_INF)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    int H, int Hkv, int Tlen, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1]
  constexpr int CJ = D / 16;        // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + (size_t)bh * Tlen * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Tlen * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Tlen * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = q0 + r;
    Qs[r * (D + 1) + c] = row < Tlen ? to_f(qb[(size_t)row * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tlen) - 1;
  // causal block skip: tiles starting past this block's last row are
  // wholly above the diagonal
  const int n_kt = causal ? q_last / BK + 1 : (Tlen + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e - (e / D) * D;
      const int row = k0 + r;
      const bool ok = row < Tlen;
      Ks[r * (D + 1) + c] = ok ? to_f(kb[(size_t)row * D + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vb[(size_t)row * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        const bool ok = kcol < Tlen && (!causal || kcol <= qrow);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], va[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) va[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] += pa[i] * va[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tlen) continue;
    const float L = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store_f(acc[i][j] / L, orow + tx + 16 * j);
    if (tx == 0) lse[(size_t)bh * Tlen + row] = m[i] + logf(L);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// head_dim this kernel has no instance for.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int Hkv, int Tlen, int D, int causal, float scale,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st)
                   : launch<float, 128>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st)
                   : launch<float, 64>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}
