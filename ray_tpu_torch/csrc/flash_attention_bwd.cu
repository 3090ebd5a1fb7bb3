// K2 and K3: flash-attention backward for Hopper, CUDA C++.
//
// Replace the TPU kernels ray_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (K2, flash_attention.py:154) and ::_bwd_dkv_kernel (K3, :192), both
// launched by _bwd_pallas_with_delta (:240, pl.pallas_call at :261 and
// :278). Same functions, from the forward's saved f32 logsumexp and a
// caller-supplied delta = rowsum(dO * O) in f32:
//   S = Q K^T * scale (causal mask), P = exp(S - lse), dP = dO V^T,
//   dS = P * (dP - delta),
//   K2: dQ = dS K * scale;  K3: dV = P^T dO, dK = dS^T Q * scale.
// Plain version: ray_tpu_torch/ops/flash_attention.py::attention_bwd_ref
// (the port of _bwd_xla, :367).
//
// Layout: q, dO, dq [B, H, T, D]; k, v, dk, dv [B, Hkv, T, D] (GQA: q head
// h reads kv head h / (H / Hkv), nothing is repeated in memory); lse,
// delta [B, H, T] f32. D in {64, 128}; bf16 or f32; any T; causal or not.
//
// One departure from ray_tpu's Pallas path: there K3 writes dk/dv per
// q head in the input dtype and _flash_bwd (:359-363) sums the rep heads
// afterwards, in bf16 for bf16 inputs. Here a K3 block owns one kv head
// and sums its rep q heads itself in f32 registers before the one cast,
// as _bwd_xla does: no [B, H, T, D] dk/dv intermediate and no atomics.
//
// What bounds them on an H100: operations. Per causal (query, key) pair
// K2 does 6*D flops and K3 8*D against O(T*D) bytes, so at the training
// shapes (T = 2048..8192, D = 128) the bound is the 989 TFLOP/s bf16
// tensor-core rate. This first version does not approach it: like K1
// (csrc/flash_attention.cu) it computes in f32 on the CUDA cores
// (67 TFLOP/s peak) from shared-memory tiles, 256 threads as 16 x 16,
// each owning a 4 x 4 patch of the 64 x 64 score tile and 4 rows x D/16
// columns of its f32 accumulators. Moving the four products onto wgmma
// with TMA-fed bf16 tiles is the later work that approaches the bound.
//
// K2 design: one block per (b, q head, 64-row q tile). Q and dO stay in
// shared memory; the block walks the 64-key tiles up to the diagonal
// (causal block skip), recomputes S and dP in one pass over D, writes
// dS to shared memory and accumulates dQ += dS K. Blocks are issued
// heaviest (last q tile) first.
// K3 design: one block per (b, kv head, 64-key tile). K and V stay in
// shared memory; the block walks the rep q heads of its kv head and, for
// each, the q tiles from the diagonal onward, writing P^T and dS^T tiles
// to shared memory and accumulating dV += P^T dO and dK += dS^T Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile (BQ == BK: the diagonal tile of a key tile is the q tile of the same index)
constexpr int NT = 256;  // threads per block: 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// rows [r0, r0 + 64) of a [Tlen, D] matrix into a [64][D + 1] f32 tile, zeros past Tlen
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int Tlen, int tid) {
  for (int e = tid; e < 64 * D; e += NT) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < Tlen ? to_f(src[(size_t)row * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int H, int Hkv, int Tlen, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);  // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);  // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);   // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);  // [BQ][BK + 1]
  constexpr int CJ = D / 16;       // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first

  const T* kb = k + (size_t)(b * Hkv + hk) * Tlen * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Tlen * D;
  load_tile<T, D>(Qs, q + (size_t)bh * Tlen * D, q0, Tlen, tid);
  load_tile<T, D>(dOs, dout + (size_t)bh * Tlen * D, q0, Tlen, tid);

  float lse_r[4], delta_r[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Tlen ? lse[(size_t)bh * Tlen + row] : 0.f;
    delta_r[i] = row < Tlen ? delta[(size_t)bh * Tlen + row] : 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tlen) - 1;
  const int n_kt = causal ? q_last / BK + 1 : (Tlen + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks / Vs / dSs are consumed
    load_tile<T, D>(Ks, kb, k0, Tlen, tid);
    load_tile<T, D>(Vs, vb, k0, Tlen, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        da[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        va[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i] * ka[j];
          dp[i][j] += da[i] * va[j];
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        const bool ok = qrow < Tlen && kcol < Tlen && (!causal || kcol <= qrow);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sa[4], ka[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) ka[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] += sa[i] * ka[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tlen) continue;
    T* out = dq + ((size_t)bh * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store_f(acc[i][j] * scale, out + tx + 16 * j);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Hkv, int Tlen, int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);    // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);   // [BQ][D + 1]
  float* Ps = dOs + BQ * (D + 1);   // [BK][BQ + 1]: P^T
  float* dSs = Ps + BK * (BQ + 1);  // [BK][BQ + 1]: dS^T
  float* lse_s = dSs + BK * (BQ + 1);  // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]
  constexpr int CJ = D / 16;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q column of the score tile; output column
  const int ty = tid >> 4;  // key row
  const int bg = blockIdx.y;
  const int b = bg / Hkv;
  const int g = bg - b * Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * BK;

  load_tile<T, D>(Ks, k + (size_t)bg * Tlen * D, k0, Tlen, tid);
  load_tile<T, D>(Vs, v + (size_t)bg * Tlen * D, k0, Tlen, tid);

  float acc_dk[4][CJ], acc_dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // causal block skip: q tiles that end before this key tile starts see none of it
  const int qt_first = causal ? k0 / BQ : 0;
  const int n_qt = (Tlen + BQ - 1) / BQ;

  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const T* qb = q + (size_t)bh * Tlen * D;
    const T* dob = dout + (size_t)bh * Tlen * D;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
      load_tile<T, D>(Qs, qb, q0, Tlen, tid);
      load_tile<T, D>(dOs, dob, q0, Tlen, tid);
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < Tlen ? lse[(size_t)bh * Tlen + row] : 0.f;
        delta_s[tid] = row < Tlen ? delta[(size_t)bh * Tlen + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = Ks[(ty + 16 * i) * (D + 1) + d];
          va[i] = Vs[(ty + 16 * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = Qs[(tx + 16 * j) * (D + 1) + d];
          da[j] = dOs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += ka[i] * qa[j];
            dp[i][j] += va[i] * da[j];
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qrow = q0 + qc;
          const bool ok = qrow < Tlen && krow < Tlen && (!causal || krow <= qrow);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qc]) : 0.f;
          Ps[(ty + 16 * i) * (BQ + 1) + qc] = p;
          dSs[(ty + 16 * i) * (BQ + 1) + qc] = p * (dp[i][j] - delta_s[qc]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pa[4], sa[4], oa[CJ], qa[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[(ty + 16 * i) * (BQ + 1) + c];
          sa[i] = dSs[(ty + 16 * i) * (BQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          oa[j] = dOs[c * (D + 1) + tx + 16 * j];
          qa[j] = Qs[c * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            acc_dv[i][j] += pa[i] * oa[j];
            acc_dk[i][j] += sa[i] * qa[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Tlen) continue;
    T* dkr = dk + ((size_t)bg * Tlen + row) * D;
    T* dvr = dv + ((size_t)bg * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      store_f(acc_dk[i][j] * scale, dkr + tx + 16 * j);
      store_f(acc_dv[i][j], dvr + tx + 16 * j);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              void* dq, int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BK - 1) / BK, B * Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or -1
// for a head_dim with no instance.
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H, int Hkv, int Tlen, int D, int causal,
                               float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int H, int Hkv, int Tlen, int D,
                                int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16
        ? launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st)
        : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16
        ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st)
        : launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}
