// K4: paged-attention softmax partials for Hopper, CUDA C++.
//
// Replaces the TPU kernel ray_tpu/llm/pallas/paged_attn.py::_partials_kernel,
// launched by paged_attn_partials (paged_attn.py:134). Same function: for
// each lane b, an online softmax of the pre-scaled f32 queries over the
// lane's pool pages tables[b, j], at pool positions < bound[b] only, int8
// pools dequantized in registers with the [P, kv, page] f32 scale planes,
// returning the UNNORMALISED partials (m, l, acc) in f32 for the caller's
// _combine with the current token (ray_tpu_torch/llm/paged_kv.py).
// Reference: the XLA page scan paged_kv.py:218-240, ported as
// ray_tpu_torch/llm/cuda/paged_attn.py::paged_attn_partials_ref.
//
// Layout: qf [B, nkv, rep, T, hd] f32 (R = rep * T rows per kv head, at most
// 64); pool_k / pool_v [P, page, nkv, hd] f32, bf16 or int8; tables
// [B, max_pg] i32; bound [B] i32; k_scale / v_scale [P, nkv, page] f32
// (int8 only); m, l [B, nkv, rep, T] and acc [B, nkv, rep, T, hd] f32.
//
// Aliasing contract: no position >= bound[b] is ever read. The position the
// decode step writes this step is >= bound, so it reaches attention only
// through the caller's in-register self fold.
//
// Known difference at bound == 0: the TPU kernel and the XLA scan visit
// every table page even there, every score is -1e30, and they end with
// m = -1e30, l = max_pg * page and acc = the sum of those pages' V. This
// kernel visits no page at or past the bound and returns m = -1e30, l = 0,
// acc = 0. m agrees everywhere; l and acc agree wherever bound > 0; the
// caller's combined output agrees at every bound, because _combine scales
// the bound-0 partial by exp(-1e30 - s_self) = 0.
//
// What bounds it on an H100: decode reads every cached K/V byte once for a
// few flops per byte (rep * T queries per kv head), so it is bound by device
// memory bandwidth (3.35 TB/s). Design: one 256-thread block per (lane b,
// kv head g) holds that head's R query rows in shared memory, walks the
// lane's positions in chunks of 64 (reading tables[b, pos / page] itself:
// Hopper has no scalar prefetch), streams each chunk's K and V rows with
// 16-byte vector loads, dequantizes int8 in registers, and folds the chunk
// into f32 m/l/acc. Known limit: decode at batch 8 with 8 kv heads launches
// only 64 blocks for 132 SMs, so at most half the card pulls bytes;
// splitting each lane's pages over several blocks with a combine pass
// (flash-decoding) is a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block
constexpr int CH = 64;     // positions per shared-memory chunk (two per lane in a row's warp)
constexpr int RMAX = 64;   // most query rows (rep * T) per kv head
constexpr float NEG = -1e30f;  // paged_kv._NEG

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(NT) paged_partials_kernel(
    const float* __restrict__ qf, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const int* __restrict__ tables, const int* __restrict__ bound,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
    int nkv, int R, int page, int max_pg) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [R][HD]
  float* Ks = Qs + R * HD;           // [CH][HD + 1]
  float* Vs = Ks + CH * (HD + 1);    // [CH][HD]
  float* Ps = Vs + CH * HD;          // [R][CH + 1]
  float* Ms = Ps + R * (CH + 1);     // [R] running max
  float* Ls = Ms + R;                // [R] running sum
  float* As = Ls + R;                // [R] this chunk's rescale factor
  constexpr int APT = RMAX * HD / NT;  // accumulator entries per thread, at most

  const int blk = blockIdx.x;        // = b * nkv + g
  const int b = blk / nkv;
  const int g = blk - b * nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qb = qf + (size_t)blk * R * HD;
  for (int e = tid; e < R * HD; e += NT) Qs[e] = qb[e];
  for (int r = tid; r < R; r += NT) {
    Ms[r] = NEG;
    Ls[r] = 0.f;
  }
  float acc[APT];
#pragma unroll
  for (int n = 0; n < APT; ++n) acc[n] = 0.f;

  const int nb = min(bound[b], max_pg * page);
  const int* trow = tables + (size_t)b * max_pg;

  for (int c0 = 0; c0 < nb; c0 += CH) {
    __syncthreads();  // Qs/Ms/Ls initialised; the previous chunk is consumed
    for (int e = tid * 8; e < CH * HD; e += NT * 8) {
      const int r = e / HD, col = e - (e / HD) * HD;
      const int pos = c0 + r;
      float kk[8], vv[8];
      if (pos < nb) {
        const int pid = trow[pos / page];
        const int off = pos - (pos / page) * page;
        const size_t base = (((size_t)pid * page + off) * nkv + g) * HD + col;
        load8(pool_k + base, kk);
        load8(pool_v + base, vv);
        if (QUANT) {
          const size_t si = ((size_t)pid * nkv + g) * page + off;
          const float sk = k_scale[si], sv = v_scale[si];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            kk[i] *= sk;
            vv[i] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kk[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ks[r * (HD + 1) + col + i] = kk[i];
        Vs[r * HD + col + i] = vv[i];
      }
    }
    __syncthreads();

    for (int e = tid; e < R * CH; e += NT) {
      const int r = e / CH, c = e - (e / CH) * CH;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s += Qs[r * HD + d] * Ks[c * (HD + 1) + d];
      Ps[r * (CH + 1) + c] = (c0 + c < nb) ? s : NEG;  // strictly pre-existing positions only
    }
    __syncthreads();

    for (int r = warp; r < R; r += NT / 32) {
      float* prow = Ps + r * (CH + 1);
      const float x0 = prow[lane], x1 = prow[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sm = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[r] = Ls[r] * alpha + sm;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < APT; ++n) {
      const int e = tid + n * NT;
      if (e < R * HD) {
        const int r = e / HD, col = e - (e / HD) * HD;
        const float* prow = Ps + r * (CH + 1);
        float a = acc[n] * As[r];
#pragma unroll 8
        for (int c = 0; c < CH; ++c) a += prow[c] * Vs[c * HD + col];
        acc[n] = a;
      }
    }
  }

  float* ab = acc_out + (size_t)blk * R * HD;
#pragma unroll
  for (int n = 0; n < APT; ++n) {
    const int e = tid + n * NT;
    if (e < R * HD) ab[e] = acc[n];
  }
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    m_out[(size_t)blk * R + r] = Ms[r];
    l_out[(size_t)blk * R + r] = Ls[r];
  }
}

template <typename T, int HD, bool QUANT>
int launch(const void* qf, const void* pool_k, const void* pool_v, const void* tables, const void* bound,
           const void* k_scale, const void* v_scale, void* m, void* l, void* acc,
           int B, int nkv, int R, int page, int max_pg, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (R * HD + CH * (HD + 1) + CH * HD + R * (CH + 1) + 3 * R);
  cudaError_t err = cudaFuncSetAttribute(paged_partials_kernel<T, HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_partials_kernel<T, HD, QUANT><<<B * nkv, NT, smem, stream>>>(
      static_cast<const float*>(qf), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(bound),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc), nkv, R, page, max_pg);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(int pool_dtype, const void* qf, const void* pk, const void* pv, const void* tables,
             const void* bound, const void* ks, const void* vs, void* m, void* l, void* acc,
             int B, int nkv, int R, int page, int max_pg, cudaStream_t st) {
  switch (pool_dtype) {
    case 0: return launch<float, HD, false>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, B, nkv, R, page, max_pg, st);
    case 1: return launch<__nv_bfloat16, HD, false>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, B, nkv, R, page, max_pg, st);
    case 2: return launch<int8_t, HD, true>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, B, nkv, R, page, max_pg, st);
    default: return -1;
  }
}

}  // namespace

// pool_dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape or type this kernel has no instance for.
extern "C" int rt_paged_partials(const void* qf, const void* pool_k, const void* pool_v,
                                 const void* tables, const void* bound,
                                 const void* k_scale, const void* v_scale,
                                 void* m, void* l, void* acc,
                                 int B, int nkv, int R, int hd, int page, int max_pg,
                                 int pool_dtype, void* stream) {
  if (R < 1 || R > RMAX) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dispatch<128>(pool_dtype, qf, pool_k, pool_v, tables, bound, k_scale, v_scale, m, l, acc, B, nkv, R, page, max_pg, st);
  if (hd == 64) return dispatch<64>(pool_dtype, qf, pool_k, pool_v, tables, bound, k_scale, v_scale, m, l, acc, B, nkv, R, page, max_pg, st);
  return -1;
}
