// K1: flash-attention forward (causal or not) for Hopper, CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel,
// launched by _fwd_pallas (flash_attention.py:104). Same function: an
// online softmax with f32 m/l/acc over kv tiles, causal tiles wholly
// above the diagonal skipped, the -1e30 surrogate for masked logits, O
// written in the input dtype and the logsumexp (natural log) in f32.
// Reference: _fwd_xla_with_lse (flash_attention.py:342), ported as
// ray_tpu_torch/ops/flash_attention.py::attention_with_lse_ref.
//
// Layout: q [B, H, T, D]; k, v [B, Hkv, T, D] (GQA is indexed, head h reads
// kv head h / (H / Hkv); nothing is repeated in memory); o [B, H, T, D] in
// q's dtype; lse [B, H, T] f32. D in {64, 128}; bf16 or f32 inputs; any T.
// rt_flash_fwd picks the instance by dtype alone.
//
// What bounds it on an H100: at the prefill and training shapes (T = 512 ..
// 2048, D = 128) attention is bound by operations (4 D flops per causal
// query-key pair against 2 bytes per element read once), so the bound is
// the 989 TFLOP/s bf16 rate, which only wgmma reaches.
//
// bf16 (flash_fwd_kernel_wgmma): both products on the tensor cores. One
// block owns 128 query rows of one (b, h): two consumer warpgroups of 64
// rows (wgmma's M) and one producer warp. The producer loads the Q tile once
// and the 128-key K and V tiles into a ring of STAGES shared-memory stages
// with TMA (3-D tensor maps over [B*H or B*Hkv][T][D], so a ragged last tile
// reads zeros and never the next head's rows; 128-byte swizzle, a D = 128
// tile is two 64-column boxes), each stage behind a "full" mbarrier the TMA
// completes and an "empty" one that all 8 consumer warps release after the
// wgmma that read it. Per key tile a warpgroup runs S = Q K^T as
// m64n128k16 from shared memory (both K-major), the online softmax on the
// accumulator fragments (a row's values sit in the 4 lanes of a quad: two
// shuffles; masking only on the diagonal and the ragged tile), and
// O += P V as m64nDk16 with P rounded to bf16 in registers as the A
// operand (the plain version rounds P to v's dtype too) and V from shared
// memory as an MN-major B. The epilogue stages O / max(l, 1e-30) through the
// warpgroup's own Q rows and writes 16-byte stores. Causal q tiles are
// issued heaviest first. Left for later: ping-pong between the two
// warpgroups (one's softmax under the other's products), overlapping a
// warpgroup's softmax with its own next S, and a persistent grid.
//
// f32 (flash_fwd_kernel_f32): the first, CUDA-core version of this kernel,
// kept so that the f32 whole-path checks hold 1e-4 (TF32 products would
// not): 64-row blocks over 64-key f32 tiles in shared memory, each thread a
// 4x4 patch of S and a 4 x D/16 patch of O, rows reduced with half-warp
// shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;  // the reference's -inf surrogate (_NEG_INF)
constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------- bf16: wgmma

constexpr int WBQ = 128;                    // query rows per block
constexpr int WBK = 128;                    // keys per tile
constexpr int STAGES = 2;                   // K/V ring depth
constexpr int BOX_BYTES = 128 * 128;        // one [128 rows][64] bf16 box
constexpr int CONSUMER_THREADS = 256;       // two warpgroups
constexpr int WTHREADS = CONSUMER_THREADS + 32;  // + the producer warp

template <int D>
struct Wgmma {
  static constexpr int TILE_BYTES = 128 * D * 2;  // Q, K or V tile: D / 64 boxes
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  static constexpr int SMEM = 1024 + TILE_BYTES * (1 + 2 * STAGES) + BAR_BYTES;  // + 1024: alignment slack
};

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1) flash_fwd_kernel_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Hkv,
    int Tlen, int causal, float scale) {
  using namespace hopper;
  constexpr int TILE = Wgmma<D>::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzled boxes: 1024-aligned
  uint8_t* Ks = Qs + TILE;                  // STAGES tiles
  uint8_t* Vs = Ks + STAGES * TILE;         // STAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * WBQ;  // heaviest causal tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh - b * H) / (H / Hkv);
  // causal block skip: key tiles starting past the block's last row are wholly above the diagonal
  const int n_kt = causal ? (min(q0 + WBQ, Tlen) - 1) / WBK + 1 : (Tlen + WBK - 1) / WBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMER_THREADS / 32);
      mbar_init(v_empty + s, CONSUMER_THREADS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMER_THREADS / 32) {  // the producer warp: TMA loads only
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(q_full, TILE);
      for (int c = 0; c < D / 64; ++c) tma_load_3d(Qs + c * BOX_BYTES, &qmap, q_full, c * 64, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        if (j >= STAGES) mbar_wait(k_empty + s, ph ^ 1);  // the consumers released this stage's last K
        mbar_arrive_expect_tx(k_full + s, TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(Ks + s * TILE + c * BOX_BYTES, &kmap, k_full + s, c * 64, j * WBK, kvh);
        if (j >= STAGES) mbar_wait(v_empty + s, ph ^ 1);
        mbar_arrive_expect_tx(v_full + s, TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(Vs + s * TILE + c * BOX_BYTES, &vmap, v_full + s, c * 64, j * WBK, kvh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;  // this thread's first row within the warpgroup's 64
  const int row0 = q0 + wg * 64 + r_lo;         // and its second, row0 + 8
  const int cq = 2 * (lane % 4);                // its first column within each 8-column group
  uint8_t* Qw = Qs + wg * 64 * 128;             // the warpgroup's rows within each Q box

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const int k0 = j * WBK;

    // S = Q K^T: m64n128, D / 16 k-steps
    float sc[64];
    mbar_wait(k_full + s, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<128, 0, 0>(sc, desc_sw128(Qw + off, 16, 1024), desc_sw128(Ks + s * TILE + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty + s);

    // online softmax on the fragments; masks only where a key can be out of range or above the diagonal
    const bool masked = k0 + WBK > Tlen || (causal && k0 + WBK - 1 > q0 + wg * 64);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale;
      if (masked) {
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = row0 + ((i & 2) ? 8 : 0);
        if (col >= Tlen || (causal && col > row)) x = NEG;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * LOG2E);
    const float alpha1 = exp2f((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * LOG2E, mb1 = mx1 * LOG2E;
    uint32_t p[32];  // P in bf16 pairs: chunk c of 16 keys is p[4 c .. 4 c + 3], wgmma's A layout
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const float p00 = exp2f(fmaf(sc[4 * g], LOG2E, -mb0));
      const float p01 = exp2f(fmaf(sc[4 * g + 1], LOG2E, -mb0));
      const float p10 = exp2f(fmaf(sc[4 * g + 2], LOG2E, -mb1));
      const float p11 = exp2f(fmaf(sc[4 * g + 3], LOG2E, -mb1));
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      p[2 * g] = pack_bf16(p00, p01);
      p[2 * g + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      acc[4 * g] *= alpha0;
      acc[4 * g + 1] *= alpha0;
      acc[4 * g + 2] *= alpha1;
      acc[4 * g + 3] *= alpha1;
    }

    // O += P V: m64nD, 8 k-steps of 16 keys; V is [keys][d]: MN-major
    mbar_wait(v_full + s, ph);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < WBK / 16; ++c) {
      wgmma_rs<D, 1>(acc, p[4 * c], p[4 * c + 1], p[4 * c + 2], p[4 * c + 3],
                     desc_sw128(Vs + s * TILE + c * 16 * 128, BOX_BYTES, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(v_empty + s);
  }

  // ---- epilogue: O / max(l, 1e-30) in bf16 through the warpgroup's own Q rows (its
  // last S product has completed), swizzled as Q is, then 16-byte stores of whole rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / L0, inv1 = 1.f / L1;
  fence_proxy_async();
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    uint8_t* box = Qw + (g / 8) * BOX_BYTES;
    const int chunk = ((g % 8) ^ (r_lo & 7)) * 16 + cq * 2;  // rows r_lo and r_lo + 8 share r % 8
    *reinterpret_cast<uint32_t*>(box + r_lo * 128 + chunk) = pack_bf16(acc[4 * g] * inv0, acc[4 * g + 1] * inv0);
    *reinterpret_cast<uint32_t*>(box + (r_lo + 8) * 128 + chunk) =
        pack_bf16(acc[4 * g + 2] * inv1, acc[4 * g + 3] * inv1);
  }
  named_barrier_sync(1 + wg, 128);
  const int t = threadIdx.x % 128;
  const int rows_left = Tlen - (q0 + wg * 64);
#pragma unroll
  for (int idx = t; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), g = idx % (D / 8);
    if (r >= rows_left) break;  // rows run in order: the rest of this thread's are out of range too
    const uint4 val = *reinterpret_cast<const uint4*>(Qw + (g / 8) * BOX_BYTES + r * 128 + (((g % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(o + ((size_t)bh * Tlen + q0 + wg * 64 + r) * D + g * 8) = val;
  }
  if (lane % 4 == 0) {
    if (row0 < Tlen) lse[(size_t)bh * Tlen + row0] = m0 + logf(L0);
    if (row0 + 8 < Tlen) lse[(size_t)bh * Tlen + row0 + 8] = m1 + logf(L1);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Hkv, int Tlen,
                 int causal, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::tma_map_bf16_3d(&qmap, q, D, Tlen, (uint64_t)B * H, WBQ) ||
      !hopper::tma_map_bf16_3d(&kmap, k, D, Tlen, (uint64_t)B * Hkv, WBK) ||
      !hopper::tma_map_bf16_3d(&vmap, v, D, Tlen, (uint64_t)B * Hkv, WBK))
    return -2;
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_fwd_kernel_wgmma<D>, Wgmma<D>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tlen + WBQ - 1) / WBQ);
  flash_fwd_kernel_wgmma<D><<<grid, WTHREADS, Wgmma<D>::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ f32: CUDA cores

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block: 16 x 16

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse,
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

  const float* qb = q + (size_t)bh * Tlen * D;
  const float* kb = k + (size_t)(b * Hkv + hk) * Tlen * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Tlen * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = q0 + r;
    Qs[r * (D + 1) + c] = row < Tlen ? qb[(size_t)row * D + c] : 0.f;
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
      Ks[r * (D + 1) + c] = ok ? kb[(size_t)row * D + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)row * D + c] : 0.f;
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
    float* orow = o + ((size_t)bh * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) orow[tx + 16 * j] = acc[i][j] / L;
    if (tx == 0) lse[(size_t)bh * Tlen + row] = m[i] + logf(L);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_fwd_kernel_f32<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BQ - 1) / BQ, B * H);
  flash_fwd_kernel_f32<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), -1 for a
// head_dim this kernel has no instance for, -2 if a bf16 input's tensor map
// cannot be encoded (its base is not 16-byte aligned).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int Hkv, int Tlen, int D, int causal, float scale,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16 ? launch_wgmma<128>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_f32<128>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16 ? launch_wgmma<64>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_f32<64>(q, k, v, o, lse, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}
