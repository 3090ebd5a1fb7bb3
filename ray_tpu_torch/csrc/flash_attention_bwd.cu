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
// rt_flash_bwd_dq / rt_flash_bwd_dkv pick the instance by dtype alone.
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
// tensor-core rate, which only wgmma reaches. After the products, the
// scarce resource is registers: the f32 accumulators (dQ: 64 a thread at
// D = 128; dK and dV: 128) must stay in registers next to the score
// fragments, and ptxas runs the wgmmas one at a time ("serialized due to
// insufficient register resources", which also spills) unless all of it
// fits the register count that the block's thread count allows. That
// count is 65536 over the threads rounded up to whole warpgroups: 168 for
// 288 or 384 threads, 255 for 256. ptxas does not count what setmaxnreg
// would add, and a product left in flight across the loop's edge needs
// more registers than one that is waited for; both were tried here and
// dropped.
//
// bf16 (flash_bwd_dq_kernel_wgmma, flash_bwd_dkv_kernel_wgmma): all four
// products of each kernel run on wgmma from TMA-fed, 128-byte-swizzled
// bf16 tiles (csrc/hopper.cuh: 3-D tensor maps per (b, head), so rows past
// T read as zeros and never as the next head's rows). P and dS are rounded
// to bf16 in registers as the A operand of the accumulate products (the
// plain version keeps them in f32). Masking is a select (ok ? p : 0) that
// runs only on diagonal and ragged tiles; `scale` is applied once, to the
// finished accumulators. The results are staged in bf16 through shared
// memory the block no longer reads and written as 16-byte stores. The
// shared-memory descriptors are formed once per tile and advanced by
// constants, so that none is kept in registers across the tile loop.
//
// K2: one block per (b, q head, 128-row q tile): two consumer warpgroups
// of 64 rows and a producer warp (288 threads, 160 registers at D = 128).
// Q and dO are loaded once; 64-key K and V tiles stream through a 3-stage
// ring behind full/empty mbarriers (64 keys, not 128: S and dP are then 32
// registers each beside the 64 of dQ). Per key tile a warpgroup starts
// S = Q K^T and dP = dO V^T (A and B K-major), turns S into P while dP
// still runs, forms dS and starts dQ += dS K (dS from registers, K as an
// MN-major B), waits for it and releases the stage; the other warpgroup's
// products fill the tensor cores meanwhile. A warpgroup whose rows all
// come before the block's last key tile skips it but still releases it.
// q tiles are launched heaviest (last) first within each head.
//
// K3: one block per (b, kv head, 128-key tile): two warpgroups of 64 keys,
// 256 threads and no more, so that a thread may have 255 registers: dK and
// dV (128 f32 a thread at D = 128) with S^T, dP^T and the packed operands
// take 230. There is no producer warp: warp 0 starts the loads of the tile
// two ahead at the top of each tile. Of the other ways to fit, a 32-row q
// tile would have halved the score products' N, and a producer warpgroup
// that gives its registers away (setmaxnreg) does not help, see above.
// For the same reason dS^T is formed from the rounded P^T, not from an f32
// copy kept beside dP^T. K and V are loaded once; (rep head, 64-row q tile)
// pairs of Q and dO (TMA) and lse and delta (4-byte cp.async, zeros past
// T, each lane's arrival on the stage's barrier made when its copies have
// landed) stream as one flat sequence through a 3-stage ring. The scores
// are computed transposed, so no tile is transposed through shared memory:
// S^T = K Q^T and dP^T = V dO^T (A = the warpgroup's 64 key rows, B = the q
// tile, all K-major), P^T and dS^T on the fragments (lse and delta vary
// along the columns and come from the stage), dV += P^T dO and dK += dS^T Q
// (A from registers, B MN-major). P^T is formed while dP^T still runs and
// dS^T while dV's product does. A warpgroup skips the q tile wholly above
// its keys but still releases the stage. Key tiles are launched heaviest
// (first) first within each kv head, which also keeps a head's Q and dO
// in L2 for the blocks that stream them together.
//
// Left for later: ping-pong scheduling between the two warpgroups, a
// persistent grid, K2 at 256 threads (so that dQ's product can run under
// the next tile's scores), and sharing one Q/dO stream between the blocks
// of a cluster (TMA multicast).
//
// f32 (flash_bwd_dq_kernel_f32, flash_bwd_dkv_kernel_f32): the first,
// CUDA-core version, kept so that the f32 whole-path checks hold 1e-4
// (TF32 products would not): 256 threads as 16 x 16 over 64 x 64 score
// tiles from [64][D + 1] f32 shared-memory tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------- bf16: wgmma

constexpr int WT = 64;                  // the streamed tile: keys in K2, query rows in K3
constexpr int WB = 128;                 // the block's own tile: query rows in K2, keys in K3 (64 a warpgroup)
constexpr int STAGES = 3;               // ring depth of the streamed tiles
constexpr int BOX_T = WT * 128;         // bytes of one [64 rows][64] bf16 box
constexpr int BOX_B = WB * 128;         // bytes of one [128 rows][64] bf16 box
constexpr int DQ_THREADS = 256 + 32;    // K2: two consumer warpgroups + the producer warp
constexpr int DKV_THREADS = 256;       // K3: two warpgroups; warp 0 also starts the loads

template <int D>
struct Tiles {
  static constexpr int OWN = BOX_B * (D / 64);     // bytes of a [128][D] tile
  static constexpr int STREAM = BOX_T * (D / 64);  // bytes of a [64][D] tile
  // + 1024: alignment slack; two own tiles, STAGES pairs of streamed tiles, K3's lse and delta rows, barriers
  static constexpr int SMEM = 1024 + 2 * OWN + 2 * STAGES * STREAM + 2 * STAGES * WT * 4 + 8 * (1 + 2 * STAGES);
};

// the two halves of a bf16 pair as f32 (pack_bf16's inverse)
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Descriptors are formed once per tile and advanced by constants, so that none is kept
// in registers across the tile loop.
// K-major operand (its 64-column boxes box_bytes apart): the tile's descriptor, and k-step kk (16 columns)
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile) { return hopper::desc_sw128(tile, 16, 1024); }
__device__ __forceinline__ uint64_t step_k(uint64_t d, int box_bytes, int kk) {
  return hopper::desc_advance(d, (kk / 4) * box_bytes + (kk % 4) * 32);
}
// MN-major operand (a [64 rows][D] tile of 64-column boxes): the tile's descriptor, and k-step c (16 rows)
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile) { return hopper::desc_sw128(tile, BOX_T, 1024); }
__device__ __forceinline__ uint64_t step_mn(uint64_t d, int c) { return hopper::desc_advance(d, c * 16 * 128); }

// The warpgroup's [64][D] f32 fragment times `mul`, as bf16 through `tile` (its 64 rows
// within 128-byte-swizzled boxes BOX_B apart, which no product reads any more), then
// 16-byte stores of the rows below rows_left to `out` (row stride D).
template <int D>
__device__ __forceinline__ void store_fragment(const float (&acc)[D / 2], float mul, uint8_t* tile,
                                               __nv_bfloat16* out, int rows_left, int barrier_id) {
  using namespace hopper;
  const int t = threadIdx.x % 128;
  const int r_lo = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  fence_proxy_async();
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    uint8_t* box = tile + (g / 8) * BOX_B;
    const int chunk = ((g % 8) ^ (r_lo & 7)) * 16 + cq * 2;  // rows r_lo and r_lo + 8 share r % 8
    *reinterpret_cast<uint32_t*>(box + r_lo * 128 + chunk) = pack_bf16(acc[4 * g] * mul, acc[4 * g + 1] * mul);
    *reinterpret_cast<uint32_t*>(box + (r_lo + 8) * 128 + chunk) =
        pack_bf16(acc[4 * g + 2] * mul, acc[4 * g + 3] * mul);
  }
  named_barrier_sync(barrier_id, 128);
#pragma unroll
  for (int idx = t; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), g = idx % (D / 8);
    if (r >= rows_left) break;  // rows run in order: the rest of this thread's are out of range too
    const uint4 val = *reinterpret_cast<const uint4*>(tile + (g / 8) * BOX_B + r * 128 + (((g % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(out + (size_t)r * D + g * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1) flash_bwd_dq_kernel_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Hkv,
    int Tlen, int causal, float scale) {
  using namespace hopper;
  constexpr int OWN = Tiles<D>::OWN, STREAM = Tiles<D>::STREAM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzled boxes: 1024-aligned
  uint8_t* dOs = Qs + OWN;
  uint8_t* Ks = dOs + OWN;           // STAGES tiles
  uint8_t* Vs = Ks + STAGES * STREAM;  // STAGES tiles
  uint64_t* own_full = reinterpret_cast<uint64_t*>(Vs + STAGES * STREAM);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WB;  // heaviest causal tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh - b * H) / (H / Hkv);
  // causal block skip: key tiles starting past the block's last row are wholly above the diagonal
  const int n_kt = causal ? (min(q0 + WB, Tlen) - 1) / WT + 1 : (Tlen + WT - 1) / WT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: TMA loads only
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&domap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(own_full, 2 * OWN);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(Qs + c * BOX_B, &qmap, own_full, c * 64, q0, bh);
        tma_load_3d(dOs + c * BOX_B, &domap, own_full, c * 64, q0, bh);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);  // the consumers released this stage
        mbar_arrive_expect_tx(full + s, 2 * STREAM);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(Ks + s * STREAM + c * BOX_T, &kmap, full + s, c * 64, j * WT, kvh);
          tma_load_3d(Vs + s * STREAM + c * BOX_T, &vmap, full + s, c * 64, j * WT, kvh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int q0w = q0 + wg * 64;
  const int r_lo = (warp % 4) * 16 + lane / 4;  // this thread's first row within the warpgroup's 64
  const int row0 = q0w + r_lo;                  // and its second, row0 + 8
  const int cq = 2 * (lane % 4);                // its first column within each 8-column group
  uint64_t q_desc = desc_k(Qs + wg * 64 * 128);  // the warpgroup's rows within each box
  uint64_t do_desc = desc_k(dOs + wg * 64 * 128);
  // the warpgroup's own key tiles: the block's last one may lie wholly above its rows
  const int n_kt_w = causal ? min(n_kt, (q0w + 63) / WT + 1) : n_kt;

  const size_t row_base = (size_t)bh * Tlen;
  const float l0 = row0 < Tlen ? lse[row_base + row0] * LOG2E : 0.f;
  const float l1 = row0 + 8 < Tlen ? lse[row_base + row0 + 8] * LOG2E : 0.f;
  const float dl0 = row0 < Tlen ? delta[row_base + row0] : 0.f;
  const float dl1 = row0 + 8 < Tlen ? delta[row_base + row0 + 8] : 0.f;
  const float sl = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(own_full, 0);
  fence_regs(acc);
  for (int j = 0; j < n_kt_w; ++j) {
    const int s = j % STAGES;
    const int k0 = j * WT;
    const uint64_t k_desc = desc_k(Ks + s * STREAM), v_desc = desc_k(Vs + s * STREAM);
    const uint64_t k_mn = desc_mn(Ks + s * STREAM);
    desc_pin(q_desc);
    desc_pin(do_desc);
    mbar_wait(full + s, (j / STAGES) & 1);

    // S = Q K^T and dP = dO V^T: m64n64, D / 16 k-steps each, one group each
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(sc, step_k(q_desc, BOX_B, kk), step_k(k_desc, BOX_T, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(dp, step_k(do_desc, BOX_B, kk), step_k(v_desc, BOX_T, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is done; dP may still run
    fence_regs(sc);

    // P = exp(S scale - lse) on the fragments; the select runs only where a key can be out of range
    // or above the diagonal (exp(0 - lse) is not 0)
    const bool masked = k0 + WT > Tlen || (causal && k0 + WT - 1 > q0w);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(sc[i], sl, (i & 2) ? -l1 : -l0));
      if (masked) {
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = row0 + ((i & 2) ? 8 : 0);
        p = (col < Tlen && (!causal || col <= row)) ? p : 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t ds[16];  // dS in bf16 pairs: chunk c of 16 keys is ds[4 c .. 4 c + 3], wgmma's A layout
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      ds[2 * g] = pack_bf16(sc[4 * g] * (dp[4 * g] - dl0), sc[4 * g + 1] * (dp[4 * g + 1] - dl0));
      ds[2 * g + 1] = pack_bf16(sc[4 * g + 2] * (dp[4 * g + 2] - dl1), sc[4 * g + 3] * (dp[4 * g + 3] - dl1));
    }

    // dQ += dS K: m64nD, 4 k-steps of 16 keys; K is [keys][d]: MN-major
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < WT / 16; ++c)
      wgmma_rs<D, 1>(acc, ds[4 * c], ds[4 * c + 1], ds[4 * c + 2], ds[4 * c + 3], step_mn(k_mn, c), 1);
    wgmma_commit();
    // waited for here: left in flight across the loop's edge it needs more than the 168 registers
    // a thread of this block may have, and ptxas then serialises every wgmma of the kernel
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + s);
  }
  // a tile wholly above this warpgroup's rows is still released, or the producer would wait forever
  for (int j = n_kt_w; j < n_kt; ++j) {
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
    if (lane == 0) mbar_arrive(empty + j % STAGES);
  }

  // ---- epilogue: dQ * scale in bf16 through the warpgroup's own Q rows
  store_fragment<D>(acc, scale, Qs + wg * 64 * 128, dq + (row_base + q0w) * D, Tlen - q0w, 1 + wg);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_kernel_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Tlen, int causal, float scale) {
  using namespace hopper;
  constexpr int OWN = Tiles<D>::OWN, STREAM = Tiles<D>::STREAM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzled boxes: 1024-aligned
  uint8_t* Vs = Ks + OWN;
  uint8_t* Qs = Vs + OWN;              // STAGES tiles
  uint8_t* dOs = Qs + STAGES * STREAM;  // STAGES tiles
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * STREAM);  // [STAGES][64]
  float* delta_s = lse_s + STAGES * WT;                            // [STAGES][64]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(delta_s + STAGES * WT);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int bg = blockIdx.y;
  const int k0 = blockIdx.x * WB;  // causal: key tile 0, the heaviest, first
  const int b = bg / Hkv;
  const int rep = H / Hkv;
  const int bh0 = b * H + (bg - b * Hkv) * rep;  // the kv head's first q head
  // causal block skip: q tiles that end before this key tile starts see none of it
  const int qt_first = causal ? k0 / WT : 0;
  const int n_q = (Tlen + WT - 1) / WT - qt_first;  // q tiles per rep head
  const int n_it = rep * n_q;                       // the flat sequence: rep head it / n_q, q tile qt_first + it % n_q
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 33);  // the TMA's expect-tx arrival + one per lane of warp 0 (lse, delta)
      mbar_init(empty + s, 8);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Warp 0 loads tile `pf` of the sequence into its stage, once both warpgroups have released the
  // stage's last tile: Q and dO by TMA (lane 0), lse and delta by 4-byte asynchronous copies (every
  // lane two rows of each, zeros past T: [B, H, T] f32 rows are 16-byte aligned only when T % 4 == 0,
  // and a bulk copy does not stop at T), each lane's arrival made when its copies have landed.
  auto load_tile = [&](int pf) {
    const int s = pf % STAGES;
    if (pf >= STAGES) mbar_wait(empty + s, ((pf / STAGES) & 1) ^ 1);
    const int r = pf / n_q;
    const int q0 = (qt_first + pf - r * n_q) * WT;
    const size_t row_base = (size_t)(bh0 + r) * Tlen;
#pragma unroll
    for (int i = lane; i < WT; i += 32) {
      const bool ok = q0 + i < Tlen;
      const size_t row = row_base + min(q0 + i, Tlen - 1);
      cp_async_f32(lse_s + s * WT + i, lse + row, ok);
      cp_async_f32(delta_s + s * WT + i, delta + row, ok);
    }
    cp_async_mbar_arrive(full + s);
    if (lane == 0) {
      mbar_arrive_expect_tx(full + s, 2 * STREAM);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(Qs + s * STREAM + c * BOX_T, &qmap, full + s, c * 64, q0, bh0 + r);
        tma_load_3d(dOs + s * STREAM + c * BOX_T, &domap, full + s, c * 64, q0, bh0 + r);
      }
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&domap);
      mbar_arrive_expect_tx(own_full, 2 * OWN);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(Ks + c * BOX_B, &kmap, own_full, c * 64, k0, bg);
        tma_load_3d(Vs + c * BOX_B, &vmap, own_full, c * 64, k0, bg);
      }
    }
    for (int pf = 0; pf < min(STAGES - 1, n_it); ++pf) load_tile(pf);
  }

  // ---- warpgroup wg owns keys k0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int k0w = k0 + wg * 64;
  const int r_lo = (warp % 4) * 16 + lane / 4;  // this thread's first key row within the warpgroup's 64
  const int key0 = k0w + r_lo;                  // and its second, key0 + 8
  const int cq = 2 * (lane % 4);                // its first q column within each 8-column group
  uint64_t k_desc = desc_k(Ks + wg * 64 * 128);  // the warpgroup's rows within each box
  uint64_t v_desc = desc_k(Vs + wg * 64 * 128);
  const float sl = scale * LOG2E;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  int qi = 0;

  mbar_wait(own_full, 0);
  fence_regs(acc_dk);
  fence_regs(acc_dv);
  for (int it = 0; it < n_it; ++it) {
    // the tile STAGES - 1 ahead goes into the stage that tile it - 1 has just left
    if (warp == 0 && it + STAGES - 1 < n_it) load_tile(it + STAGES - 1);
    const int s = it % STAGES;
    const int q0 = (qt_first + qi) * WT;
    if (++qi == n_q) qi = 0;
    const uint64_t q_desc = desc_k(Qs + s * STREAM), do_desc = desc_k(dOs + s * STREAM);
    const uint64_t q_mn = desc_mn(Qs + s * STREAM), do_mn = desc_mn(dOs + s * STREAM);
    desc_pin(k_desc);
    desc_pin(v_desc);
    mbar_wait(full + s, (it / STAGES) & 1);
    if (causal && q0 + WT - 1 < k0w) {
      // wholly above this warpgroup's keys: skipped, but released, or warp 0 would wait forever
      if (lane == 0) mbar_arrive(empty + s);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T: m64n64, D / 16 k-steps each, one group each
    float st[32], dpt[32];
    uint32_t pp[16], dsp[16];  // P^T and dS^T in bf16 pairs: chunk c of 16 q rows is [4 c .. 4 c + 3]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(st, step_k(k_desc, BOX_B, kk), step_k(q_desc, BOX_T, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(dpt, step_k(v_desc, BOX_B, kk), step_k(do_desc, BOX_T, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done; dP^T may still run
    fence_regs(st);

    // P^T = exp(S^T scale - lse[q]) in bf16 pairs; the select runs only on diagonal and ragged tiles
    const bool masked = q0 + WT > Tlen || k0w + 64 > Tlen || (causal && q0 < k0w + 63);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + s * WT + 8 * g + cq);
      const float lx = l.x * LOG2E, ly = l.y * LOG2E;
      float p00 = exp2f(fmaf(st[4 * g], sl, -lx));
      float p01 = exp2f(fmaf(st[4 * g + 1], sl, -ly));
      float p10 = exp2f(fmaf(st[4 * g + 2], sl, -lx));
      float p11 = exp2f(fmaf(st[4 * g + 3], sl, -ly));
      if (masked) {
        const int qa = q0 + 8 * g + cq, qb = qa + 1;
        const bool a_ok = qa < Tlen, b_ok = qb < Tlen;
        p00 = (a_ok && key0 < Tlen && (!causal || key0 <= qa)) ? p00 : 0.f;
        p01 = (b_ok && key0 < Tlen && (!causal || key0 <= qb)) ? p01 : 0.f;
        p10 = (a_ok && key0 + 8 < Tlen && (!causal || key0 + 8 <= qa)) ? p10 : 0.f;
        p11 = (b_ok && key0 + 8 < Tlen && (!causal || key0 + 8 <= qb)) ? p11 : 0.f;
      }
      pp[2 * g] = pack_bf16(p00, p01);
      pp[2 * g + 1] = pack_bf16(p10, p11);
    }

    // dV += P^T dO: m64nD, 4 k-steps of 16 q rows; dO is [q rows][d]: MN-major. Runs under the dS^T arithmetic.
    fence_regs(pp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < WT / 16; ++c)
      wgmma_rs<D, 1>(acc_dv, pp[4 * c], pp[4 * c + 1], pp[4 * c + 2], pp[4 * c + 3], step_mn(do_mn, c), 1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done
    fence_regs(dpt);
    // dS^T = P^T (dP^T - delta[q]) from the rounded P^T: an f32 copy of P^T kept beside dP^T and
    // both accumulators does not fit a thread's registers
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + s * WT + 8 * g + cq);
      dsp[2 * g] = pack_bf16(bf16_lo(pp[2 * g]) * (dpt[4 * g] - dl.x), bf16_hi(pp[2 * g]) * (dpt[4 * g + 1] - dl.y));
      dsp[2 * g + 1] = pack_bf16(bf16_lo(pp[2 * g + 1]) * (dpt[4 * g + 2] - dl.x),
                                 bf16_hi(pp[2 * g + 1]) * (dpt[4 * g + 3] - dl.y));
    }

    // dK += dS^T Q: the same with Q
    fence_regs(dsp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < WT / 16; ++c)
      wgmma_rs<D, 1>(acc_dk, dsp[4 * c], dsp[4 * c + 1], dsp[4 * c + 2], dsp[4 * c + 3], step_mn(q_mn, c), 1);
    wgmma_commit();
    wgmma_wait<0>();  // before warp 0 may refill the stage
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    if (lane == 0) mbar_arrive(empty + s);
  }

  // ---- epilogue: dK * scale and dV in bf16 through the warpgroup's own K and V rows
  const size_t out = ((size_t)bg * Tlen + k0w) * D;
  store_fragment<D>(acc_dk, scale, Ks + wg * 64 * 128, dk + out, Tlen - k0w, 1 + wg);
  store_fragment<D>(acc_dv, 1.f, Vs + wg * 64 * 128, dv + out, Tlen - k0w, 1 + wg);
}

// The four tensor maps of a launch: q and dO in boxes of q_rows rows, k and v of kv_rows.
template <int D>
bool encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout, int B, int H,
                 int Hkv, int Tlen, int q_rows, int kv_rows) {
  return hopper::tma_map_bf16_3d(&maps[0], q, D, Tlen, (uint64_t)B * H, q_rows) &&
         hopper::tma_map_bf16_3d(&maps[1], k, D, Tlen, (uint64_t)B * Hkv, kv_rows) &&
         hopper::tma_map_bf16_3d(&maps[2], v, D, Tlen, (uint64_t)B * Hkv, kv_rows) &&
         hopper::tma_map_bf16_3d(&maps[3], dout, D, Tlen, (uint64_t)B * H, q_rows);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, q, k, v, dout, B, H, Hkv, Tlen, WB, WT)) return -2;
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_bwd_dq_kernel_wgmma<D>, Tiles<D>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + WB - 1) / WB, B * H);
  flash_bwd_dq_kernel_wgmma<D><<<grid, DQ_THREADS, Tiles<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H, int Hkv, int Tlen, int causal, float scale,
                     cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, q, k, v, dout, B, H, Hkv, Tlen, WT, WB)) return -2;
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_bwd_dkv_kernel_wgmma<D>, Tiles<D>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + WB - 1) / WB, B * Hkv);
  flash_bwd_dkv_kernel_wgmma<D><<<grid, DKV_THREADS, Tiles<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ f32: CUDA cores

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile (BQ == BK: the diagonal tile of a key tile is the q tile of the same index)
constexpr int NT = 256;  // threads per block: 16 x 16

// rows [r0, r0 + 64) of a [Tlen, D] matrix into a [64][D + 1] f32 tile, zeros past Tlen
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int Tlen, int tid) {
  for (int e = tid; e < 64 * D; e += NT) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < Tlen ? src[(size_t)row * D + c] : 0.f;
  }
}

// One block per (b, q head, 64-row q tile). Q and dO stay in shared memory; the block walks
// the 64-key tiles up to the diagonal (causal block skip), recomputes S and dP in one pass
// over D, writes dS to shared memory and accumulates dQ += dS K. Heaviest (last) q tile first.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int Tlen, int causal, float scale) {
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

  const float* kb = k + (size_t)(b * Hkv + hk) * Tlen * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Tlen * D;
  load_tile<D>(Qs, q + (size_t)bh * Tlen * D, q0, Tlen, tid);
  load_tile<D>(dOs, dout + (size_t)bh * Tlen * D, q0, Tlen, tid);

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
    load_tile<D>(Ks, kb, k0, Tlen, tid);
    load_tile<D>(Vs, vb, k0, Tlen, tid);
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
    float* out = dq + ((size_t)bh * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[tx + 16 * j] = acc[i][j] * scale;
  }
}

// One block per (b, kv head, 64-key tile). K and V stay in shared memory; the block walks the
// rep q heads of its kv head and, for each, the q tiles from the diagonal onward, writing P^T
// and dS^T tiles to shared memory and accumulating dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Tlen, int causal, float scale) {
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

  load_tile<D>(Ks, k + (size_t)bg * Tlen * D, k0, Tlen, tid);
  load_tile<D>(Vs, v + (size_t)bg * Tlen * D, k0, Tlen, tid);

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
    const float* qb = q + (size_t)bh * Tlen * D;
    const float* dob = dout + (size_t)bh * Tlen * D;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
      load_tile<D>(Qs, qb, q0, Tlen, tid);
      load_tile<D>(dOs, dob, q0, Tlen, tid);
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
    float* dkr = dk + ((size_t)bg * Tlen + row) * D;
    float* dvr = dv + ((size_t)bg * Tlen + row) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dkr[tx + 16 * j] = acc_dk[i][j] * scale;
      dvr[tx + 16 * j] = acc_dv[i][j];
    }
  }
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int H, int Hkv, int Tlen, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_bwd_dq_kernel_f32<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel_f32<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Tlen, int causal, float scale,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::set_smem_once(flash_bwd_dkv_kernel_f32<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + BK - 1) / BK, B * Hkv);
  flash_bwd_dkv_kernel_f32<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Tlen, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), -1 for a
// head_dim with no instance, -2 if a bf16 input's tensor map cannot be
// encoded (its base is not 16-byte aligned).
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H, int Hkv, int Tlen, int D, int causal,
                               float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16 ? launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16 ? launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int H, int Hkv, int Tlen, int D,
                                int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return is_bf16 ? launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st);
  }
  if (D == 64) {
    return is_bf16 ? launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st)
                   : launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tlen, causal, scale, st);
  }
  return -1;
}
