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
// Layout: qf [B, nkv, rep, T, hd] f32 (R = rep * T rows per kv head, any
// number: decode has R = rep, ray_tpu's prefix-cache extend R = rep * the
// suffix's prefill bucket); pool_k / pool_v [P, page, nkv, hd] f32, bf16 or
// int8; tables [B, max_pg] i32; bound [B] i32; k_scale / v_scale
// [P, nkv, page] f32 (int8 only); m, l [B, nkv, rep, T] and acc
// [B, nkv, rep, T, hd] f32.
//
// Aliasing contract: no position >= bound[b] is ever read, and no table
// entry at or past ceil(bound[b] / page) is dereferenced. The position the
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
// What bounds it on an H100: bytes at decode, operations at the extend.
// Every cached K or V element meets R query rows for 2 R f32 flops, so a
// bf16 pool gives R operations per byte read. The card's f32 rate over its
// memory rate is 67 / 3.35 = 20 operations per byte: at decode (R = 4) the
// bound is the K/V bytes up to each lane's bound over 3.35 TB/s, and at an
// extend (R = 4 x the suffix's bucket, 68 to 8192) the f32 operations over
// 67 TFLOP/s.
//
// Design (flash-decoding): the R rows of a kv head are cut into row tiles
// of at most RT = 64 rows (rows of one kv head are contiguous in (rep, T)
// order in qf, m, l and acc, so a tile is a row offset; the last tile is
// ragged), and each lane's pages into splits of `pps` pages, chosen by the
// wrapper (llm/cuda/paged_attn.py::split_plan) from max_pg, the row-tile
// lanes B * nkv * tiles and the SM count so that the grid fills the card at
// batch 8 and at batch 1 and does not split when the tiles alone fill it.
// Each tile re-reads its split's K/V (the tiles of one split are adjacent
// in the grid, so the re-reads mostly hit L2). The bound lives on the
// device, so the grid covers every split up to max_pg; a split that starts
// at or past the bound writes the empty partial (m = -1e30, l = 0, acc = 0)
// and exits.
// - paged_partials_kernel, one 256-thread block per (lane, kv head, split,
//   row tile):
//   reads its split's table entries once into shared memory, then streams
//   the split in chunks of 64 positions through a ring of 2 stages (3 for
//   int8 pools) filled by 16-byte cp.async copies (4-byte ones for the int8
//   scales), in the pool's own dtype, rows padded by 16 bytes so that
//   eight threads reading eight rows hit distinct banks. Positions at or
//   past the bound are zero-filled, never read. Per chunk: scores (four
//   threads per position, each a quarter of the head dim against four
//   query rows at a time, summed by shuffles; Q's quarters interleaved in
//   shared memory so that they read distinct banks; the int8 K scale
//   applied to the dot),
//   the online-softmax update (a warp per query row), then P V (a thread
//   per 8 head dims and a few rows, the positions split between threads
//   when R is small; the int8 V scale folded into p). All arithmetic is
//   f32 on the CUDA cores.
// - paged_merge_kernel, launched by the same call when there is more than
//   one split: per (lane, kv head) it folds the splits that hold data with
//   paged_kv._combine's formula, in split order, starting from the empty
//   partial. With one split the partials kernel writes the outputs itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int CH = 64;             // positions per chunk (one ring stage)
constexpr int RT = 64;             // query rows per block: a row tile of one kv head's rep * T rows
constexpr int MAX_SPLIT_PAGES = 256;  // table entries a split stages (split_plan keeps pps at or below)
constexpr float NEG = -1e30f;      // paged_kv._NEG

template <typename T, int HD>
struct Cfg {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int EV = 16 / ES;            // elements per 16-byte vector
  static constexpr int VPR = HD / EV;           // vectors per row
  static constexpr int RS = HD * ES + 16;       // bytes per staged row, padded
  static constexpr int NS = ES == 1 ? 3 : 2;    // ring stages: a chunk in flight per stage past the one computed
  static constexpr int KV_BYTES = CH * RS;      // one chunk of K (or V)
  static constexpr int STAGE = 2 * KV_BYTES + 2 * CH * 4;  // K rows, V rows, K and V scales
  static constexpr int QD = HD / 4;             // head dims per score thread (a quarter of the head)
  static constexpr int FQ = QD / 4;             // float4s of Q per quarter
  static constexpr int NCG = HD / 8;            // 8-dim column groups of P V
  static constexpr int GROUPS = NT / NCG;       // row groups x position splits of P V
  static constexpr int RPT = (RT + GROUPS - 1) / GROUPS;  // rows a P V thread holds, at most
  static_assert(CH * VPR % NT == 0, "whole vectors per thread");
  static_assert(QD % EV == 0, "whole vectors per score thread");
};

// Q's float4 f of a row (head dims 4f .. 4f + 3) sits at float4 q_slot(f) of the row: the four quarters' j-th
// float4s side by side, so that the four quarters a warp reads at once fall in distinct banks.
template <int FQ>
__device__ __forceinline__ int q_slot(int f) { return (f % FQ) * 4 + f / FQ; }

// Dynamic shared memory for a tile of R rows: the ring, then Q [R][HD] f32 (float4s in q_slot order), P
// [R][CH + 1] f32, m / l / alpha [R] f32, the split's page ids.
template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes(int R) {
  return Cfg<T, HD>::NS * Cfg<T, HD>::STAGE + R * HD * 4 + R * (CH + 1) * 4 + 3 * R * 4 + MAX_SPLIT_PAGES * 4;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// n consecutive elements of T from shared memory (16-byte aligned; n * sizeof(T) a multiple of 8) into f32.
template <typename T, int N>
__device__ __forceinline__ void lds_f32(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else {
    // int8 b -> f32 exactly, without I2F: u = b + 128 (the sign bit flipped) as the low mantissa byte of
    // 2^23 (a byte permute), then 2^23 + u - (2^23 + 128) = b
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
      const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[i + j] = __uint_as_float(__byte_perm(w[j >> 2], 0x4B000000u, 0x7540u | (j & 3))) - 8388736.f;
    }
  }
}

template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(NT, 2) paged_partials_kernel(
    const float* __restrict__ qf, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const int* __restrict__ tables, const int* __restrict__ bound,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
    int nkv, int R_all, int page, int max_pg, int pps, int nsplit, int ntiles) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x % ntiles;  // the tiles of one (lane, kv head, split) are adjacent: L2 serves the re-reads
  const int split = (blockIdx.x / ntiles) % nsplit;
  const int blk = blockIdx.x / ntiles / nsplit;  // = b * nkv + g
  const int b = blk / nkv;
  const int g = blk - b * nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = tile * RT;           // the tile's first row of the kv head's R_all rows
  const int R = min(RT, R_all - row0);  // the tile's rows (the last tile is ragged)
  const size_t out_row = ((size_t)blk * nsplit + split) * R_all + row0;  // this block's first row of m/l (acc: x HD)
  float* Qs = reinterpret_cast<float*>(smem + C::NS * C::STAGE);  // [R][HD]
  float* Ps = Qs + R * HD;           // [R][CH + 1]
  float* Ms = Ps + R * (CH + 1);     // [R] running max
  float* Ls = Ms + R;                // [R] running sum
  float* As = Ls + R;                // [R] this chunk's rescale factor
  int* pid_s = reinterpret_cast<int*>(As + R);  // [pps] the split's page ids

  const int nb = min(bound[b], max_pg * page);
  const int start = split * pps * page;
  if (start >= nb) {  // the empty partial: no position of this split is below the bound
    for (int r = tid; r < R; r += NT) {
      m_out[out_row + r] = NEG;
      l_out[out_row + r] = 0.f;
    }
    for (int e = tid; e < R * HD; e += NT) acc_out[out_row * HD + e] = 0.f;
    return;
  }
  const int end = min(start + pps * page, nb);
  const int first_page = split * pps;
  const int npages = (end - 1) / page - first_page + 1;  // pages of the split below the bound
  const int* trow = tables + (size_t)b * max_pg + first_page;
  for (int j = tid; j < npages; j += NT) pid_s[j] = trow[j];
  const float4* q4 = reinterpret_cast<const float4*>(qf + ((size_t)blk * R_all + row0) * HD);
  for (int e = tid; e < R * HD / 4; e += NT) {
    const int r = e / (HD / 4), f = e - r * (HD / 4);
    reinterpret_cast<float4*>(Qs)[r * (HD / 4) + q_slot<C::FQ>(f)] = q4[e];
  }
  for (int r = tid; r < R; r += NT) {
    Ms[r] = NEG;
    Ls[r] = 0.f;
  }
  __syncthreads();

  const int nchunks = (end - start + CH - 1) / CH;
  // copy chunk c into its stage: K and V rows (16-byte copies), int8 scales (4-byte copies)
  auto load_chunk = [&](int c) {
    unsigned char* st = smem + (c % C::NS) * C::STAGE;
    const int c0 = start + c * CH;
#pragma unroll
    for (int k = 0; k < CH * C::VPR / NT; ++k) {
      const int idx = tid + k * NT;
      const int row = idx / C::VPR, vec = idx - row * C::VPR;
      const int pos = c0 + row;
      const bool ok = pos < end;
      size_t off = 0;
      if (ok) {
        const int pg = pos / page;
        off = (((size_t)pid_s[pg - first_page] * page + (pos - pg * page)) * nkv + g) * HD + vec * C::EV;
      }
      cp_async_16(st + row * C::RS + vec * 16, pool_k + off, ok);
      cp_async_16(st + C::KV_BYTES + row * C::RS + vec * 16, pool_v + off, ok);
    }
    if (QUANT && tid < 2 * CH) {
      const int row = tid & (CH - 1);
      const int pos = c0 + row;
      const bool ok = pos < end;
      size_t si = 0;
      if (ok) {
        const int pg = pos / page;
        si = ((size_t)pid_s[pg - first_page] * nkv + g) * page + (pos - pg * page);
      }
      float* dst = reinterpret_cast<float*>(st + 2 * C::KV_BYTES) + tid;  // K scales, then V scales
      hopper::cp_async_f32(dst, (tid < CH ? k_scale : v_scale) + si, ok);
    }
  };

#pragma unroll
  for (int c = 0; c < C::NS - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }

  // score threads: position sc, head-dim quarter qd; eight consecutive lanes hold eight positions
  const int sc = (tid & 7) + 8 * warp;
  const int qd = (tid >> 3) & 3;
  // P V threads: 8 head dims (column group cg), rows rg + nrg * i (i < RPT), positions ps + nps * j; as few
  // row groups as cover R, so that each V element is converted by few threads, and the positions split the rest
  const int cg = tid % C::NCG;
  const int grp = tid / C::NCG;
  int nrg = 1;
  while (nrg * C::RPT < R) nrg <<= 1;
  const int nps = C::GROUPS / nrg;
  const int rg = grp % nrg, ps = grp / nrg;
  float acc[C::RPT][8];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<C::NS - 2>();
    __syncthreads();  // chunk c has landed for every thread; chunk c - 1 is consumed
    if (c + C::NS - 1 < nchunks) load_chunk(c + C::NS - 1);
    cp_async_commit();
    const unsigned char* st = smem + (c % C::NS) * C::STAGE;
    const T* Ks = reinterpret_cast<const T*>(st);
    const T* Vs = reinterpret_cast<const T*>(st + C::KV_BYTES);
    const float* KSs = reinterpret_cast<const float*>(st + 2 * C::KV_BYTES);
    const float* VSs = KSs + CH;
    const int c0 = start + c * CH;
    const int nvalid = min(CH, end - c0);

    {  // scores: s[r][sc] = q[r] . k[sc] (x the int8 K scale), -1e30 past the bound
      float kf[C::QD];
      lds_f32<T, C::QD>(reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(Ks) + sc * C::RS) +
                            qd * C::QD,
                        kf);
      const bool valid = sc < nvalid;
      const float ks = QUANT ? KSs[sc] : 1.f;
      for (int r0 = 0; r0 < R; r0 += 4) {  // four rows at a time: four independent sums
        const float4* qr[4];  // row r0 + i's float4s, quarter qd's j-th at 4 j + qd
#pragma unroll
        for (int i = 0; i < 4; ++i) qr[i] = reinterpret_cast<const float4*>(Qs + min(r0 + i, R - 1) * HD) + qd;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < C::QD; j += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 q = qr[i][j];  // float4 j / 4 of the quarter: slot 4 (j / 4) + qd
            s[i] = fmaf(q.x, kf[j], s[i]);
            s[i] = fmaf(q.y, kf[j + 1], s[i]);
            s[i] = fmaf(q.z, kf[j + 2], s[i]);
            s[i] = fmaf(q.w, kf[j + 3], s[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
        }
        // the lane of quarter qd writes row r0 + qd
        const float mine = qd == 0 ? s[0] : qd == 1 ? s[1] : qd == 2 ? s[2] : s[3];
        if (r0 + qd < R) Ps[(r0 + qd) * (CH + 1) + sc] = valid ? mine * ks : NEG;  // strictly pre-existing positions only
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += NT / 32) {  // online softmax, a warp per row
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
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[r] = Ls[r] * alpha + sm;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][cg*8 .. +8] = acc * alpha[r] + sum over positions of p[r][pos] * v[pos] (x the int8 V scale)
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      const int r = rg + nrg * i;
      const float alpha = r < R ? As[r] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] *= alpha;
    }
    for (int p = ps; p < nvalid; p += nps) {
      float vf[8];
      lds_f32<T, 8>(reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(Vs) + p * C::RS) + cg * 8, vf);
      const float vs = QUANT ? VSs[p] : 1.f;
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const int r = rg + nrg * i;
        if (r < R) {
          const float pr = Ps[r * (CH + 1) + p] * vs;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(pr, vf[k], acc[i][k]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to sum P V over the position splits

  float* red = reinterpret_cast<float*>(smem);  // [nps][R][HD]
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const int r = rg + nrg * i;
    if (r < R) {
#pragma unroll
      for (int k = 0; k < 8; ++k) red[((size_t)ps * R + r) * HD + cg * 8 + k] = acc[i][k];
    }
  }
  __syncthreads();
  float* ab = acc_out + out_row * HD;
  for (int e = tid; e < R * HD; e += NT) {
    float a = 0.f;
    for (int s = 0; s < nps; ++s) a += red[(size_t)s * R * HD + e];
    ab[e] = a;
  }
  for (int r = tid; r < R; r += NT) {
    m_out[out_row + r] = Ms[r];
    l_out[out_row + r] = Ls[r];
  }
}

// Folds the splits of each (lane, kv head) that hold data, in split order,
// with paged_kv._combine's formula, starting from the empty partial.
// Grid: (B * nkv, ceil(R * HD / NT)), R the kv head's rows (every tile's).
__global__ void __launch_bounds__(NT) paged_merge_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part, const float* __restrict__ acc_part,
    const int* __restrict__ bound, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int nkv, int R, int hd, int nsplit, int split_len, int max_len) {
  const int blk = blockIdx.x;
  const int e = blockIdx.y * NT + threadIdx.x;
  if (e >= R * hd) return;
  const int r = e / hd;
  const int nb = min(bound[blk / nkv], max_len);
  const int col = e - r * hd;
  const int held = (nb + split_len - 1) / split_len;  // splits that start below the bound
  float m = NEG, l = 0.f, a = 0.f;
  for (int s0 = 0; s0 < held; s0 += 8) {  // eight splits' loads in flight, then their folds in order
    float ms[8], ls[8], as[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t row = ((size_t)blk * nsplit + min(s0 + i, held - 1)) * R + r;
      ms[i] = m_part[row];
      ls[i] = l_part[row];
      as[i] = acc_part[row * hd + col];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (s0 + i < held) {
        const float mn = fmaxf(m, ms[i]);
        const float x1 = expf(m - mn), x2 = expf(ms[i] - mn);
        l = l * x1 + ls[i] * x2;
        a = a * x1 + as[i] * x2;
        m = mn;
      }
    }
  }
  const size_t row = (size_t)blk * R + r;
  acc_out[row * hd + col] = a;
  if (col == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename T, int HD, bool QUANT>
int launch(const void* qf, const void* pool_k, const void* pool_v, const void* tables, const void* bound,
           const void* k_scale, const void* v_scale, void* m, void* l, void* acc, void* m_part, void* l_part,
           void* acc_part, int B, int nkv, int R, int page, int max_pg, int pps, int nsplit, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err = hopper::set_smem_once(paged_partials_kernel<T, HD, QUANT>, smem_bytes<T, HD>(RT), smem_set);
  if (err != cudaSuccess) return (int)err;
  const bool merge = nsplit > 1;
  const int ntiles = (R + RT - 1) / RT;
  paged_partials_kernel<T, HD, QUANT><<<B * nkv * nsplit * ntiles, NT, smem_bytes<T, HD>(R < RT ? R : RT), stream>>>(
      static_cast<const float*>(qf), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(bound),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<float*>(merge ? m_part : m), static_cast<float*>(merge ? l_part : l),
      static_cast<float*>(merge ? acc_part : acc), nkv, R, page, max_pg, pps, nsplit, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  const dim3 grid(B * nkv, (R * HD + NT - 1) / NT);
  paged_merge_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part), static_cast<const float*>(acc_part),
      static_cast<const int*>(bound), static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      nkv, R, HD, nsplit, pps * page, max_pg * page);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(int pool_dtype, const void* qf, const void* pk, const void* pv, const void* tables,
             const void* bound, const void* ks, const void* vs, void* m, void* l, void* acc, void* mp, void* lp,
             void* ap, int B, int nkv, int R, int page, int max_pg, int pps, int nsplit, cudaStream_t st) {
  switch (pool_dtype) {
    case 0: return launch<float, HD, false>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, mp, lp, ap, B, nkv, R, page, max_pg, pps, nsplit, st);
    case 1: return launch<__nv_bfloat16, HD, false>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, mp, lp, ap, B, nkv, R, page, max_pg, pps, nsplit, st);
    case 2: return launch<int8_t, HD, true>(qf, pk, pv, tables, bound, ks, vs, m, l, acc, mp, lp, ap, B, nkv, R, page, max_pg, pps, nsplit, st);
    default: return -1;
  }
}

}  // namespace

// pool_dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// R = rep * T >= 1 rows per kv head, cut into ceil(R / 64) row tiles.
// pps: pages per split (1 .. 256), nsplit: splits per lane, with
// pps * nsplit >= max_pg; with nsplit > 1 the partials of each split go to
// m_part / l_part [B, nkv, nsplit, R] and acc_part [B, nkv, nsplit, R, hd]
// f32 (scratch) and a merge pass writes m, l, acc. Returns
// cudaGetLastError() after the launches (0 = launched), or -1 for a shape
// or type this kernel has no instance for.
extern "C" int rt_paged_partials(const void* qf, const void* pool_k, const void* pool_v,
                                 const void* tables, const void* bound,
                                 const void* k_scale, const void* v_scale,
                                 void* m, void* l, void* acc, void* m_part, void* l_part, void* acc_part,
                                 int B, int nkv, int R, int hd, int page, int max_pg, int pps, int nsplit,
                                 int pool_dtype, void* stream) {
  const long long blocks = (long long)B * nkv * nsplit * ((R + RT - 1) / RT);
  if (R < 1 || page < 1 || pps < 1 || pps > MAX_SPLIT_PAGES || nsplit < 1 || blocks > 0x7fffffffLL ||
      (long long)pps * nsplit < max_pg || (nsplit > 1 && (m_part == nullptr || l_part == nullptr || acc_part == nullptr ||
                                                          (long long)R * hd / NT >= 65535)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dispatch<128>(pool_dtype, qf, pool_k, pool_v, tables, bound, k_scale, v_scale, m, l, acc, m_part, l_part, acc_part, B, nkv, R, page, max_pg, pps, nsplit, st);
  if (hd == 64) return dispatch<64>(pool_dtype, qf, pool_k, pool_v, tables, bound, k_scale, v_scale, m, l, acc, m_part, l_part, acc_part, B, nkv, R, page, max_pg, pps, nsplit, st);
  return -1;
}
