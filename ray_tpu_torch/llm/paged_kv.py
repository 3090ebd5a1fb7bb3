"""Block-table paged KV cache (port of ray_tpu/llm/paged_kv.py).

One page pool per layer stack, ``k, v: [L, num_pages, page, kv, hd]``
(int8 pools add ``k_scale, v_scale: [L, num_pages, kv, page]``). Page 0
is the trash page: table padding points at it, so writes for idle lanes
land somewhere harmless and reads from it are masked by length. A host
``PageAllocator`` owns the free list; the block table is host state
uploaded each step.

PyTorch runs eagerly and the pool is updated in place
(``index_put_``). The decode step and the prefix-cache extend still keep
the JAX order: the attention half only reads the pool, then the append
writes the new token(s), so the K4 kernel never reads a position being
written.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials, paged_attn_partials_ref
from ray_tpu_torch.llm.kv_quant import dequantize, is_int8, quantize_heads
from ray_tpu_torch.models.llama import torch_dtype

_NEG = -1e30  # -inf surrogate: keeps exp() NaN-free for fully-masked pages


@dataclass(frozen=True)
class PagedCacheConfig:
    num_layers: int
    num_pages: int  # total pool pages (page 0 reserved as trash)
    page_size: int
    max_pages_per_seq: int
    num_slots: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"  # bf16/f32, or "int8" (kv_quant.py)


def alloc(cfg: PagedCacheConfig, device) -> dict:
    shape = (cfg.num_layers, cfg.num_pages, cfg.page_size, cfg.num_kv_heads, cfg.head_dim)
    if is_int8(cfg.dtype):
        sshape = (cfg.num_layers, cfg.num_pages, cfg.num_kv_heads, cfg.page_size)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device), "v": torch.zeros(shape, dtype=dt, device=device)}


class PageAllocator:
    """Host-side free list over pages 1..num_pages-1 (0 = trash)."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))
        self.num_pages = num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = self._free[-n:]
        del self._free[-n:]
        return out

    def free(self, pages) -> None:
        for p in pages:
            if p:  # never recycle the trash page
                self._free.append(int(p))


def insert_pages(pool: dict, page_ids: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None) -> dict:
    """Write a prefilled sequence's K/V into its pages, in place.

    k_new/v_new: [L, T_pad, kv, hd] with T_pad == len(page_ids) * page;
    page_ids: [n_pg] int (padding entries = 0 -> trash). All four dtype
    directions, as ``kv_cache.insert_sequence``: an fp block into an int8
    pool quantizes here; an int8 block with ``k_scale``/``v_scale``
    [L, kv, T_pad] (the handoff wire layout) into an int8 pool copies
    bytes; int8 into an fp pool dequantizes; fp into fp copies."""
    L, T, kvh, hd = k_new.shape
    npg = page_ids.shape[0]
    page = pool["k"].shape[2]
    ids = page_ids.long()
    quant = "k_scale" in pool
    if not quant and k_scale is not None:  # int8 block -> fp pool
        k_new = dequantize(k_new, k_scale.transpose(1, 2))
        v_new = dequantize(v_new, v_scale.transpose(1, 2))
    if quant:
        if k_scale is None:  # fp block -> quantize on insert
            k_new, sk = quantize_heads(k_new)  # sk: [L, T, kv]
            v_new, sv = quantize_heads(v_new)
            k_scale, v_scale = sk.transpose(1, 2), sv.transpose(1, 2)
        # wire layout [L, kv, T] -> page-major [L, npg, kv, page]
        pool["k_scale"][:, ids] = k_scale.reshape(L, kvh, npg, page).transpose(1, 2).float()
        pool["v_scale"][:, ids] = v_scale.reshape(L, kvh, npg, page).transpose(1, 2).float()
    pool["k"][:, ids] = k_new.reshape(L, npg, page, kvh, hd).to(pool["k"].dtype)
    pool["v"][:, ids] = v_new.reshape(L, npg, page, kvh, hd).to(pool["v"].dtype)
    return pool


def gather_pages(pool: dict, page_ids: torch.Tensor):
    """A sequence's pages read back as one contiguous block, the inverse
    of ``insert_pages``: (k [L, n_pg * page, kv, hd], v same), plus
    (k_scale [L, kv, n_pg * page], v_scale same) for an int8 pool, the
    handoff wire layout. Padding entries of ``page_ids`` point at the
    trash page and give garbage that the consumer masks by length. Only
    reads the pool (the disaggregated prefill's extract, ``llm/disagg/``)."""
    L, _, page, kvh, hd = pool["k"].shape
    npg = page_ids.shape[0]
    ids = page_ids.long()
    k = pool["k"][:, ids].reshape(L, npg * page, kvh, hd)
    v = pool["v"][:, ids].reshape(L, npg * page, kvh, hd)
    if "k_scale" in pool:
        # [L, npg, kv, page] -> wire layout [L, kv, npg * page]
        k_sc = pool["k_scale"][:, ids].transpose(1, 2).reshape(L, kvh, npg * page)
        v_sc = pool["v_scale"][:, ids].transpose(1, 2).reshape(L, kvh, npg * page)
        return k, v, k_sc, v_sc
    return k, v


def _combine(m1, l1, a1, m2, l2, a2):
    """Merge two online-softmax partials (flash-attention combine)."""
    m = torch.maximum(m1, m2)
    x1 = torch.exp(m1 - m)
    x2 = torch.exp(m2 - m)
    return m, l1 * x1 + l2 * x2, a1 * x1[..., None] + a2 * x2[..., None]


def _paged_attn_batch(qg, pool_k_l, pool_v_l, table, lengths, scale, k_self, v_self,
                      k_scale_l=None, v_scale_l=None):
    """Attention of one query token per lane over its paged KV.

    qg: [B, nkv, rep, hd]; pool_*_l: [P, page, kv, hd] (one layer);
    table: [B, max_pg] int32; lengths: [B] int32 — the pool is read at
    CACHED positions 0..lengths[b]-1 only (K4, ``paged_attn_partials``),
    and the current token's K/V [B, kv, hd] are folded in from registers
    as a one-element softmax partial. Returns [B, nkv, rep, hd] f32."""
    qf = qg.float() * scale
    m, l, acc = paged_attn_partials(
        qf[:, :, :, None, :].contiguous(), pool_k_l, pool_v_l, table, lengths, k_scale_l, v_scale_l
    )
    m, l, acc = m[..., 0], l[..., 0], acc[..., 0, :]
    # m2 = s_self, l2 = exp(s_self - m2) = 1, acc2 = 1 * v_self
    s_self = torch.einsum("bgrh,bgh->bgr", qf, k_self.float())
    vs = v_self.float()[:, :, None, :].expand(acc.shape)
    m, l, acc = _combine(m, l, acc, s_self, torch.ones_like(s_self), vs)
    return acc / torch.clamp(l, min=1e-20)[..., None]


def _fold_chunk(qf, m, l, acc, k_chunk, v_chunk):
    """Fold a chunk's own K/V, attended causally from registers, into the
    prefix partials and normalise (the tail of ray_tpu's
    ``_paged_attn_seq_batch``, paged_kv.py:336-344, same einsums, mask
    and order). qf: [B, nkv, rep, T, hd] f32 pre-scaled; m, l: [B, nkv,
    rep, T]; acc: [..., hd]; k_chunk/v_chunk: [B, T, kv, hd]. Query t
    sees chunk positions 0..t. The scores are [B, nkv, rep, T, T] f32,
    as in ray_tpu: 512 MiB at T = 2048 for Llama-3-8B's 8 x 4 heads. The
    mask, shift and exp run in place on them (the same values as ray_tpu's
    where / subtract / exp), so the fold holds one such tensor, not three."""
    T = qf.shape[3]
    s_c = torch.einsum("bgrth,bugh->bgrtu", qf, k_chunk.float())
    ar = torch.arange(T, dtype=torch.int32, device=qf.device)
    s_c.masked_fill_(ar[None, :] > ar[:, None], _NEG)  # causal: key u <= query t
    m2 = s_c.amax(dim=-1)
    pe2 = s_c.sub_(m2[..., None]).exp_()
    l2 = pe2.sum(dim=-1)
    a2 = torch.einsum("bgrtu,bugh->bgrth", pe2, v_chunk.float())
    m, l, acc = _combine(m, l, acc, m2, l2, a2)
    return acc / torch.clamp(l, min=1e-20)[..., None]


def _paged_attn_seq(qg, pool_k_l, pool_v_l, table_row, start, k_chunk, v_chunk, scale,
                    k_scale_l=None, v_scale_l=None):
    """Attention of T query tokens of ONE sequence: a cached prefix
    (positions 0..start-1, read from pages) plus the chunk's own K/V
    attended causally from registers (port of ray_tpu's per-lane
    ``_paged_attn_seq``, its XLA oracle). The prefix half is always the
    plain page scan (``paged_attn_partials_ref``), on either device: the
    tests hold the batched kernel path against it.

    qg: [nkv, rep, T, hd]; table_row: [max_pg] int32; start: int or []
    int; k_chunk/v_chunk: [T, kv, hd]. Returns [nkv, rep, T, hd] f32."""
    qf = qg.float()[None] * scale
    bound = torch.as_tensor(start, dtype=torch.int32, device=qf.device).reshape(1)
    m, l, acc = paged_attn_partials_ref(qf, pool_k_l, pool_v_l, table_row[None], bound, k_scale_l, v_scale_l)
    return _fold_chunk(qf, m, l, acc, k_chunk[None], v_chunk[None])[0]


def _paged_attn_seq_batch(qg, pool_k_l, pool_v_l, tables, starts, k_chunk, v_chunk, scale,
                          k_scale_l=None, v_scale_l=None):
    """Lane-batched ``_paged_attn_seq``, the path: every lane's prefix
    pages below ``starts`` through K4 (``paged_attn_partials``: the kernel
    on the card, its plain version on the host), then the causal chunk
    folded from registers. The chunk was produced this call and is never
    read back from the pool (the aliasing contract of the decode step).

    qg: [B, nkv, rep, T, hd]; tables: [B, max_pg] int32; starts: [B]
    int32; k_chunk/v_chunk: [B, T, kv, hd]. Returns [B, nkv, rep, T, hd]
    f32."""
    qf = qg.float() * scale
    m, l, acc = paged_attn_partials(qf.contiguous(), pool_k_l, pool_v_l, tables, starts, k_scale_l, v_scale_l)
    return _fold_chunk(qf, m, l, acc, k_chunk, v_chunk)
