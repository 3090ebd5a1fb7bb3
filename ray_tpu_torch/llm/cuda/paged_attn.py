"""Paged-attention softmax partials: the K4 CUDA kernel and its plain
version (port of ray_tpu/llm/pallas/paged_attn.py).

``paged_attn_partials`` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/paged_attn.cu``; CPU tensors run
``paged_attn_partials_ref``, the op-for-op port of the XLA page scan
(ray_tpu/llm/paged_kv.py:218-240) with the same masks, the same ``_NEG``
surrogate and the same order. Nothing else: an input the kernel does not
take raises.

One known difference, documented in the kernel source: for a lane with
``bound == 0`` the plain version (like the TPU kernel) visits every table
page and ends with ``l = max_pg * page`` and ``acc`` = those pages' V sum,
while the kernel visits none and returns ``l = acc = 0``. ``m`` agrees
everywhere, and the caller's combined output (``paged_kv._paged_attn_batch``)
agrees at every bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _kernels

_NEG = -1e30  # paged_kv._NEG; repeated here so the kernel module stands alone

_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_ROWS = 64  # rep * T the kernel holds per kv head


def paged_attn_partials_ref(qf, pool_k_l, pool_v_l, tables, bound, k_scale_l=None, v_scale_l=None):
    """Plain version of K4: the page scan over every table column.

    qf: [B, nkv, rep, T, hd] f32, pre-scaled; pool_*_l: [P, page, kv, hd];
    tables: [B, max_pg] int; bound: [B] int; k_scale_l/v_scale_l:
    [P, kv, page] f32 (int8 pools). Returns (m, l [B, nkv, rep, T],
    acc [B, nkv, rep, T, hd]) f32."""
    B, nkv, rep, T, hd = qf.shape
    page = pool_k_l.shape[1]
    max_pg = tables.shape[1]
    dev = qf.device
    m = torch.full((B, nkv, rep, T), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nkv, rep, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nkv, rep, T, hd), dtype=torch.float32, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    bound = bound.to(dev)
    for p in range(max_pg):
        pids = tables[:, p].long()
        kp = pool_k_l[pids].float()  # [B, page, kv, hd]
        vp = pool_v_l[pids].float()
        if k_scale_l is not None:
            kp = kp * k_scale_l[pids].transpose(1, 2)[..., None]  # [B, page, kv, 1]
            vp = vp * v_scale_l[pids].transpose(1, 2)[..., None]
        s = torch.einsum("bgrth,bpgh->bgrtp", qf, kp)
        pos = p * page + torch.arange(page, dtype=torch.int32, device=dev)
        ok = pos[None, :] < bound[:, None]  # [B, page] strictly pre-existing
        s = torch.where(ok[:, None, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrtp,bpgh->bgrth", pexp, vp)
        m = m_new
    return m, l, acc


@functools.cache
def _fn():
    lib = _kernels.library("paged_attn")
    fn = lib.rt_paged_partials
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"paged_attn_partials: {what}")


def paged_attn_partials(qf, pool_k_l, pool_v_l, tables, bound, k_scale_l=None, v_scale_l=None):
    """Online-softmax partials of ``qf`` over each lane's paged prefix
    (positions ``0 .. bound[b]-1`` only). Same signature and outputs as
    ``ray_tpu.llm.pallas.paged_attn.paged_attn_partials``.

    CUDA tensors launch K4 and count it in ``paged_attn_partials.launches``;
    CPU tensors run the plain version."""
    if not qf.is_cuda:
        return paged_attn_partials_ref(qf, pool_k_l, pool_v_l, tables, bound, k_scale_l, v_scale_l)
    _check(qf.dtype == torch.float32 and qf.dim() == 5 and qf.is_contiguous(), "qf must be contiguous f32 [B, nkv, rep, T, hd]")
    B, nkv, rep, T, hd = qf.shape
    R = rep * T
    _check(hd in (64, 128), f"head_dim {hd} not in (64, 128)")
    _check(1 <= R <= MAX_ROWS, f"rep * T = {R} outside 1..{MAX_ROWS}")
    _check(pool_k_l.dtype in _POOL_CODES and pool_v_l.dtype == pool_k_l.dtype, f"pool dtype {pool_k_l.dtype} not f32/bf16/int8")
    _check(pool_k_l.dim() == 4 and pool_k_l.shape == pool_v_l.shape, "pools must be [P, page, kv, hd] and equal")
    P, page = pool_k_l.shape[:2]
    _check(tuple(pool_k_l.shape[2:]) == (nkv, hd), f"pool heads {tuple(pool_k_l.shape[2:])} != ({nkv}, {hd})")
    _check(tables.dtype == torch.int32 and tables.dim() == 2 and tables.shape[0] == B, "tables must be int32 [B, max_pg]")
    _check(bound.dtype == torch.int32 and tuple(bound.shape) == (B,), "bound must be int32 [B]")
    quant = pool_k_l.dtype == torch.int8
    _check((k_scale_l is not None) == quant and (v_scale_l is not None) == quant, "scales are given iff the pool is int8")
    tensors = [qf, pool_k_l, pool_v_l, tables, bound]
    if quant:
        for sc in (k_scale_l, v_scale_l):
            _check(sc.dtype == torch.float32 and tuple(sc.shape) == (P, nkv, page), "scales must be f32 [P, kv, page]")
        tensors += [k_scale_l, v_scale_l]
    for t in tensors:
        _check(t.is_cuda and t.device == qf.device and t.is_contiguous(), "every input must be contiguous on qf's CUDA device")
    _check(pool_k_l.data_ptr() % 16 == 0 and pool_v_l.data_ptr() % 16 == 0, "pool slices must be 16-byte aligned")
    m = torch.empty((B, nkv, rep, T), dtype=torch.float32, device=qf.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, nkv, rep, T, hd), dtype=torch.float32, device=qf.device)
    if B * nkv == 0:
        return m, l, acc
    err = _fn()(
        qf.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr(), tables.data_ptr(), bound.data_ptr(),
        k_scale_l.data_ptr() if quant else None, v_scale_l.data_ptr() if quant else None,
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        B, nkv, R, hd, page, tables.shape[1], _POOL_CODES[pool_k_l.dtype],
        _kernels.stream_ptr(qf.device),
    )
    _kernels.check_launch(err, "paged_attn_partials (K4)")
    paged_attn_partials.launches += 1
    return m, l, acc


paged_attn_partials.launches = 0
