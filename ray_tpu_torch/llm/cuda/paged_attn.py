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
ROWS = 64  # query rows per block: a kv head's rep * T rows are cut into ceil(R / ROWS) row tiles
CHUNK = 64  # positions per stage of the kernel's shared-memory ring
MAX_SPLIT_PAGES = 256  # table entries a split stages in shared memory
BLOCKS_PER_SM = 4  # split_plan's target: a few resident blocks per SM, two waves


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
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_tiles(R: int) -> int:
    """Row tiles of a kv head's ``R = rep * T`` query rows: one block each."""
    return -(-R // ROWS)


def split_plan(max_pg: int, page: int, lanes: int, sms: int) -> tuple[int, int]:
    """How K4 cuts each lane's ``max_pg`` table columns: ``(pps, nsplit)``,
    pages per split and splits per lane, one block per (lane, kv head,
    row tile, split) over ``lanes`` = B * nkv * ``row_tiles(R)``. The bound
    lives on the device, so the plan sees only shapes: enough splits for
    ``BLOCKS_PER_SM`` blocks on each of the ``sms`` SMs had every lane its
    full table, at least one kernel chunk of positions per split, at most
    ``MAX_SPLIT_PAGES`` pages. Row tiles count as lanes: an extend's
    hundreds of tiles fill the card unsplit, so its scratch stays at zero."""
    want = max(1, -(-BLOCKS_PER_SM * sms // max(lanes, 1)))
    pps = min(max(-(-max_pg // want), -(-CHUNK // page), 1), MAX_SPLIT_PAGES)
    return pps, max(1, -(-max_pg // pps))


_plan = functools.cache(split_plan)  # one plan per shape: the wrapper runs per layer and decode step


def _bad(what: str):
    return ValueError(f"paged_attn_partials: {what}")


def paged_attn_partials(qf, pool_k_l, pool_v_l, tables, bound, k_scale_l=None, v_scale_l=None):
    """Online-softmax partials of ``qf`` over each lane's paged prefix
    (positions ``0 .. bound[b]-1`` only). Same signature and outputs as
    ``ray_tpu.llm.pallas.paged_attn.paged_attn_partials``.

    CUDA tensors launch K4 (its partials kernel over ``split_plan``'s
    splits and ``row_tiles``' row tiles, then its merge kernel when there
    is more than one split) and
    count the call in ``paged_attn_partials.launches``; CPU tensors run the
    plain version. The three outputs are views of one allocation, which
    also holds the splits' scratch: this runs once per layer and decode
    step, so the host's cost per call is kept to a few tensor operations."""
    if not qf.is_cuda:
        return paged_attn_partials_ref(qf, pool_k_l, pool_v_l, tables, bound, k_scale_l, v_scale_l)
    if qf.dtype != torch.float32 or qf.dim() != 5 or not qf.is_contiguous():
        raise _bad("qf must be contiguous f32 [B, nkv, rep, T, hd]")
    B, nkv, rep, T, hd = qf.shape
    R = rep * T
    if hd != 64 and hd != 128:
        raise _bad(f"head_dim {hd} not in (64, 128)")
    if R < 1:
        raise _bad(f"rep * T = {R}: no query rows")
    pool_dtype = pool_k_l.dtype
    code = _POOL_CODES.get(pool_dtype)
    if code is None or pool_v_l.dtype != pool_dtype:
        raise _bad(f"pool dtype {pool_dtype} not f32/bf16/int8")
    pshape = pool_k_l.shape
    if len(pshape) != 4 or pool_v_l.shape != pshape or pshape[2] != nkv or pshape[3] != hd:
        raise _bad(f"pools must be [P, page, kv, hd] = [P, page, {nkv}, {hd}] and equal")
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != B:
        raise _bad("tables must be int32 [B, max_pg]")
    if bound.dtype != torch.int32 or bound.shape != (B,):
        raise _bad("bound must be int32 [B]")
    quant = code == 2
    if (k_scale_l is not None) != quant or (v_scale_l is not None) != quant:
        raise _bad("scales are given iff the pool is int8")
    device = qf.device
    tensors = (pool_k_l, pool_v_l, tables, bound, k_scale_l, v_scale_l) if quant else (pool_k_l, pool_v_l, tables, bound)
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise _bad("every input must be contiguous on qf's CUDA device")
    P, page = pshape[0], pshape[1]
    if quant:
        for sc in (k_scale_l, v_scale_l):
            if sc.dtype != torch.float32 or sc.shape != (P, nkv, page):
                raise _bad("scales must be f32 [P, kv, page]")
    q_ptr, k_ptr, v_ptr = qf.data_ptr(), pool_k_l.data_ptr(), pool_v_l.data_ptr()
    if (q_ptr | k_ptr | v_ptr) % 16:
        raise _bad("qf and the pool slices must be 16-byte aligned")
    max_pg = tables.shape[1]
    lanes = B * nkv
    pps, nsplit = _plan(max_pg, page, lanes * row_tiles(R), _sm_count(device.index))
    n = lanes * R  # rows of m and l
    parts = n * nsplit if nsplit > 1 else 0  # rows of each split's partials, the merge kernel's input
    buf = torch.empty(n * (hd + 2) + parts * (hd + 2), dtype=torch.float32, device=device)
    rows, strides = (B, nkv, rep, T), (nkv * R, R, T, 1)
    m = buf.as_strided(rows, strides)
    l = buf.as_strided(rows, strides, n)
    acc = buf.as_strided((*rows, hd), (nkv * R * hd, R * hd, T * hd, hd, 1), 2 * n)
    if lanes == 0:
        return m, l, acc
    base = buf.data_ptr()
    scratch = base + 4 * n * (hd + 2)
    err = _fn()(
        q_ptr, k_ptr, v_ptr, tables.data_ptr(), bound.data_ptr(),
        k_scale_l.data_ptr() if quant else None, v_scale_l.data_ptr() if quant else None,
        base, base + 4 * n, base + 8 * n,
        scratch if parts else None, scratch + 4 * parts if parts else None, scratch + 8 * parts if parts else None,
        B, nkv, R, hd, page, max_pg, pps, nsplit, code, _kernels.stream_ptr(device),
    )
    _kernels.check_launch(err, "paged_attn_partials (K4)")
    paged_attn_partials.launches += 1
    return m, l, acc


paged_attn_partials.launches = 0
