"""Flash attention: the K1 (forward), K2 (dQ) and K3 (dK/dV) CUDA kernels,
their plain versions and the autograd Function that joins them (port of
ray_tpu/ops/flash_attention.py without the chunked ring-attention path).

Each wrapper launches its hand-written kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no other branch, and an input
the kernel does not take raises:

- ``flash_attention_fwd``: K1 (``csrc/flash_attention.cu``); plain
  version ``attention_with_lse_ref``, the port of ``_fwd_xla_with_lse``.
- ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``: K2 and K3
  (``csrc/flash_attention_bwd.cu``), called together by
  ``flash_attention_bwd`` with a caller-supplied delta as
  ``_bwd_pallas_with_delta`` is; plain version ``attention_bwd_ref``, the
  port of ``_bwd_xla``.
- ``flash_attention``: ``FlashAttention``, the ``custom_vjp`` of the JAX
  package as a ``torch.autograd.Function``; the same code runs on both
  devices, so the CPU tests run what the card runs.

Layout: [batch, heads, seq, head_dim]; k/v carry ``Hkv`` heads (GQA).
The plain versions compute in f32, or in f64 for f64 inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _kernels

_NEG_INF = -1e30


def _broadcast_kv(q, k, v):
    """Repeat kv heads to q's head count (head h reads kv head h // rep)."""
    H, Hkv = q.shape[1], k.shape[1]
    if H != Hkv:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _f32(x):
    """x promoted to at least f32 (the f32 softmax; f64 stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _apply_masks(logits, causal: bool):
    Tq, Tk = logits.shape[-2:]
    if causal:
        qi = torch.arange(Tq, device=logits.device)[:, None]
        ki = torch.arange(Tk, device=logits.device)[None, :]
        logits = torch.where((ki <= qi)[None, None], logits, torch.full((), _NEG_INF, device=logits.device))
    return logits


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain attention with an f32 softmax (port of ``attention_xla``).
    q, k, v: [B, H, T, D] with the kv heads already broadcast."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(_apply_masks(logits, causal), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attention_with_lse_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain version of K1 (port of ``_fwd_xla_with_lse``, GQA broadcast
    included). Returns (o [B, H, T, D] in v's dtype, lse [B, H, T] f32)."""
    k, v = _broadcast_kv(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", _f32(q), _f32(k)) * scale
    logits = _apply_masks(logits, causal)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v), lse


@functools.cache
def _fn():
    lib = _kernels.library("flash_attention")
    fn = lib.rt_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash-attention forward. q: [B, H, T, D]; k, v: [B, Hkv, T, D].
    Returns (o [B, H, T, D] in q's dtype, lse [B, H, T] f32).

    CUDA tensors launch K1 (``csrc/flash_attention.cu``; D in {64, 128},
    bf16 or f32, contiguous, any T; bf16 runs on wgmma with TMA-fed tiles and
    needs 16-byte aligned q, k and v) and count the launch in
    ``flash_attention_fwd.launches``; CPU tensors run the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_with_lse_ref(q, k, v, causal, scale)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_fwd: dtype {q.dtype} is not bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd: q, k and v must share one dtype")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention_fwd: q, k and v must be on the same CUDA device")
    if D not in (64, 128):
        raise ValueError(f"flash_attention_fwd: head_dim {D} not in (64, 128)")
    if Hkv == 0 or H % Hkv or tuple(k.shape) != (B, Hkv, T, D) or tuple(v.shape) != (B, Hkv, T, D):
        raise ValueError(f"flash_attention_fwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: bf16 q, k and v must start 16-byte aligned (TMA)")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, Hkv, T, D, int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16),
        _kernels.stream_ptr(q.device),
    )
    _kernels.check_launch(err, "flash_attention_fwd (K1)")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _bwd_ref_with_delta(q, k, v, g, lse, delta, causal: bool, scale: float):
    """The backward of ``_bwd_xla`` with delta given: f32 (dq, dk, dv) at
    q's H heads. k, v may carry Hkv heads; they are broadcast first."""
    k, v = _broadcast_kv(q, k, v)
    logits = _apply_masks(torch.einsum("bhqd,bhkd->bhqk", _f32(q), _f32(k)) * scale, causal)
    p = torch.exp(logits - lse[..., None])
    del logits  # the [T, T] intermediates are freed as soon as they are used
    g32 = _f32(g)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g32)
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, _f32(v))
    ds = p * (dp - delta[..., None])
    del p, dp
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _f32(k)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _f32(q)) * scale
    return dq, dk, dv


def attention_bwd_ref(q, k, v, o, lse, g, causal: bool = True, scale: float | None = None):
    """Plain attention backward (op-for-op port of ``_bwd_xla``): from the
    forward's o and f32 lse and the output gradient g, the f32 (dq, dk, dv)
    at q's H heads (dk, dv not yet summed over the GQA rep heads)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = (_f32(g) * _f32(o)).sum(-1)
    return _bwd_ref_with_delta(q, k, v, g, lse, delta, causal, scale)


def _sum_rep(x, hkv: int):
    """[B, H, T, D] -> [B, Hkv, T, D], summing each kv head's rep q heads."""
    B, H = x.shape[:2]
    return x.reshape(B, hkv, H // hkv, *x.shape[2:]).sum(2) if H != hkv else x


@functools.cache
def _bwd_fns():
    lib = _kernels.library("flash_attention_bwd")
    dq, dkv = lib.rt_flash_bwd_dq, lib.rt_flash_bwd_dkv
    tail = [ctypes.c_int] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 7 + tail
    dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _check_bwd(what, q, k, v, g, lse, delta):
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {q.dtype} is not bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype or g.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v and g must share one dtype")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{what}: lse and delta must be f32")
    if not all(t.is_cuda and t.device == q.device for t in (k, v, g, lse, delta)):
        raise ValueError(f"{what}: every input must be on q's CUDA device")
    if D not in (64, 128):
        raise ValueError(f"{what}: head_dim {D} not in (64, 128)")
    if (Hkv == 0 or H % Hkv or tuple(k.shape) != (B, Hkv, T, D) or tuple(v.shape) != (B, Hkv, T, D)
            or g.shape != q.shape or tuple(lse.shape) != (B, H, T) or tuple(delta.shape) != (B, H, T)):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"g {tuple(g.shape)} lse {tuple(lse.shape)} delta {tuple(delta.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, g, lse, delta)):
        raise ValueError(f"{what}: q, k, v, g, lse and delta must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError(f"{what}: bf16 q, k, v and g must start 16-byte aligned (TMA)")
    return B, H, Hkv, T, D


def flash_attention_bwd_dq(q, k, v, g, lse, delta, causal: bool = True, scale: float | None = None):
    """dQ of flash attention (port of ``_bwd_dq_kernel``). q, g: [B, H, T, D];
    k, v: [B, Hkv, T, D]; lse, delta: [B, H, T] f32. Returns dq in q's dtype.

    CUDA tensors launch K2 (``csrc/flash_attention_bwd.cu``; D in {64, 128},
    bf16 or f32, contiguous, any T; bf16 runs on wgmma with TMA-fed tiles,
    rounds dS to bf16 for the dS K product and needs 16-byte aligned q, k, v
    and g; f32 runs on the CUDA cores) and count it in
    ``flash_attention_bwd_dq.launches``; CPU tensors run the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return _bwd_ref_with_delta(q, k, v, g, lse, delta, causal, scale)[0].to(q.dtype)
    B, H, Hkv, T, D = _check_bwd("flash_attention_bwd_dq", q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    err = _bwd_fns()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, Hkv, T, D, int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16),
        _kernels.stream_ptr(q.device),
    )
    _kernels.check_launch(err, "flash_attention_bwd_dq (K2)")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal: bool = True, scale: float | None = None):
    """dK and dV of flash attention at the kv heads (port of
    ``_bwd_dkv_kernel`` plus ``_flash_bwd``'s sum over the GQA rep heads).
    Returns (dk, dv) [B, Hkv, T, D] in k's and v's dtype.

    CUDA tensors launch K3 (``csrc/flash_attention_bwd.cu``, which sums the
    rep heads in f32 inside the kernel; the same inputs as K2: bf16 runs on
    wgmma with TMA-fed tiles, rounds P and dS to bf16 for the accumulate
    products and needs 16-byte aligned q, k, v and g; f32 runs on the CUDA
    cores) and count it in ``flash_attention_bwd_dkv.launches``; CPU tensors
    run the plain version, summed over rep and cast as ``_flash_bwd`` does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        _, dk, dv = _bwd_ref_with_delta(q, k, v, g, lse, delta, causal, scale)
        Hkv = k.shape[1]
        return _sum_rep(dk, Hkv).to(k.dtype), _sum_rep(dv, Hkv).to(v.dtype)
    B, H, Hkv, T, D = _check_bwd("flash_attention_bwd_dkv", q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    err = _bwd_fns()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        B, H, Hkv, T, D, int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16),
        _kernels.stream_ptr(q.device),
    )
    _kernels.check_launch(err, "flash_attention_bwd_dkv (K3)")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, g, lse, delta, causal: bool = True, scale: float | None = None):
    """Flash-attention backward with a caller-supplied delta = rowsum(g * o)
    in f32, as ``_bwd_pallas_with_delta`` takes it (ring attention will
    reuse one delta across its steps). Returns (dq, dk, dv) with dk, dv at
    the kv heads, each in its input's dtype: K2 then K3 on the card."""
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention``'s custom VJP (``_flash_fwd`` / ``_flash_bwd``).
    Forward: K1, saving q, k, v, o and lse as JAX does. Backward: delta in
    f32 from the incoming gradient and o, then K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()  # dO arrives through the caller's transpose of o
        delta = (_f32(g) * _f32(o)).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, g, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash attention with GQA, differentiable. q: [B, H, T, D];
    k, v: [B, Hkv, T, D] -> o [B, H, T, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, scale)
