"""Flash attention forward: the K1 CUDA kernel and its plain version
(port of the forward half of ray_tpu/ops/flash_attention.py).

``flash_attention_fwd`` is the wrapper: for CUDA tensors it launches the
hand-written kernel ``csrc/flash_attention.cu`` (which indexes the GQA kv
head directly), for CPU tensors it runs ``attention_with_lse_ref``, the
op-for-op port of ``_fwd_xla_with_lse``. There is no other branch: an
input the kernel does not take raises.

Layout: [batch, heads, seq, head_dim]; k/v carry ``Hkv`` heads (GQA).
The backward kernels (K2, K3) and the autograd Function come with the
training slice.
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
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
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
    bf16 or f32, contiguous, any T) and count the launch in
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


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash attention with GQA (forward only). q: [B, H, T, D];
    k, v: [B, Hkv, T, D] -> o [B, H, T, D]."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
