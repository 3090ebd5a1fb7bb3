"""Elementwise, norm, embedding and loss ops (port of ray_tpu/ops/layers.py).

Plain PyTorch: on the card these run as PyTorch's own kernels, as the
JAX package left them to XLA. The exception is ``rms_norm_fused``, the
port of the Pallas RMSNorm (``rms_norm_pallas``, K5): a hand-written CUDA
kernel (``csrc/rms_norm.cu``) whose plain version is ``rms_norm``. As in
``ray_tpu``, nothing on the model's path calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ray_tpu_torch import _kernels


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with cast back (llama convention)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


@functools.cache
def _rms_norm_fn():
    fn = _kernels.library("rms_norm").rt_rms_norm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_RMS_DTYPES = (torch.bfloat16, torch.float32)
_RMS_MAX_ROW_BYTES = 200 * 1024  # the block path stages the row in shared memory (227 KB a block)
_RMS_WARP_MAX_ROW_BYTES = 16 * 1024  # the warp path holds the row in registers: 512 bytes a lane


def rms_norm_plan(d: int, itemsize: int, aligned: bool) -> tuple[int, int]:
    """K5's launch path for rows of ``d`` elements of ``itemsize`` bytes:
    ``(2, nv)`` a warp per row, each lane holding ``nv`` 16-byte vectors (a
    power of two), for rows of at most 16 KB in whole vectors on 16-byte
    aligned pointers; else ``(1, 0)`` a block per row in 16-byte vectors,
    or ``(0, 0)`` element by element when the width is not a whole number
    of vectors or a pointer is not aligned (``csrc/rms_norm.cu``)."""
    per_vec = 16 // itemsize
    if not aligned or d % per_vec:
        return 0, 0
    if d * itemsize > _RMS_WARP_MAX_ROW_BYTES:
        return 1, 0
    per_lane = -(-(d // per_vec) // 32)
    return 2, 1 << (per_lane - 1).bit_length()


def rms_norm_fused(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm over the last axis, one device-memory round trip
    (port of ``rms_norm_pallas``). x: [..., d] bf16 or f32; weight: [d]
    bf16 or f32. Returns x's shape and dtype.

    CUDA tensors launch K5 (``csrc/rms_norm.cu``, on the path
    ``rms_norm_plan`` picks) and count it in ``rms_norm_fused.launches``;
    CPU tensors run ``rms_norm``."""
    if not x.is_cuda:
        return rms_norm(x, weight, eps)
    d = x.shape[-1]
    x_dtype, w_dtype = x.dtype, weight.dtype
    if x_dtype not in _RMS_DTYPES or w_dtype not in _RMS_DTYPES:
        raise TypeError(f"rms_norm_fused: dtypes x {x_dtype}, weight {w_dtype} are not bf16 or f32")
    if weight.device != x.device:
        raise ValueError("rms_norm_fused: x and weight must be on the same CUDA device")
    if weight.shape != (d,):
        raise ValueError(f"rms_norm_fused: weight shape {tuple(weight.shape)} != ({d},)")
    itemsize = x.element_size()
    if d == 0 or d * itemsize > _RMS_MAX_ROW_BYTES:
        raise ValueError(f"rms_norm_fused: row width {d} is empty or does not fit the kernel's shared-memory row")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm_fused: x and weight must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    x_ptr, w_ptr = x.data_ptr(), weight.data_ptr()
    path, nv = rms_norm_plan(d, itemsize, (x_ptr | w_ptr) % 16 == 0)
    err = _rms_norm_fn()(
        x_ptr, w_ptr, out.data_ptr(), rows, d, eps, x_dtype == torch.bfloat16, w_dtype == torch.bfloat16, path, nv,
        _kernels.stream_ptr(x.device),
    )
    _kernels.check_launch(err, "rms_norm_fused (K5)")
    rms_norm_fused.launches += 1
    return out


rms_norm_fused.launches = 0


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 10000.0, dtype=torch.float32):
    """RoPE cos/sin tables for integer positions [..., T] -> [..., T, head_dim/2]."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, D]; cos/sin: [B, T, D/2] or [T, D/2] (split-half rope)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0):
    """Token cross entropy in f32; labels -100 (any negative) or mask == 0
    are ignored. Mean over the valid tokens."""
    logits = logits.float()
    valid = labels >= 0 if mask is None else mask > 0
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe_labels[..., None].long())[..., 0]
    validf = valid.to(lse.dtype)
    loss = (lse - ll) * validf
    if z_loss > 0.0:
        loss = loss + z_loss * (lse * validf) ** 2
    denom = torch.clamp(valid.sum(), min=1)
    return loss.sum() / denom


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]
