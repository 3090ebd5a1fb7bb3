"""Elementwise, norm and embedding ops (port of ray_tpu/ops/layers.py).

Plain PyTorch: on the card these run as PyTorch's own kernels, as the
JAX package left them to XLA. The Pallas RMSNorm (``rms_norm_pallas``,
K5) is not on any ported path yet and stays queued in ROADMAP.md.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with cast back (llama convention)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]
