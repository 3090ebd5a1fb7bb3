"""Int8 KV-cache quantization: per-head amax scales (port of
ray_tpu/llm/kv_quant.py).

Symmetric int8 with one f32 scale per (position, kv head):
``scale = amax(|x|, head_dim) / 127``, rounding half to even as jnp.round
does, so ``quantize_heads`` is byte-identical to the JAX version. Scale
tensors put the position axis last (``[..., kv_heads, S]``), the layout
the JAX pools use.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0

CACHE_DTYPES = {
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "float32": "float32",
    "f32": "float32",
    "int8": "int8",
}

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def is_int8(dtype) -> bool:
    return str(dtype) == "int8"


def normalize_cache_dtype(dtype: str) -> str:
    """Validated, canonical cache dtype string (raises ValueError)."""
    try:
        return CACHE_DTYPES[str(dtype).lower()]
    except KeyError:
        raise ValueError(f"cache_dtype must be one of {sorted(set(CACHE_DTYPES))}, got {dtype!r}") from None


def quantize_heads(x: torch.Tensor):
    """x: [..., hd] float -> (q int8 [..., hd], scale f32 [...]); all-zero
    vectors quantize to q=0, scale=0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # tensor operands on both sides of each divide: torch evaluates
    # ``scalar / tensor`` as a reciprocal times the scalar, and on the card
    # ``tensor / scalar`` as a product with the scalar's reciprocal, which
    # round differently from jnp's divide (and from each other)
    full = torch.full_like(amax, INT8_MAX)
    scale = amax / full
    inv = torch.where(amax > 0.0, full / torch.clamp(amax, min=1e-30), torch.zeros_like(amax))
    q = torch.clamp(torch.round(xf * inv[..., None]), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q int8 [..., hd] * scale f32 broadcast over hd -> f32 [..., hd]."""
    return q.float() * scale[..., None]


def bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int, dtype: str) -> int:
    """K+V cache bytes one token occupies, scales included."""
    if is_int8(dtype):
        return 2 * num_layers * num_kv_heads * (head_dim + 4)
    return 2 * num_layers * num_kv_heads * head_dim * _ITEMSIZE[str(dtype)]
