"""Wire quantize and dequantize of published prefix blocks (port of
ray_tpu/llm/kvplane/quant.py, torch ops in place of its jitted programs).

An int8-cache replica publishes its prefix blocks in the int8 handoff wire
format (values and [L, kv, T] per-head scales: about half the bytes of a
bf16 block), while its local ``PrefixCache`` holds the prefill's fp
output. These two functions bridge the formats on the publish and
remote-hit paths:

- ``wire_quantize``: fp block -> (int8 values, wire-layout scales), the
  exact ``kv_quant.quantize_heads`` recipe the inserts use, so the bytes a
  remote int8 consumer scatters in equal what its own local prefill would
  have written;
- ``wire_dequantize``: int8 wire block -> fp block at the consumer's
  compute dtype, for re-storing a fetched remote prefix in the local
  ``PrefixCache`` (whose entries are fp).

They run on whichever device their inputs are on.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.llm.kv_quant import dequantize, quantize_heads
from ray_tpu_torch.models.llama import torch_dtype


def wire_quantize(k_blk: torch.Tensor, v_blk: torch.Tensor):
    """[L, T, kv, hd] fp twins -> (k int8, v int8, k_scale [L, kv, T] f32,
    v_scale) in the handoff wire layout (position axis last)."""
    kq, ks = quantize_heads(k_blk)  # scales [L, T, kv]
    vq, vs = quantize_heads(v_blk)
    return kq, vq, ks.transpose(1, 2).float().contiguous(), vs.transpose(1, 2).float().contiguous()


def wire_dequantize(k_blk, v_blk, k_scale, v_scale, dtype: str = "float32"):
    """Int8 wire block + [L, kv, T] scales -> fp twins at ``dtype`` (the
    consumer's compute dtype)."""
    dt = torch_dtype(dtype)
    k = dequantize(k_blk, k_scale.transpose(1, 2)).to(dt)
    v = dequantize(v_blk, v_scale.transpose(1, 2)).to(dt)
    return k, v


def make_wire_fns():
    """The (quantize, dequantize) pair a plane client uses."""
    return wire_quantize, wire_dequantize
