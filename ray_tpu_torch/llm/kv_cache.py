"""Slot-based KV cache (port of ray_tpu/llm/kv_cache.py).

One static cache per engine, a dict of stacked per-layer tensors

    k, v: [L, slots, max_seq_len, kv_heads, head_dim]
    length: [slots] int32   (tokens valid per slot; 0 = empty)

and for an int8 cache (``kv_quant.py``) the per-head f32 scales
``k_scale, v_scale: [L, slots, kv_heads, max_seq_len]``, position axis
last as in ray_tpu. A slot is one concurrent sequence: admission writes a
prefilled sequence at offset 0, decode appends one token per slot per
step at ``min(length, S - 1)``, every slot included (an empty slot's
write lands at or past its length, which attention masks, and a position
is always written before a later step reads it).

ray_tpu returns new arrays from donated ones; here every write is in
place, as ``paged_kv.insert_pages`` is, so the tensors keep their
addresses (a captured CUDA graph reads them there).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.llm.kv_quant import dequantize, is_int8, quantize_heads
from ray_tpu_torch.models.llama import torch_dtype


@dataclass(frozen=True)
class CacheConfig:
    num_layers: int
    num_slots: int
    max_seq_len: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"  # bf16/f32, or "int8" (kv_quant.py)


def alloc(cfg: CacheConfig, device) -> dict:
    shape = (cfg.num_layers, cfg.num_slots, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
    length = torch.zeros((cfg.num_slots,), dtype=torch.int32, device=device)
    if is_int8(cfg.dtype):
        sshape = (cfg.num_layers, cfg.num_slots, cfg.num_kv_heads, cfg.max_seq_len)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "length": length,
        }
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device), "v": torch.zeros(shape, dtype=dt, device=device),
            "length": length}


def insert_sequence(cache: dict, slot: int, k_new, v_new, length: int, k_scale=None, v_scale=None) -> dict:
    """Write a prefilled sequence into ``slot`` at offset 0, in place, and
    set the slot's length.

    k_new/v_new: [L, T_pad, kv, hd] (the padded tail is masked by
    ``length``). All four dtype directions: an fp block into an int8
    cache quantizes here; an int8 block with ``k_scale``/``v_scale``
    [L, kv, T_pad] (the handoff wire layout) into an int8 cache copies
    bytes; int8 into an fp cache dequantizes; fp into fp copies."""
    slot = int(slot)
    T = k_new.shape[1]
    quant = "k_scale" in cache
    if not quant and k_scale is not None:  # int8 block -> fp cache
        k_new = dequantize(k_new, k_scale.transpose(1, 2))
        v_new = dequantize(v_new, v_scale.transpose(1, 2))
    if quant:
        if k_scale is None:  # fp block -> quantize on insert
            k_new, sk = quantize_heads(k_new)  # sk: [L, T, kv]
            v_new, sv = quantize_heads(v_new)
            k_scale, v_scale = sk.transpose(1, 2), sv.transpose(1, 2)
        cache["k_scale"][:, slot, :, :T] = k_scale.float()
        cache["v_scale"][:, slot, :, :T] = v_scale.float()
    cache["k"][:, slot, :T] = k_new.to(cache["k"].dtype)
    cache["v"][:, slot, :T] = v_new.to(cache["v"].dtype)
    cache["length"][slot] = int(length)
    return cache


def _write_positions(lengths, S: int):
    """Where each slot's token lands: ``lengths`` clamped into [0, S-1], as
    ray_tpu's ``dynamic_update_slice`` clamps its start."""
    return torch.clamp(lengths.long(), 0, S - 1)


def append_token_layer(k_layer, v_layer, k_t, v_t, lengths):
    """Append one token's K/V per slot at position ``lengths[b]``, in place.

    k_layer/v_layer: [slots, S, kv, hd]; k_t/v_t: [slots, kv, hd]. Empty
    slots are written too (at their stale length), as in ray_tpu."""
    rows = torch.arange(k_layer.shape[0], device=k_layer.device)
    pos = _write_positions(lengths, k_layer.shape[1])
    k_layer[rows, pos] = k_t.to(k_layer.dtype)
    v_layer[rows, pos] = v_t.to(v_layer.dtype)
    return k_layer, v_layer


def append_scale_layer(scale_layer, s_t, lengths):
    """Scale companion of ``append_token_layer``, in place.
    scale_layer: [slots, kv, S]; s_t: [slots, kv]."""
    rows = torch.arange(scale_layer.shape[0], device=scale_layer.device)
    scale_layer[rows, :, _write_positions(lengths, scale_layer.shape[2])] = s_t.to(scale_layer.dtype)
    return scale_layer


def extract_sequence(cache: dict, slot: int, T: int):
    """One slot's first ``T`` positions as contiguous copies: (k [L, T, kv,
    hd], v same), plus (k_scale [L, kv, T], v_scale same) for an int8
    cache (the handoff wire layout). The inverse of ``insert_sequence``."""
    slot = int(slot)
    k = cache["k"][:, slot, :T].clone()
    v = cache["v"][:, slot, :T].clone()
    if "k_scale" in cache:
        return k, v, cache["k_scale"][:, slot, :, :T].clone(), cache["v_scale"][:, slot, :, :T].clone()
    return k, v


def free_slot(cache: dict, slot: int) -> dict:
    """Mark a slot empty, in place."""
    cache["length"][int(slot)] = 0
    return cache
