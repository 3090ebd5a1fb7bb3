"""Cache-aware Llama forward passes: batched prefill, then decode and
the prefix-cache extend over either KV layout (port of
ray_tpu/llm/model_runner.py).

Same parameter tree as ``models/llama.py``. Prefill runs the causal
flash path (K1) over right-padded prompts and returns every layer's K/V
for insertion into pages. Paged decode advances every slot one token in
two halves, as in JAX: ``decode_attn_paged`` only reads the pool (K4 over
cached positions, the current token folded from registers), then
``append_paged`` writes the new token in place. The extend (a prompt's
suffix over a cached prefix) has the same two halves:
``extend_attn_paged`` (K4 over the prefix pages, the suffix causally
from registers), then ``append_chunk_paged``.

The device-resident loop's step is ``paged_fused_step`` (the attention
half plus ``sample`` and the write targets, no host read) then
``append_paged``, as ``make_fused_paged_fns`` returns them; the
scheduler changes the lanes between steps with the in-place deltas
``set_lane``, ``set_table`` and ``set_table_cell``, so the step's input
tensors keep their addresses (a captured CUDA graph reads them there).

The slot layout (``kv_cache.py``) has no page gather and no kernel:
``decode_step`` appends each slot's token in place first, then attends
over the whole static cache with ray_tpu's mask (``-inf`` past each
slot's length, then softmax), its products ``torch.matmul`` in f32, an
int8 cache quantized on append and dequantized for attention as in
ray_tpu. ``extend`` is the same for one slot's suffix over its cached
prefix. The device-resident step is ``fused_step`` (decode, ``sample``;
the cache's length lane advances inside ``decode_step``).

Tensor parallelism (``tpc``, a ``TpSpec``): every forward takes it and
then runs as one rank's shard in a rank process (``parallel/ranks.py``;
ray_tpu runs the same bodies under ``shard_map``): ``cfg`` is the
per-rank view (``_shard_cfg``: the rank's heads and kv heads), the
weights and the cache hold the rank's columns, rows and kv heads, the
attention-out and MLP-out partial sums are all-reduced after each layer
(``_tp_reduce``: the exact sum, or ``collective/ici.quantized_psum`` when
the collective is "int8"), the embedding is a masked local lookup plus
one fp sum a forward (``_tp_embed``) and the vocab-sharded logits are
all-gathered in fp (``_tp_gather_logits``), so every rank samples the
whole distribution. ray_tpu runs its prefill and extend at a mesh
through GSPMD; here they run per rank with the same sums, K1 and K4 on
the rank's heads. ``tpc=None`` is the single-device forward, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import LlamaConfig, attention, layer_params, unembed_f32
from ray_tpu_torch.ops.layers import apply_rope, rms_norm, rotary_embedding
from ray_tpu_torch.llm.kv_cache import append_scale_layer, append_token_layer
from ray_tpu_torch.llm.kv_quant import quantize_heads
from ray_tpu_torch.llm.paged_kv import _paged_attn_batch, _paged_attn_seq_batch
from ray_tpu_torch.llm.sampling import sample


@dataclass(frozen=True)
class TpSpec:
    """The tensor-parallel axis a rank's forward runs over: its group
    (``parallel.ranks.RankGroup``) and the per-layer collective, "fp"
    (the exact sum) or "int8" (``collective/ici.quantized_psum``)."""

    group: object = None
    collective: str = "fp"

    @property
    def rank(self) -> int:
        return self.group.rank


def _tp_reduce(x, tpc: TpSpec | None):
    """The per-layer all-reduce of the attention-out and MLP-out partials."""
    if tpc is None:
        return x
    from ray_tpu_torch.collective import ici

    if tpc.collective == "int8":
        return ici.quantized_psum(x, tpc.group)
    return ici.psum(x.contiguous(), tpc.group)


def _tp_embed(embed, tokens, tpc: TpSpec | None):
    """Token lookup: against a vocab-row-sharded embedding each rank
    gathers its rows (clipped), zeroes the tokens outside them, and one fp
    sum assembles the vectors (once a forward, so it stays full precision
    in both collective modes)."""
    if tpc is None:
        return embed[tokens]
    from ray_tpu_torch.collective import ici

    v_loc = embed.shape[0]
    loc = tokens - tpc.rank * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    x = embed[torch.clamp(loc, 0, v_loc - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return ici.psum(x.contiguous(), tpc.group)


def _tp_gather_logits(logits, tpc: TpSpec | None):
    """Vocab-sharded logits -> the whole vocab on every rank (fp all-gather
    in both modes: the sampler needs the full distribution)."""
    if tpc is None:
        return logits
    from ray_tpu_torch.collective import ici

    return ici.all_gather(logits, tpc.group, axis=-1)


def _shard_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """One rank's view of the model config: head counts divided by tp (the
    rank's weights carry the divided dims), head_dim pinned so ``hd``
    stops deriving it from hidden / num_heads."""
    return replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp, head_dim=cfg.hd)


def _tp_of(cfg: LlamaConfig, mesh, tp_collective: str, group):
    """(the rank's cfg, its TpSpec) for a pure tp mesh of size > 1 and the
    rank's group; (cfg, None) without a mesh or at tp=1. A mesh with other
    axes is not ported (ray_tpu runs it through GSPMD)."""
    if mesh is None:
        return cfg, None
    from ray_tpu_torch.parallel.mesh import axis_size, is_tp_only

    if not is_tp_only(mesh):
        raise NotImplementedError(f"a serving mesh with axes {tuple(mesh.axis_names)} (any axis besides tp) is not "
                                  "ported to ray_tpu_torch yet (ROADMAP.md, queue 1, multi-device axes)")
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return cfg, None
    if group is None or group.size != tp:
        raise ValueError(f"a tp={tp} step runs in a rank process and needs that rank's group of {tp}")
    return _shard_cfg(cfg, tp), TpSpec(group, tp_collective)


def _attn_scale(hd: int) -> float:
    """1 / sqrt(hd) rounded as ray_tpu computes it in f32, as a Python
    float: no host-to-device copy per call (none may run inside a CUDA
    graph's capture), and the same f32 value on the device."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _sqrt_hd(hd: int) -> float:
    """sqrt(hd) in f32, the slot attention's divisor (ray_tpu divides the
    scores by ``jnp.sqrt(hd)``), as a Python float of that value."""
    return float(np.sqrt(np.float32(hd)))


def _qkv(xn, layer, cfg: LlamaConfig):
    B, T, _ = xn.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (xn @ layer["wq"]).reshape(B, T, nh, hd)
    k = (xn @ layer["wk"]).reshape(B, T, nkv, hd)
    v = (xn @ layer["wv"]).reshape(B, T, nkv, hd)
    return q, k, v


def _mlp(x, layer, cfg: LlamaConfig, tpc: TpSpec | None = None):
    xn = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    return x + _tp_reduce((F.silu(xn @ layer["w_gate"]) * (xn @ layer["w_up"])) @ layer["w_down"], tpc)


@torch.no_grad()
def prefill(params, tokens, length, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """Run right-padded prompts through the model.

    tokens: [B, T_pad] int; length: [B] int real lengths. Returns
    (logits [B, vocab] f32 at each row's last real token,
    k [L, B, T_pad, kv, hd], v same). Padded positions produce K/V that
    later attention masks out by length."""
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    cos, sin = rotary_embedding(positions, cfg.hd, cfg.rope_theta)
    x = _tp_embed(params["embed"], tokens, tpc)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(xn, layer, cfg)
        qh = apply_rope(q.transpose(1, 2), cos, sin)
        kh = apply_rope(k.transpose(1, 2), cos, sin)
        o = attention(qh, kh, v.transpose(1, 2).contiguous(), cfg)
        o = o.transpose(1, 2).reshape(B, T, cfg.num_heads * cfg.hd)
        x = x + _tp_reduce(o @ layer["wo"], tpc)
        x = _mlp(x, layer, cfg, tpc)
        ks.append(kh.transpose(1, 2))  # the cache stores rope'd keys
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    # only the last real token's logits matter: gather before the unembed
    idx = (length.long() - 1).to(x.device)
    x_last = x[torch.arange(B, device=x.device), idx]
    return _tp_gather_logits(unembed_f32(x_last, params, cfg), tpc), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_attn_paged(params, pool, tables, lengths, tokens, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """READ-ONLY half of the paged decode step: attention over the cached
    pages (K4) plus the current token's K/V in registers. Returns
    (logits [slots, vocab] f32, k_new [L, slots, kv, hd], v_new same)."""
    B = tokens.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in pool
    cos, sin = rotary_embedding(lengths[:, None], hd, cfg.rope_theta)
    x = _tp_embed(params["embed"], tokens[:, None], tpc)  # [B, 1, H]
    scale = _attn_scale(hd)
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [B, 1, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin).transpose(1, 2)
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)
        qg = qh[:, 0].reshape(B, nkv, rep, hd)
        k_sc = pool["k_scale"][i] if quant else None
        v_sc = pool["v_scale"][i] if quant else None
        o = _paged_attn_batch(qg, pool["k"][i], pool["v"][i], tables, lengths, scale,
                              kh[:, 0], v_t[:, 0], k_sc, v_sc)
        o = o.reshape(B, 1, nh * hd).to(x.dtype)
        x = x + _tp_reduce(o @ layer["wo"], tpc)
        x = _mlp(x, layer, cfg, tpc)
        k_new.append(kh[:, 0])
        v_new.append(v_t[:, 0])
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps)
    return _tp_gather_logits(unembed_f32(x, params, cfg), tpc), torch.stack(k_new), torch.stack(v_new)


@torch.no_grad()
def append_paged(pool, write_page, write_off, k_new, v_new):
    """Write half of the paged decode step, in place: each slot's new
    token K/V at (write_page[b], write_off[b]) for every layer. An int8
    pool quantizes here."""
    wp, wo = write_page.long(), write_off.long()
    if "k_scale" in pool:
        k_new, sk = quantize_heads(k_new)  # [L, B, kv, hd] i8, [L, B, kv] f32
        v_new, sv = quantize_heads(v_new)
        # scale layout [L, P, kv, page]: the advanced indices are split by
        # the kv slice, so the indexed view is [B, L, kv]
        pool["k_scale"][:, wp, :, wo] = sk.transpose(0, 1)
        pool["v_scale"][:, wp, :, wo] = sv.transpose(0, 1)
    pool["k"][:, wp, wo] = k_new.to(pool["k"].dtype)
    pool["v"][:, wp, wo] = v_new.to(pool["v"].dtype)
    return pool


def decode_write_targets(tables, lengths, page: int):
    """(write_page [B], write_off [B]) for each slot's next token (the
    last table column for rows past the table edge)."""
    B = lengths.shape[0]
    page_ix = torch.clamp(lengths.long() // page, max=tables.shape[1] - 1)
    write_page = tables[torch.arange(B, device=tables.device), page_ix]
    return write_page, lengths % page


def decode_step_paged(params, pool, tables, lengths, tokens, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """Attention half, then append half. Returns (logits, pool, lengths + 1);
    the pool is updated in place."""
    write_page, write_off = decode_write_targets(tables, lengths, pool["k"].shape[2])
    logits, k_new, v_new = decode_attn_paged(params, pool, tables, lengths, tokens, cfg, tpc)
    pool = append_paged(pool, write_page, write_off, k_new, v_new)
    return logits, pool, lengths + 1


@torch.no_grad()
def paged_fused_step(params, pool, tables, lengths, tokens, keys, temps, top_k, top_p, cfg: LlamaConfig,
                     tpc: TpSpec | None = None):
    """READ-ONLY half of the device-resident paged step: the write
    targets, the attention half (``decode_attn_paged``) and ``sample``,
    with no host read. Returns ray_tpu's 11 outputs: (tokens [B],
    logprobs [B], new keys [B, 2], k_new, v_new [L, B, kv, hd], write_page,
    write_off [B], lengths + 1, temps, top_k, top_p); the sampling lanes
    pass through unchanged. The pool write is ``append_paged``. With
    ``tpc`` every rank samples the gathered logits from the same keys, so
    the lanes stay equal on every rank."""
    write_page, write_off = decode_write_targets(tables, lengths, pool["k"].shape[2])
    logits, k_new, v_new = decode_attn_paged(params, pool, tables, lengths, tokens, cfg, tpc)
    toks, logps, new_keys = sample(logits, keys, temps, top_k, top_p)
    return toks, logps, new_keys, k_new, v_new, write_page, write_off, lengths + 1, temps, top_k, top_p


ATTN_IMPLS = ("cuda", "torch")  # K4 on the card; its plain version on the host


def make_fused_paged_fns(cfg: LlamaConfig, attn_impl: str, mesh=None, tp_collective: str = "fp",
                         kv_quant: bool = False, group=None):
    """The device-resident step's two halves ``(attn_fn, append_fn)``:
    ``paged_fused_step`` bound to ``cfg``, then ``append_paged``. With a
    pure tp mesh of size > 1 the attention half is one rank's (``group``:
    its ``RankGroup``; the per-layer sums in ``tp_collective``); the
    append needs no collective. ``kv_quant`` is ray_tpu's argument for
    its cache specs; a rank's pool holds its own kv heads in either
    dtype. The page
    attention runs as ``attn_impl`` says, the engine's ``attn_kernel``:
    "cuda" (K4) takes only CUDA tensors and "torch" (the plain version)
    only CPU tensors, and a call on the other device raises. ray_tpu
    compiles the halves as two programs because of XLA's buffer-donation
    aliasing; here stream order runs the append after the attention, and
    the pair is captured into one CUDA graph (``cuda/graph.py``)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    on_card = attn_impl == "cuda"
    cfg, tpc = _tp_of(cfg, mesh, tp_collective, group)

    def attn_fn(params, pool, tables, lengths, tokens, keys, temps, top_k, top_p):
        if tables.is_cuda != on_card:
            raise ValueError(f"attn_impl={attn_impl!r} does not run on {tables.device.type} tensors")
        return paged_fused_step(params, pool, tables, lengths, tokens, keys, temps, top_k, top_p, cfg, tpc)

    return attn_fn, append_paged


def set_lane(tokens, keys, temps, top_k, top_p, slot: int, token: int, key, temp: float, tk: int, tp: float):
    """Admission's lane delta, in place: one slot's next input token, key
    (two uint32 words) and sampling parameters, each a scalar fill (no
    host-to-device copy, so no wait on a step in flight)."""
    tokens[slot] = int(token)
    keys[slot, 0] = int(key[0])
    keys[slot, 1] = int(key[1])
    temps[slot] = float(temp)
    top_k[slot] = int(tk)
    top_p[slot] = float(tp)
    return tokens, keys, temps, top_k, top_p


def set_table(tables, lengths, slot: int, row, length: int):
    """One slot's block-table row and length, in place. ``row``: [max_pg]
    int32; a pinned host row is copied without blocking the host."""
    tables[slot].copy_(row, non_blocking=True)
    lengths[slot] = int(length)
    return tables, lengths


def set_table_cell(tables, slot: int, pg_ix: int, page: int):
    """Page growth's delta, in place: one table entry."""
    tables[slot, pg_ix] = int(page)
    return tables


def make_delta_fns():
    """The scheduler's deltas on the device-resident state:
    ``(set_lane, set_table, set_table_cell)``, each writing O(1) elements
    in place (ray_tpu jits them as scatters that return new arrays)."""
    return set_lane, set_table, set_table_cell


def extend_write_targets(table_row, start, T: int, page: int):
    """(write_page [T], write_off [T]) for a suffix chunk at absolute
    positions start..start+T-1 (the last table column past the row's edge)."""
    positions = int(start) + torch.arange(T, dtype=torch.int64, device=table_row.device)
    page_ix = torch.clamp(positions // page, max=table_row.shape[0] - 1)
    return table_row[page_ix], (positions % page).to(torch.int32)


@torch.no_grad()
def extend_attn_paged(params, pool, table_row, start, tokens, length, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """READ-ONLY half of the paged extend: the suffix ``tokens`` [T]
    (right-padded to a prefill bucket, ``length`` real) at positions
    start..start+T-1 attends to the cached prefix pages (K4, one lane,
    bound ``start``) plus itself causally from registers. Returns
    (logits [vocab] f32 at the last real token, k_chunk [L, T, kv, hd],
    v_chunk same); the pool write is ``append_chunk_paged``."""
    T = tokens.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in pool
    dev = tokens.device
    positions = int(start) + torch.arange(T, dtype=torch.int32, device=dev)
    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
    x = _tp_embed(params["embed"], tokens[None, :], tpc)  # [1, T, H]
    scale = _attn_scale(hd)
    tables = table_row[None].contiguous()
    starts = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    k_chunk, v_chunk = [], []
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [1, T, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin)  # [1, nh, T, hd]
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)  # [1, T, nkv, hd]
        qg = qh.reshape(1, nkv, rep, T, hd)
        k_sc = pool["k_scale"][i] if quant else None
        v_sc = pool["v_scale"][i] if quant else None
        o = _paged_attn_seq_batch(qg, pool["k"][i], pool["v"][i], tables, starts, kh, v_t, scale, k_sc, v_sc)
        o = o[0].permute(2, 0, 1, 3).reshape(1, T, nh * hd).to(x.dtype)
        x = x + _tp_reduce(o @ layer["wo"], tpc)
        x = _mlp(x, layer, cfg, tpc)
        k_chunk.append(kh[0])
        v_chunk.append(v_t[0])
    x = rms_norm(x[0], params["final_norm"], cfg.rms_eps)  # [T, H]
    x_last = x[max(int(length) - 1, 0)]
    return _tp_gather_logits(unembed_f32(x_last, params, cfg), tpc), torch.stack(k_chunk), torch.stack(v_chunk)


# Write half of the paged extend, in place: the suffix K/V rows (write_page /
# write_off [T], k_chunk [L, T, kv, hd]) for every layer, an int8 pool
# quantized here. It is append_paged's scatter with T rows in place of B lanes.
append_chunk_paged = append_paged


def extend_paged(params, pool, table_row, start, tokens, length, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """Attention half, then append half. Returns (logits [vocab] f32 at
    the last real token, pool); the pool is updated in place."""
    write_page, write_off = extend_write_targets(table_row, start, tokens.shape[0], pool["k"].shape[2])
    logits, k_chunk, v_chunk = extend_attn_paged(params, pool, table_row, start, tokens, length, cfg, tpc)
    pool = append_chunk_paged(pool, write_page, write_off, k_chunk, v_chunk)
    return logits, pool


# ------------------------------------------------------------ slot layout
def _dequant(rows, scales):
    """Cache rows [..., S, hd] (a strided view) in f32 for the products,
    which run in f32 as ray_tpu's ``preferred_element_type`` asks: a
    contiguous copy, so the products read it without another, unless the
    rows are f32 already (then the view itself); an int8 cache's copy
    times its scales [..., S]."""
    out = rows.to(torch.float32, memory_format=torch.contiguous_format)
    return out if scales is None else out.mul_(scales[..., None])


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """Advance every slot one token, in place.

    tokens: [slots] int (each slot's next input, garbage for empty
    slots); cache: ``kv_cache`` dict. Each layer first writes the new
    token's K/V at ``min(length, S-1)`` (quantized for an int8 cache),
    then the token attends to positions 0..length of its slot's whole
    row. The length lane grows by one for every slot. Returns (logits
    [slots, vocab] f32, cache)."""
    B = tokens.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in cache
    lengths = cache["length"]
    S = cache["k"].shape[2]
    cos, sin = rotary_embedding(lengths[:, None], hd, cfg.rope_theta)  # [B, 1, hd/2]
    x = _tp_embed(params["embed"], tokens[:, None], tpc)  # [B, 1, H]
    # the new token sits at index length and attends to 0..length
    attn_ok = (torch.arange(S, device=lengths.device)[None, :] <= lengths[:, None])[:, None, None]  # [B, 1, 1, S]
    write_pos = torch.clamp(lengths, max=S - 1)
    div = _sqrt_hd(hd)
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [B, 1, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin).transpose(1, 2)
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)
        k_tok, v_tok = kh[:, 0], v_t[:, 0]
        k_sc = v_sc = None
        if quant:
            k_tok, sk = quantize_heads(k_tok)  # [B, kv, hd] i8, [B, kv] f32
            v_tok, sv = quantize_heads(v_tok)
            k_sc = append_scale_layer(cache["k_scale"][i], sk, write_pos)  # [B, kv, S]
            v_sc = append_scale_layer(cache["v_scale"][i], sv, write_pos)
        k_layer, v_layer = append_token_layer(cache["k"][i], cache["v"][i], k_tok, v_tok, write_pos)
        qg = qh[:, 0].reshape(B, nkv, rep, hd).float()
        kc = _dequant(k_layer.transpose(1, 2), k_sc)  # [B, kv, S, hd]
        vc = _dequant(v_layer.transpose(1, 2), v_sc)
        scores = torch.matmul(qg, kc.transpose(-1, -2)) / div  # [B, kv, rep, S]
        probs = torch.softmax(scores.masked_fill_(~attn_ok, float("-inf")), dim=-1)
        o = torch.matmul(probs, vc).reshape(B, 1, nh * hd).to(x.dtype)
        x = x + _tp_reduce(o @ layer["wo"], tpc)
        x = _mlp(x, layer, cfg, tpc)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps)
    logits = _tp_gather_logits(unembed_f32(x, params, cfg), tpc)
    cache["length"].add_(1)
    return logits, cache


@torch.no_grad()
def extend(params, cache, slot: int, tokens, length: int, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """Chunked prefill of one slot whose cache holds a prefix, in place:
    the suffix ``tokens`` [T] (right-padded, ``length`` real) at positions
    start..start+T-1, start = the slot's length, is written there and
    attends to the cached prefix plus itself causally. Returns (logits
    [vocab] f32 at the last real token, cache) with the slot's length
    start + length. ``start`` stays on the device (no host read)."""
    T = tokens.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in cache
    S = cache["k"].shape[2]
    slot = int(slot)
    dev = tokens.device
    start = cache["length"][slot].clone()
    positions = start + torch.arange(T, dtype=torch.int32, device=dev)
    # ray_tpu's dynamic_update_slice clamps the write so the chunk fits the row
    rows = torch.clamp(start.long(), 0, S - T) + torch.arange(T, device=dev)
    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
    x = _tp_embed(params["embed"], tokens[None, :], tpc)  # [1, T, H]
    # token i (at position start+i) sees cache position j iff j <= start+i
    attn_ok = torch.arange(S, device=dev)[None, :] <= positions[:, None]  # [T, S]
    div = _sqrt_hd(hd)
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [1, T, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin)  # [1, nh, T, hd]
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)  # [1, T, nkv, hd]
        k_suf, v_suf = kh[0], v_t[0]  # [T, nkv, hd]
        k_row, v_row = cache["k"][i, slot], cache["v"][i, slot]  # [S, nkv, hd]
        k_sc = v_sc = None
        if quant:
            k_suf, sk = quantize_heads(k_suf)  # sk: [T, nkv]
            v_suf, sv = quantize_heads(v_suf)
            k_sc, v_sc = cache["k_scale"][i, slot], cache["v_scale"][i, slot]  # [nkv, S]
            k_sc[:, rows] = sk.T
            v_sc[:, rows] = sv.T
        k_row[rows] = k_suf.to(k_row.dtype)
        v_row[rows] = v_suf.to(v_row.dtype)
        qg = qh[0].reshape(nkv, rep * T, hd).float()  # head h = g * rep + r
        kc = _dequant(k_row.transpose(0, 1), k_sc)  # [nkv, S, hd]
        vc = _dequant(v_row.transpose(0, 1), v_sc)
        scores = (torch.matmul(qg, kc.transpose(-1, -2)) / div).reshape(nkv, rep, T, S)
        probs = torch.softmax(scores.masked_fill_(~attn_ok, float("-inf")), dim=-1)
        o = torch.matmul(probs.reshape(nkv, rep * T, S), vc).reshape(nkv, rep, T, hd)
        o = o.permute(2, 0, 1, 3).reshape(1, T, nh * hd).to(x.dtype)
        x = x + _tp_reduce(o @ layer["wo"], tpc)
        x = _mlp(x, layer, cfg, tpc)
    x = rms_norm(x[0], params["final_norm"], cfg.rms_eps)  # [T, H]
    logits = _tp_gather_logits(unembed_f32(x[max(int(length) - 1, 0)], params, cfg), tpc)
    cache["length"][slot] = start + int(length)
    return logits, cache


@torch.no_grad()
def fused_step(params, cache, tokens, keys, temps, top_k, top_p, cfg: LlamaConfig, tpc: TpSpec | None = None):
    """The slot layout's device-resident step: ``decode_step`` (append,
    attention, lengths + 1, in place) then ``sample``, with no host read.
    Returns ray_tpu's 7 outputs: (cache, tokens [B], logprobs [B], new keys
    [B, 2], temps, top_k, top_p); the sampling lanes pass through."""
    logits, cache = decode_step(params, cache, tokens, cfg, tpc)
    toks, logps, new_keys = sample(logits, keys, temps, top_k, top_p)
    return cache, toks, logps, new_keys, temps, top_k, top_p


def make_fused_fns(cfg: LlamaConfig, mesh=None, tp_collective: str = "fp", kv_quant: bool = False, group=None):
    """``fused_step`` bound to ``cfg``: the slot layout's device-resident
    step, captured whole into one CUDA graph on the card
    (``cuda/graph.py``). With a pure tp mesh of size > 1 it is one rank's
    step (``group``: its ``RankGroup``), run eagerly: the per-layer sums
    in ``tp_collective``. A mesh with other axes is not ported."""
    cfg, tpc = _tp_of(cfg, mesh, tp_collective, group)

    def step(params, cache, tokens, keys, temps, top_k, top_p):
        return fused_step(params, cache, tokens, keys, temps, top_k, top_p, cfg, tpc)

    return step
