"""The speculative verify step (port of ray_tpu/llm/spec/verify.py, single
device).

Per lane the step takes the current input token t0 plus k proposals
d1..dk (padded to the STATIC width k so shapes never vary), runs the
target model over all k+1 positions in one wide forward, and:

- accepts the longest proposal prefix the target agrees with: greedy
  exact-match for temperature 0 lanes, one-hot rejection sampling (accept
  d with probability p(d), resample a rejection from p with d masked) for
  temperature > 0, where p is the target distribution after the same
  temperature / top-k / top-p surgery ``sampling.sample`` applies;
- emits the accepted tokens plus one token from the target at the first
  disagreement (the bonus or replacement), so every round emits >= 1;
- appends the whole block's K/V and rolls back rejections by setting
  length = l + accepted + 1: positions past the new length are dead
  until overwritten;
- advances the lane's token-history buffer (the drafter's input) on the
  device, so draft -> verify chains with no host sync.

Everything is tensor arithmetic with no host read and writes in place
where ray_tpu returns new arrays, so a CUDA graph captures a whole round
(``llm/cuda/graph.py``). The slot layout's forward is plain PyTorch, as
``model_runner.decode_step`` is; the paged layout's block attention is
``paged_kv._paged_attn_seq_batch``, whose prefix half is K4 on the card,
one launch per layer at R = rep * (k + 1) rows per kv head, and which
only reads the pool: ``spec_append_paged`` writes the block afterwards.
Writes past a slot row are dropped and writes past a page table go to
the trash page: they occur only in rounds whose tokens the host discards.

Not ported: the tensor-parallel verify steps (``_sharded_*``,
``spec_verify_tp``, ``spec_verify_paged_tp``) and the jaxcheck entries;
they wait for the multi-device item (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.llm import prng
from ray_tpu_torch.llm.kv_quant import quantize_heads
from ray_tpu_torch.llm.model_runner import _attn_scale, _dequant, _mlp, _qkv, _sqrt_hd
from ray_tpu_torch.llm.paged_kv import _paged_attn_seq_batch
from ray_tpu_torch.llm.sampling import filter_logits
from ray_tpu_torch.models.llama import LlamaConfig, layer_params, unembed_f32
from ray_tpu_torch.ops.layers import apply_rope, rms_norm, rotary_embedding


# ---------------------------------------------------------------------------
# acceptance + sampling (layout-independent)
# ---------------------------------------------------------------------------
def _take(x, idx):
    """x[b, idx[b]] along dim 1: x [B, T, ...], idx [B] -> [B, ...]."""
    shape = (x.shape[0], 1) + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.view(shape).expand(x.shape[0], 1, *x.shape[2:]))[:, 0]


@torch.no_grad()
def _accept_and_sample(logits, proposals, spec_k, keys, temps, top_k, top_p):
    """logits: [B, k+1, V] target logits over (t0, d1..dk); proposals:
    [B, k]; keys [B, 2] lane keys (``prng``). Returns (emit [B, k+1],
    logps [B, k+1] f32, acc [B], final [B], new_keys [B, 2]) where
    emit[:, :acc] are accepted proposals, emit[:, acc] the bonus or
    replacement, and the rest zeros the host never reads. Each lane's key
    splits into k + 2 subkeys: k accept draws (one scalar ``uniform``
    each), the replacement draw (``categorical``) and the next key."""
    B, T, V = logits.shape
    k = T - 1
    dev = logits.device
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)  # [B, T]
    logp_full = torch.log_softmax(logits, dim=-1)
    # the SAME distribution surgery sample() applies, broadcast over T
    filt = filter_logits(logits, temps[:, None], top_k[:, None], top_p[:, None])
    probs = torch.softmax(filt, dim=-1)  # [B, T, V]

    subkeys = prng.split(keys, k + 2)  # [B, k+2, 2]
    u = prng.uniform(subkeys[:, :k], ())  # [B, k]

    props = proposals.long()
    p_prop = torch.gather(probs[:, :k], 2, props[..., None])[..., 0]  # [B, k]
    accept_greedy = props == greedy[:, :k]
    accept_stoch = u < p_prop  # one-hot q: accept probability = p(d)
    accept = torch.where(temps[:, None] == 0.0, accept_greedy, accept_stoch)
    accept = accept & (torch.arange(k, device=dev)[None, :] < spec_k[:, None])
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [B]

    # the final token from the first-disagreement position's target logits
    lg_a = _take(logits, acc)  # [B, V]
    filt_a = _take(filt, acc)
    rejected = acc < torch.clamp(spec_k.long(), max=k)  # a proposal was examined and refused
    d_rej = _take(props, torch.clamp(acc, max=k - 1))
    # one-hot-q residual max(p - q, 0): p with the refused token masked out
    mask_rej = (torch.arange(V, device=dev)[None, :] == d_rej[:, None]) & rejected[:, None]
    stoch_tok = prng.categorical(subkeys[:, k], filt_a.masked_fill(mask_rej, float("-inf")))
    greedy_tok = torch.argmax(lg_a, dim=-1)
    final = torch.where(temps == 0.0, greedy_tok, stoch_tok)
    new_keys = subkeys[:, k + 1].contiguous()

    cols = torch.arange(k + 1, device=dev)[None, :]
    props_pad = F.pad(props, (0, 1))
    emit = torch.where(cols < acc[:, None], props_pad, 0)
    emit = torch.where(cols == acc[:, None], final[:, None], emit)
    # logprobs from the UNfiltered distribution, as sample() reports them
    lp_pad = F.pad(torch.gather(logp_full[:, :k], 2, props[..., None])[..., 0], (0, 1))
    lp_fin = torch.gather(_take(logp_full, acc), 1, final[:, None])[:, 0]
    logps = torch.where(cols < acc[:, None], lp_pad, 0.0)
    logps = torch.where(cols == acc[:, None], lp_fin[:, None], logps)
    return emit, logps, acc, final, new_keys


def _update_hist(hist, hist_len, emit, acc):
    """Append the round's emitted tokens to the history lanes, in place.
    All k+1 columns are written (past-acceptance garbage sits beyond the
    new valid length and is overwritten before it could be read); writes
    past the buffer edge are dropped, not clamped: ``hist`` is the [B, H]
    view of a [B, H + 1] buffer (``spec_hist_buffer``) and they land in its
    trash column, which nothing reads. They occur only in rounds whose
    tokens the host discards. Returns the new valid counts
    hist_len + acc + 1."""
    B, Tp1 = emit.shape
    H = hist.shape[1]
    if hist.stride() != (H + 1, 1):
        raise ValueError("hist must be the [B, H] view of a [B, H + 1] buffer (spec_hist_buffer)")
    rows = torch.arange(B, device=hist.device)[:, None]
    hpos = hist_len.long()[:, None] + torch.arange(Tp1, device=hist.device)[None, :]
    full = hist.as_strided((B, H + 1), (H + 1, 1))
    full[rows, torch.where(hpos < H, hpos, H)] = emit.to(hist.dtype)
    return hist_len + acc + 1


def spec_hist_buffer(B: int, H: int, device) -> torch.Tensor:
    """The engine's token-history lanes: a [B, H] int64 view (what the
    drafter reads) of a zeroed [B, H + 1] buffer whose last column takes
    the dropped writes of ``_update_hist``."""
    return torch.zeros((B, H + 1), dtype=torch.int64, device=device)[:, :H]


def clone_hist(hist) -> torch.Tensor:
    """A copy of history lanes in the same [B, H + 1] buffer layout."""
    B, H = hist.shape
    return hist.as_strided((B, H + 1), (H + 1, 1)).clone()[:, :H]


# ---------------------------------------------------------------------------
# slot layout
# ---------------------------------------------------------------------------
def _write_block(layer, rows, positions, values):
    """layer[b, positions[b, t]] = values[b, t] in place, writes at or
    past the row's end dropped, as ``.at[...].set(mode="drop")`` drops them.
    A dropped write is redirected onto the row's first block position
    with the value that position ends with (the block's own first value,
    or the old one when the whole block is past the row), so every index
    written twice gets one value.

    layer: [B, S, ...]; positions: [B, T] (consecutive per row);
    values: [B, T, ...] in layer's dtype."""
    S = layer.shape[1]
    inside = positions < S
    p0 = positions[:, 0].clamp(max=S - 1)
    first = torch.where((positions[:, 0] < S).view(-1, *([1] * (values.dim() - 2))), values[:, 0], layer[rows[:, 0], p0])
    pos = torch.where(inside, positions, p0[:, None])
    mask = inside.view(*inside.shape, *([1] * (values.dim() - 2)))
    layer[rows, pos] = torch.where(mask, values, first[:, None])


@torch.no_grad()
def _forward_block_slots(params, cache, toks_blk, cfg: LlamaConfig):
    """Target forward over T = k+1 tokens per slot at positions
    length..length+T-1, in place on ``cache``. Each layer writes the
    block's K/V into the cache rows first (writes past the row dropped;
    quantized for an int8 cache), then attends over the whole updated row
    with mask j <= position, as ``decode_step`` does per token. Returns
    logits [B, T, V] f32."""
    B, T = toks_blk.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in cache
    S = cache["k"].shape[2]
    dev = toks_blk.device
    lengths = cache["length"]
    positions = lengths.long()[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)  # [B, T, hd/2]
    x = params["embed"][toks_blk]  # [B, T, H]
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    # query i sits at position length+i and may attend cache 0..length+i
    attn_ok = (torch.arange(S, device=dev)[None, None, :] <= positions[:, :, None])[:, None, None]  # [B,1,1,T,S]
    div = _sqrt_hd(hd)
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [B, T, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin)  # [B, nh, T, hd]
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)  # [B, T, nkv, hd]
        k_blk, v_blk = kh, v_t
        k_sc = v_sc = None
        if quant:
            k_blk, sk = quantize_heads(k_blk)  # [B, T, kv] scales
            v_blk, sv = quantize_heads(v_blk)
            k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]  # [B, kv, S]
            _write_block(k_sc.transpose(1, 2), rows, positions, sk)  # [B, S, kv] view
            _write_block(v_sc.transpose(1, 2), rows, positions, sv)
        k_layer, v_layer = cache["k"][i], cache["v"][i]  # [B, S, kv, hd]
        _write_block(k_layer, rows, positions, k_blk.to(k_layer.dtype))
        _write_block(v_layer, rows, positions, v_blk.to(v_layer.dtype))
        qg = qh.reshape(B, nkv, rep * T, hd).float()  # head h = g * rep + r
        kc = _dequant(k_layer.transpose(1, 2), k_sc)  # [B, kv, S, hd]
        vc = _dequant(v_layer.transpose(1, 2), v_sc)
        scores = (torch.matmul(qg, kc.transpose(-1, -2)) / div).reshape(B, nkv, rep, T, S)
        probs = torch.softmax(scores.masked_fill_(~attn_ok, float("-inf")), dim=-1)
        o = torch.matmul(probs.reshape(B, nkv, rep * T, S), vc).reshape(B, nkv, rep, T, hd)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, T, nh * hd).to(x.dtype)
        x = x + o @ layer["wo"]
        x = _mlp(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed_f32(x, params, cfg)


@torch.no_grad()
def spec_verify_slots(params, cache, proposals, tokens, keys, temps, top_k, top_p, spec_k, hist, hist_len,
                      cfg: LlamaConfig):
    """The slot layout's speculative round after the draft: the wide
    target forward over (t0, d1..dk), accept/sample, the block's K/V in
    the cache, the length rollback and the history append, all in place
    (``cache`` and ``hist``). Returns (emit [B, k+1], logps [B, k+1],
    acc [B], final [B], new_keys [B, 2], hist_len + acc + 1); the cache's
    length lane is now length + acc + 1."""
    toks_blk = torch.cat([tokens[:, None], proposals.to(tokens.dtype)], dim=1)
    logits = _forward_block_slots(params, cache, toks_blk, cfg)
    emit, logps, acc, final, new_keys = _accept_and_sample(logits, proposals, spec_k, keys, temps, top_k, top_p)
    new_hist_len = _update_hist(hist, hist_len, emit, acc)
    cache["length"].add_((acc + 1).to(cache["length"].dtype))
    return emit, logps, acc, final, new_keys, new_hist_len


# ---------------------------------------------------------------------------
# paged layout
# ---------------------------------------------------------------------------
@torch.no_grad()
def _forward_block_paged(params, pool, tables, lengths, toks_blk, cfg: LlamaConfig):
    """Target forward over T = k+1 tokens per lane at positions
    length..length+T-1 over the paged pool, which it only reads: the
    prefix through ``_paged_attn_seq_batch`` (K4 on the card, one launch a
    layer at R = rep * T rows per kv head; its plain version on the
    host), the block itself causally from registers. Returns (logits
    [B, T, V] f32, k_blk, v_blk [L, B, T, kv, hd])."""
    B, T = toks_blk.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = nh // nkv
    quant = "k_scale" in pool
    positions = lengths.long()[:, None] + torch.arange(T, device=toks_blk.device)[None, :]  # [B, T]
    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
    x = params["embed"][toks_blk]  # [B, T, H]
    scale = _attn_scale(hd)
    k_out, v_out = [], []
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        xn = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k_t, v_t = _qkv(xn, layer, cfg)  # [B, T, nh/nkv, hd]
        qh = apply_rope(q.transpose(1, 2), cos, sin)  # [B, nh, T, hd]
        kh = apply_rope(k_t.transpose(1, 2), cos, sin).transpose(1, 2)  # [B, T, nkv, hd]
        qg = qh.reshape(B, nkv, rep, T, hd)
        k_sc = pool["k_scale"][i] if quant else None
        v_sc = pool["v_scale"][i] if quant else None
        o = _paged_attn_seq_batch(qg, pool["k"][i], pool["v"][i], tables, lengths, kh, v_t, scale, k_sc, v_sc)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, T, nh * hd).to(x.dtype)
        x = x + o @ layer["wo"]
        x = _mlp(x, layer, cfg)
        k_out.append(kh)
        v_out.append(v_t)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed_f32(x, params, cfg), torch.stack(k_out), torch.stack(v_out)


@torch.no_grad()
def spec_verify_paged(params, pool, tables, lengths, proposals, tokens, keys, temps, top_k, top_p, spec_k, hist,
                      hist_len, cfg: LlamaConfig):
    """READ-ONLY half of the paged speculative round: the block forward
    (``_forward_block_paged``), accept/sample and the write targets; the
    pool write is ``spec_append_paged``. The history append is in place
    on ``hist``. Rows past a lane's table edge go to the trash page.
    Returns ray_tpu's outputs less the pass-through lanes: (emit, logps,
    acc, final, new_keys, k_blk, v_blk [L, B, T, kv, hd], wp, wo [B, T],
    lengths + acc + 1, hist_len + acc + 1)."""
    B, k = proposals.shape
    page = pool["k"].shape[2]
    max_pg = tables.shape[1]
    toks_blk = torch.cat([tokens[:, None], proposals.to(tokens.dtype)], dim=1)
    logits, k_blk, v_blk = _forward_block_paged(params, pool, tables, lengths, toks_blk, cfg)
    emit, logps, acc, final, new_keys = _accept_and_sample(logits, proposals, spec_k, keys, temps, top_k, top_p)
    new_hist_len = _update_hist(hist, hist_len, emit, acc)
    positions = lengths.long()[:, None] + torch.arange(k + 1, device=tokens.device)[None, :]
    pg_ix = positions // page
    wp = torch.where(pg_ix < max_pg, torch.gather(tables, 1, pg_ix.clamp(max=max_pg - 1)), 0)
    wo = positions % page
    return (emit, logps, acc, final, new_keys, k_blk, v_blk, wp, wo, lengths + acc.to(lengths.dtype) + 1,
            new_hist_len)


@torch.no_grad()
def spec_append_paged(pool, wp, wo, k_blk, v_blk):
    """Write half of the paged speculative round, in place: the whole
    block's K/V ([L, B, T, kv, hd]) at (wp, wo) [B, T] for every layer.
    Rejected positions land in the lane's own dead tail (or the trash
    page) and are overwritten before the length could expose them. An
    int8 pool quantizes here."""
    wp, wo = wp.long(), wo.long()
    if "k_scale" in pool:
        k_blk, sk = quantize_heads(k_blk)  # [L, B, T, kv] scales
        v_blk, sv = quantize_heads(v_blk)
        # [L, P, kv, page] indexed at [:, wp, :, wo] -> [B, T, L, kv]
        pool["k_scale"][:, wp, :, wo] = sk.permute(1, 2, 0, 3)
        pool["v_scale"][:, wp, :, wo] = sv.permute(1, 2, 0, 3)
    pool["k"][:, wp, wo] = k_blk.to(pool["k"].dtype)
    pool["v"][:, wp, wo] = v_blk.to(pool["v"].dtype)
    return pool


def make_spec_verify_slots(cfg: LlamaConfig):
    """``spec_verify_slots`` bound to ``cfg``: the slot layout's verify,
    plain PyTorch on either device."""

    def verify_fn(params, cache, proposals, tokens, keys, temps, top_k, top_p, spec_k, hist, hist_len):
        return spec_verify_slots(params, cache, proposals, tokens, keys, temps, top_k, top_p, spec_k, hist,
                                 hist_len, cfg)

    return verify_fn


def make_spec_verify_paged(cfg: LlamaConfig, attn_impl: str):
    """The paged verify's two halves ``(attn_fn, append_fn)``:
    ``spec_verify_paged`` bound to ``cfg``, then ``spec_append_paged``.
    The page attention runs as ``attn_impl`` says, the engine's
    ``attn_kernel``: "cuda" (K4) takes only CUDA tensors and "torch" (the
    plain version) only CPU tensors, and a call on the other device
    raises. ray_tpu compiles the halves as two programs (the pool's
    gather/scatter aliasing); here stream order runs the append after the
    attention, and the round is captured as one CUDA graph."""
    from ray_tpu_torch.llm.model_runner import ATTN_IMPLS

    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    on_card = attn_impl == "cuda"

    def attn_fn(params, pool, tables, lengths, proposals, tokens, keys, temps, top_k, top_p, spec_k, hist, hist_len):
        if tables.is_cuda != on_card:
            raise ValueError(f"attn_impl={attn_impl!r} does not run on {tables.device.type} tensors")
        return spec_verify_paged(params, pool, tables, lengths, proposals, tokens, keys, temps, top_k, top_p, spec_k,
                                 hist, hist_len, cfg)

    return attn_fn, spec_append_paged


# ---------------------------------------------------------------------------
# scheduler deltas for the spec lanes, in place
# ---------------------------------------------------------------------------
def set_hist_row(hist, hist_len, spec_k, slot: int, row, n: int, k0: int):
    """Admission delta: one lane's token history (``row`` [H] int64; a
    pinned host row is copied without blocking the host), valid count and
    effective k."""
    hist[slot].copy_(row, non_blocking=True)
    hist_len[slot] = int(n)
    spec_k[slot] = int(k0)
    return hist, hist_len, spec_k


def set_slot_scalar(arr, slot: int, val: int):
    """The controller's per-lane effective-k move: one scalar fill."""
    arr[slot] = int(val)
    return arr
