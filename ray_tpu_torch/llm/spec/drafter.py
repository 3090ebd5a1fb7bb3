"""Drafters: propose k continuation tokens per lane, device-resident (port
of ray_tpu/llm/spec/drafter.py).

Both drafters are DETERMINISTIC (one-hot proposal distributions), which
keeps the verify step's rejection sampling exact without a [B, k, V]
q-tensor: accepting proposal d with probability p(d) and resampling a
rejection from p with d masked is the one-hot case of speculative
rejection sampling, so the output distribution matches plain sampling.

- ``NGramDrafter``: prompt-lookup decoding (zero extra weights). The
  trailing n-gram of the lane's token history is matched against the
  history itself; the k tokens after the most recent earlier occurrence
  become the proposals. Batched tensor ops with no host read and no
  data-dependent shape, so the proposal is captured in the spec round's
  CUDA graph.
- ``ModelDrafter``: a smaller llama with its OWN slot KV cache
  (``kv_cache.py``, ``max_seq_len + k + 1`` positions a row) and k+1
  chained greedy slot ``decode_step``s (the extra step writes the last
  proposal's KV, so the draft cache tracks the target's length and no
  catch-up pass is needed). Rollback after verification is free: the
  next round overwrites positions past the accepted prefix, and the draft
  attention masks by position.

The engine drives a drafter through three hooks: ``init_slots`` (shape
the per-slot state), ``admit`` (host-side (re)admission: prefill the
draft cache), ``propose`` (the device call on the hot path; ``cache``
overrides the drafter's own draft cache, as the graph's warm-up does with
a clone). ``supports_mesh`` says whether a drafter composes with a
tensor-parallel engine: the n-gram drafter's only state is the engine's
history lanes, which every rank holds whole (True); a draft model's
weights, cache and chain are not sharded (False: the engine raises).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.llm import kv_cache as kvc
from ray_tpu_torch.llm.model_runner import decode_step, prefill
from ray_tpu_torch.models.llama import LlamaConfig


# ---------------------------------------------------------------------------
# prompt-lookup (n-gram) drafting
# ---------------------------------------------------------------------------
@torch.no_grad()
def ngram_propose(hist, hist_len, n: int, k: int):
    """Prompt-lookup proposals: for each lane, find the LAST earlier
    occurrence of the trailing n-gram inside the known history and
    propose the k tokens that followed it.

    hist: [B, H] int token history (zero right-padding); hist_len: [B]
    valid counts. Returns proposals [B, k] of hist's dtype. A lane with no
    match proposes its last token k times (the verify step rejects garbage
    proposals, so no validity lane is needed). Slices clamp their start as
    ``jax.lax.dynamic_slice`` does: the pattern at ``max(ln - n, 0)``
    (into [0, H - n]), the continuation into [0, H - k]; a single index
    past the row reads its last column, as a JAX gather clamps."""
    B, H = hist.shape
    dev = hist.device
    idx = torch.arange(H, device=dev)
    ln = hist_len.long()
    start = torch.clamp(ln - n, min=0).clamp(max=H - n)
    pat = torch.gather(hist, 1, start[:, None] + torch.arange(n, device=dev))  # trailing n-gram [B, n]
    # win[b, i] = hist[b, i : i + n] (wrapping windows; wraps are masked below)
    win = torch.stack([torch.roll(hist, -j, dims=1) for j in range(n)], dim=2)  # [B, H, n]
    # a usable start needs its continuation token hist[i + n] inside the
    # known history AND must not be the trailing occurrence itself
    match = (win == pat[:, None, :]).all(dim=2) & (idx[None, :] + n < ln[:, None])
    i_star = torch.where(match, idx, -1).amax(dim=1)
    hit = i_star >= 0
    last_ix = torch.clamp(ln - 1, min=0)
    src = torch.where(hit, i_star + n, last_ix).clamp(0, H - k)
    props = torch.gather(hist, 1, src[:, None] + torch.arange(k, device=dev))
    last = torch.gather(hist, 1, last_ix.clamp(max=H - 1)[:, None])
    return torch.where(hit[:, None], props, last.expand(B, k))


class NGramDrafter:
    """Prompt-lookup drafter: stateless beyond the engine's hist lanes."""

    kind = "ngram"
    supports_mesh = True

    def __init__(self, k: int = 4, n: int = 3):
        self.k = int(k)
        self.n = int(n)

    def init_slots(self, num_slots: int, max_seq_len: int, prefill_buckets: tuple, device=None) -> None:
        pass

    def admit(self, slot: int, tokens: list) -> None:
        pass

    def state(self) -> dict:
        """The tensors the proposal reads besides the lanes: none."""
        return {}

    def propose(self, hist, hist_len, lengths, cache=None):
        del lengths, cache  # history is the only state prompt-lookup needs
        return ngram_propose(hist, hist_len, self.n, self.k)


# ---------------------------------------------------------------------------
# draft-model drafting
# ---------------------------------------------------------------------------
@torch.no_grad()
def draft_steps(params, cache, hist, hist_len, lengths, cfg: LlamaConfig, k: int):
    """k+1 chained greedy decode steps of the draft model, proposing k
    tokens per lane, in place on ``cache``.

    The draft cache's length lane is OVERWRITTEN with the target's
    ``lengths`` first: that is the whole rollback protocol. Step i
    processes the token at position lengths+i and attends 0..lengths+i,
    so stale drafted KV past the last accepted token is overwritten before
    it could be read. The (k+1)-th step's prediction is discarded, but its
    KV write keeps the draft cache level with the target's.

    hist/hist_len: the engine's token-history lanes (the chain starts from
    hist[hist_len-1], the lane's current input token). Returns (proposals
    [B, k] int64, cache) with the length lane at lengths + k + 1."""
    H = hist.shape[1]
    t0 = torch.gather(hist, 1, torch.clamp(hist_len.long() - 1, min=0).clamp(max=H - 1)[:, None])[:, 0]
    cache["length"].copy_(lengths)
    tok, outs = t0, []
    for _ in range(k + 1):
        logits, cache = decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits, dim=-1)
        outs.append(tok)
    return torch.stack(outs[:k], dim=1), cache


class ModelDrafter:
    """Greedy draft-model drafter with its own slot KV cache.

    ``config`` must share the target's vocab; ``params`` default to random
    weights from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (tests and benchmarks: a deployment passes distilled weights). Greedy
    drafting keeps the proposal distribution one-hot (module docstring)."""

    kind = "model"
    supports_mesh = False

    def __init__(self, config: LlamaConfig, params=None, k: int = 4, seed: int = 0, device=None):
        from ray_tpu_torch.models.llama import init_params

        self.cfg = config
        self.k = int(k)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        if params is None:
            params = init_params(config, torch.Generator(device=self.device).manual_seed(seed))
        self.params = params
        self.cache = None
        self._buckets: tuple = ()
        self.prefill_forwards = 0  # admissions' draft prefills (each K1 num_layers times on the card)

    def init_slots(self, num_slots: int, max_seq_len: int, prefill_buckets: tuple, device=None) -> None:
        self._buckets = tuple(prefill_buckets)
        # +k+1 headroom: the draft chain writes up to k+1 positions past
        # the target length each round, clamp-free
        self.cache = kvc.alloc(kvc.CacheConfig(
            num_layers=self.cfg.num_layers,
            num_slots=num_slots,
            max_seq_len=max_seq_len + self.k + 1,
            num_kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.hd,
            dtype=self.cfg.dtype,
        ), self.device if device is None else device)

    def admit(self, slot: int, tokens: list) -> None:
        """Prefill the draft model over the admitted sequence's tokens
        (everything the target has cached: the prompt plus any
        recompute-folded generation; NOT the freshly sampled token, which
        is the first chain input), into the slot in place."""
        from ray_tpu_torch.llm.engine import _bucket

        n = len(tokens)
        T = _bucket(n, self._buckets)
        toks = np.zeros((1, T), np.int64)
        toks[0, :n] = tokens
        dev = self.cache["k"].device
        _, ks, vs = prefill(self.params, torch.from_numpy(toks).to(dev), torch.tensor([n], device=dev), self.cfg)
        self.prefill_forwards += 1
        kvc.insert_sequence(self.cache, slot, ks[:, 0], vs[:, 0], n)

    def state(self) -> dict:
        """The tensors the proposal reads besides the lanes: the draft
        weights and cache (a captured graph reads them where they are)."""
        return {"params": self.params, "cache": self.cache}

    def propose(self, hist, hist_len, lengths, cache=None):
        props, _ = draft_steps(self.params, self.cache if cache is None else cache, hist, hist_len, lengths,
                               self.cfg, self.k)
        return props
