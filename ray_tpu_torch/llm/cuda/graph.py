"""The device-resident decode step and speculative round, run from
persistent lane tensors: on the card one CUDA graph per engine, captured
once and replayed every step; on the host the same step, eagerly.

``FusedDecode`` holds the lanes as tensors whose addresses never change:
the scheduler edits them in place between steps (``model_runner.set_lane``,
``spec.verify.set_hist_row`` and the other deltas), and the step reads
them where the graph recorded them. What one step is depends on the KV
layout and on speculation:

- ``PagedStep`` (lanes: tables, lengths, tokens, keys, temps, top_k,
  top_p): the attention half (``paged_fused_step``: K4 over the pages,
  ``sample``), the append half (``append_paged``), then the write-back
  that ray_tpu does by rebinding donated buffers: the sampled tokens
  become the next inputs, the keys advance, every length grows by one.
  ray_tpu compiles the two halves as two XLA programs because of
  buffer-donation aliasing; on one CUDA stream the append runs after the
  attention, so both are captured in one graph.
- ``SlotStep`` (lanes: tokens, keys, temps, top_k, top_p): ``fused_step``
  (each slot's append, attention over the static cache, ``sample``) and
  the same write-back; the length lane is the cache's own ``length``
  tensor, which ``decode_step`` advances in place, so the address check
  below covers it with the cache.
- ``SpecPagedStep`` and ``SpecSlotStep`` (the lanes above plus spec_k,
  hist, hist_len): one speculative round, ``drafter.propose`` -> verify
  (paged: ``spec_verify_paged``, K4 once per layer at R = rep * (k + 1),
  then ``spec_append_paged``; slots: ``spec_verify_slots``) -> the
  write-back of tokens, keys, lengths (l + acc + 1; the slot cache's lane
  advances inside the verify), hist (in place) and hist_len. spec_k is a
  lane the host edits between rounds. ray_tpu dispatches the draft and
  the verify (two programs, three paged) per round; here the round is one
  graph. A model drafter's weights and cache are read where they are, so
  the address check covers them too.

On a tensor-parallel engine's ranks (``capture=False``) the step runs
eagerly on the card too: its per-layer sums are gloo collectives
(``parallel/ranks.py``), which a CUDA graph cannot capture, so
``captures`` stays 0 and every K4 launch counts as it runs.

Capture happens once, when the ``FusedDecode`` is built (``captures``
counts it; the telemetry's recompile sentinel reads it): a warm-up step
first runs eagerly on a side stream, on copies of the lanes (and a copy
of the slot cache's length lane, and of a model drafter's cache), to do
every first-call initialisation (the kernel library's load and shared
memory attribute, K4's cached plan and SM count, cuBLAS's handle and
workspace) outside the capture. Its writes are harmless: the paged copy's
tables point at the trash page; a slot's writes land at and past that
slot's length, which attention masks until the slot's next real step
writes the same positions first; the draft cache is not touched at all.
Nothing falls back: a failed capture or replay raises.

A replay ends with a copy of the step's outputs (decode: tokens and
logprobs; spec: emit [B, k+1], logprobs [B, k+1] and acc [B]) into one of
two pinned host buffer sets, sized from the captured outputs and used in
turn, each with its CUDA event, so the next replay never overwrites a
step that the engine has not read yet (the engine reads step N after it
has dispatched step N + 1).

K4's launch counter counts wrapper calls, so a replay adds nothing by
itself: the capture records how many K4 launches one step holds and each
replay adds that many to ``paged_attn_partials.launches`` (none for the
slot layout, which has no page gather).
"""

from __future__ import annotations

import time

import torch

from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials


def _leaf_ptrs(tree, prefix=""):
    """``(path, data_ptr)`` of every tensor in a nested dict."""
    out = []
    for name, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaf_ptrs(value, f"{prefix}{name}/"))
        else:
            out.append((prefix + name, value.data_ptr()))
    return out


def _lane_copies(lanes):
    """Copies of the lanes for the warm-up; the history lanes keep their
    [B, H + 1] buffer layout (``spec.verify.clone_hist``)."""
    from ray_tpu_torch.llm.spec.verify import clone_hist

    return {name: clone_hist(t) if name == "hist" else t.clone() for name, t in lanes.items()}


class PagedStep:
    """The paged layout's step over a pool: ``attn_fn, append_fn`` from
    ``model_runner.make_fused_paged_fns``."""

    LANES = ("tables", "lengths", "tokens", "keys", "temps", "top_k", "top_p")
    kv_name = "pool"

    def __init__(self, attn_fn, append_fn):
        self._attn_fn, self._append_fn = attn_fn, append_fn

    def state(self) -> dict:
        return {}

    def run(self, params, pool, lanes, draft=None):
        toks, logps, keys, k_new, v_new, write_page, write_off, lengths, *_ = self._attn_fn(
            params, pool, *(lanes[name] for name in self.LANES))
        self._append_fn(pool, write_page, write_off, k_new, v_new)
        lanes["tokens"].copy_(toks)
        lanes["keys"].copy_(keys)
        lanes["lengths"].copy_(lengths)
        return toks, logps

    def warmup_state(self, pool, lanes):
        scratch = _lane_copies(lanes)
        scratch["tables"].zero_()  # every write of the warm-up lands in the trash page
        scratch["lengths"].zero_()
        return pool, scratch, None


class SlotStep:
    """The slot layout's step over a ``kv_cache`` dict: ``fused_fn`` from
    ``model_runner.make_fused_fns``."""

    LANES = ("tokens", "keys", "temps", "top_k", "top_p")
    kv_name = "cache"

    def __init__(self, fused_fn):
        self._fused_fn = fused_fn

    def state(self) -> dict:
        return {}

    def run(self, params, cache, lanes, draft=None):
        _, toks, logps, keys, *_ = self._fused_fn(params, cache, *(lanes[name] for name in self.LANES))
        lanes["tokens"].copy_(toks)
        lanes["keys"].copy_(keys)
        return toks, logps

    def warmup_state(self, cache, lanes):
        # the warm-up advances a copy of the length lane: the real one stays
        return {**cache, "length": cache["length"].clone()}, _lane_copies(lanes), None


class _SpecStep:
    """What both speculative steps share: the drafter, its state for the
    address check, and the warm-up's clone of a draft cache."""

    def __init__(self, drafter):
        self.drafter = drafter

    def state(self) -> dict:
        return self.drafter.state()

    def _draft_copy(self):
        cache = self.drafter.state().get("cache")
        return None if cache is None else {name: t.clone() for name, t in cache.items()}


class SpecPagedStep(_SpecStep):
    """One speculative round on the paged layout: ``drafter`` (a
    ``spec.drafter`` drafter) and ``attn_fn, append_fn`` from
    ``spec.verify.make_spec_verify_paged``."""

    LANES = ("tables", "lengths", "tokens", "keys", "temps", "top_k", "top_p", "spec_k", "hist", "hist_len")
    kv_name = "pool"

    def __init__(self, drafter, attn_fn, append_fn):
        super().__init__(drafter)
        self._attn_fn, self._append_fn = attn_fn, append_fn

    def run(self, params, pool, lanes, draft=None):
        props = self.drafter.propose(lanes["hist"], lanes["hist_len"], lanes["lengths"], cache=draft)
        emit, logps, acc, final, keys, k_blk, v_blk, wp, wo, lengths, hist_len = self._attn_fn(
            params, pool, lanes["tables"], lanes["lengths"], props,
            *(lanes[name] for name in ("tokens", "keys", "temps", "top_k", "top_p", "spec_k", "hist", "hist_len")))
        self._append_fn(pool, wp, wo, k_blk, v_blk)
        lanes["tokens"].copy_(final)
        lanes["keys"].copy_(keys)
        lanes["lengths"].copy_(lengths)
        lanes["hist_len"].copy_(hist_len)
        return emit, logps, acc

    def warmup_state(self, pool, lanes):
        scratch = _lane_copies(lanes)
        scratch["tables"].zero_()  # every write of the warm-up lands in the trash page
        scratch["lengths"].zero_()
        return pool, scratch, self._draft_copy()


class SpecSlotStep(_SpecStep):
    """One speculative round on the slot layout: ``drafter`` and
    ``verify_fn`` from ``spec.verify.make_spec_verify_slots``."""

    LANES = ("tokens", "keys", "temps", "top_k", "top_p", "spec_k", "hist", "hist_len")
    kv_name = "cache"

    def __init__(self, drafter, verify_fn):
        super().__init__(drafter)
        self._verify_fn = verify_fn

    def run(self, params, cache, lanes, draft=None):
        props = self.drafter.propose(lanes["hist"], lanes["hist_len"], cache["length"], cache=draft)
        emit, logps, acc, final, keys, hist_len = self._verify_fn(
            params, cache, props, *(lanes[name] for name in self.LANES))
        lanes["tokens"].copy_(final)
        lanes["keys"].copy_(keys)
        lanes["hist_len"].copy_(hist_len)
        return emit, logps, acc

    def warmup_state(self, cache, lanes):
        return {**cache, "length": cache["length"].clone()}, _lane_copies(lanes), self._draft_copy()


class FusedDecode:
    """One engine's decode step or speculative round: ``step`` (one of
    the step classes above) over ``kv`` (the pool or the slot cache) and
    ``lanes`` (a dict with exactly ``step.LANES``, all on one device). On a
    CUDA device the step is captured here (unless ``capture=False``: then
    it runs eagerly there too); ``capture_s`` is what that took (warm-up
    included) and ``captures`` how many captures there have been (1 after
    this one)."""

    def __init__(self, step, params, kv, lanes: dict, capture: bool = True):
        if set(lanes) != set(step.LANES):
            raise ValueError(f"lanes must be exactly {step.LANES}, got {sorted(lanes)}")
        self._step = step
        self.params, self.kv, self.lanes = params, kv, lanes
        self._ptrs = self._addresses(params, kv)
        self.device = lanes["tokens"].device
        self.capture_s = 0.0
        self.captures = 0
        self.replays = 0
        self.k4_per_replay = 0
        self._graph = None
        if self.device.type == "cuda" and capture:
            self._capture()

    def _addresses(self, params, kv):
        return (_leaf_ptrs(params) + _leaf_ptrs(kv, f"{self._step.kv_name}/")
                + _leaf_ptrs(self._step.state(), "draft/"))

    @torch.no_grad()
    def _run(self, kv, lanes, draft=None):
        return self._step.run(self.params, kv, lanes, draft)

    def _capture(self):
        t0 = time.perf_counter()
        dev = self.device
        kv, scratch, draft = self._step.warmup_state(self.kv, self.lanes)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(kv, scratch, draft)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del kv, scratch, draft
        before = paged_attn_partials.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._run(self.kv, self.lanes)
        # the capture recorded K4's launches and ran none of them
        self.k4_per_replay = paged_attn_partials.launches - before
        paged_attn_partials.launches = before
        self._host = [(tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in self._out),
                       torch.cuda.Event()) for _ in range(2)]
        self._graph = graph
        self.captures += 1
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def _check(self, params, kv):
        now = self._addresses(params, kv)
        if now != self._ptrs:
            moved = sorted({path for path, _ in set(now) ^ set(self._ptrs)})
            raise RuntimeError(f"decode step: {moved} moved since the step was built; the captured graph "
                               f"reads the old addresses (write the {self._step.kv_name}, the weights and the "
                               f"draft state in place)")

    def step(self, params, kv):
        """Advance every lane one step (one token, or one speculative
        round) and return a handle for ``read``. ``params``, ``kv`` and
        the drafter's state must be the tensors the step was built on, at
        the same addresses: a moved one raises."""
        self._check(params, kv)
        if self._graph is None:
            return self._run(self.kv, self.lanes), None
        self._graph.replay()
        paged_attn_partials.launches += self.k4_per_replay
        bufs, done = self._host[self.replays % 2]
        self.replays += 1
        for buf, out in zip(bufs, self._out):
            buf.copy_(out, non_blocking=True)
        done.record()
        return bufs, done

    @staticmethod
    def read(handle):
        """A step's outputs as host numpy arrays; on the card this waits
        for that step alone."""
        outs, done = handle
        if done is not None:
            done.synchronize()
        return tuple(o.cpu().numpy().copy() for o in outs)
