"""The device-resident decode step, run from persistent lane tensors: on
the card one CUDA graph per engine, captured once and replayed every
step; on the host the same step, eagerly.

``FusedDecode`` holds the lanes as tensors whose addresses never change:
the scheduler edits them in place between steps (``model_runner.set_lane``
and the other deltas), and the step reads them where the graph recorded
them. What one step is depends on the KV layout:

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

Capture happens once, when the ``FusedDecode`` is built: a warm-up step
first runs eagerly on a side stream, on copies of the lanes (and a copy
of the slot cache's length lane), to do every first-call initialisation
(the kernel library's load and shared memory attribute, K4's cached plan
and SM count, cuBLAS's handle and workspace) outside the capture. Its
writes are harmless: the paged copy's tables point at the trash page;
a slot's write lands at that slot's length, which attention masks until
the slot's next real step writes the same position first. Nothing falls
back: a failed capture or replay raises.

A replay ends with a copy of (tokens, logprobs) into one of two pinned
host buffers, used in turn, each with its CUDA event, so the next step's
replay never overwrites a step that the engine has not read yet (the
engine reads step N after it has dispatched step N + 1).

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


class PagedStep:
    """The paged layout's step over a pool: ``attn_fn, append_fn`` from
    ``model_runner.make_fused_paged_fns``."""

    LANES = ("tables", "lengths", "tokens", "keys", "temps", "top_k", "top_p")
    kv_name = "pool"

    def __init__(self, attn_fn, append_fn):
        self._attn_fn, self._append_fn = attn_fn, append_fn

    def run(self, params, pool, lanes):
        toks, logps, keys, k_new, v_new, write_page, write_off, lengths, *_ = self._attn_fn(
            params, pool, *(lanes[name] for name in self.LANES))
        self._append_fn(pool, write_page, write_off, k_new, v_new)
        lanes["tokens"].copy_(toks)
        lanes["keys"].copy_(keys)
        lanes["lengths"].copy_(lengths)
        return toks, logps

    def warmup_state(self, pool, lanes):
        scratch = {name: t.clone() for name, t in lanes.items()}
        scratch["tables"].zero_()  # every write of the warm-up lands in the trash page
        scratch["lengths"].zero_()
        return pool, scratch


class SlotStep:
    """The slot layout's step over a ``kv_cache`` dict: ``fused_fn`` from
    ``model_runner.make_fused_fns``."""

    LANES = ("tokens", "keys", "temps", "top_k", "top_p")
    kv_name = "cache"

    def __init__(self, fused_fn):
        self._fused_fn = fused_fn

    def run(self, params, cache, lanes):
        _, toks, logps, keys, *_ = self._fused_fn(params, cache, *(lanes[name] for name in self.LANES))
        lanes["tokens"].copy_(toks)
        lanes["keys"].copy_(keys)
        return toks, logps

    def warmup_state(self, cache, lanes):
        # the warm-up advances a copy of the length lane: the real one stays
        return {**cache, "length": cache["length"].clone()}, {name: t.clone() for name, t in lanes.items()}


class FusedDecode:
    """One engine's decode step: ``step`` (a ``PagedStep`` or ``SlotStep``)
    over ``kv`` (the pool or the slot cache) and ``lanes`` (a dict with
    exactly ``step.LANES``, all on one device). On a CUDA device the step
    is captured here; ``capture_s`` is what that took (warm-up included)."""

    def __init__(self, step, params, kv, lanes: dict):
        if set(lanes) != set(step.LANES):
            raise ValueError(f"lanes must be exactly {step.LANES}, got {sorted(lanes)}")
        self._step = step
        self.params, self.kv, self.lanes = params, kv, lanes
        self._ptrs = self._addresses(params, kv)
        self.device = lanes["tokens"].device
        self.capture_s = 0.0
        self.replays = 0
        self.k4_per_replay = 0
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    def _addresses(self, params, kv):
        return _leaf_ptrs(params) + _leaf_ptrs(kv, f"{self._step.kv_name}/")

    @torch.no_grad()
    def _run(self, kv, lanes):
        return self._step.run(self.params, kv, lanes)

    def _capture(self):
        t0 = time.perf_counter()
        dev = self.device
        kv, scratch = self._step.warmup_state(self.kv, self.lanes)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(kv, scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del kv, scratch
        before = paged_attn_partials.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._run(self.kv, self.lanes)
        # the capture recorded K4's launches and ran none of them
        self.k4_per_replay = paged_attn_partials.launches - before
        paged_attn_partials.launches = before
        B = self.lanes["tokens"].shape[0]
        self._host = [(torch.empty(B, dtype=self._out[0].dtype, pin_memory=True),
                       torch.empty(B, dtype=self._out[1].dtype, pin_memory=True),
                       torch.cuda.Event()) for _ in range(2)]
        self._graph = graph
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def _check(self, params, kv):
        now = self._addresses(params, kv)
        if now != self._ptrs:
            moved = sorted({path for path, _ in set(now) ^ set(self._ptrs)})
            raise RuntimeError(f"decode step: {moved} moved since the step was built; the captured graph "
                               f"reads the old addresses (write the {self._step.kv_name} and the weights in place)")

    def step(self, params, kv):
        """Advance every lane one token and return a handle for ``read``.
        ``params`` and ``kv`` must be the tensors the step was built on,
        at the same addresses: a moved one raises."""
        self._check(params, kv)
        if self._graph is None:
            return self._run(self.kv, self.lanes)
        self._graph.replay()
        paged_attn_partials.launches += self.k4_per_replay
        toks, logps, done = self._host[self.replays % 2]
        self.replays += 1
        toks.copy_(self._out[0], non_blocking=True)
        logps.copy_(self._out[1], non_blocking=True)
        done.record()
        return toks, logps, done

    @staticmethod
    def read(handle):
        """A step's (tokens, logprobs) as host numpy arrays; on the card
        this waits for that step alone."""
        toks, logps, *done = handle
        if done:
            done[0].synchronize()
        return toks.numpy().copy(), logps.numpy().copy()
