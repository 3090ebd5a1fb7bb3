"""The device-resident decode step, run from persistent lane tensors: on
the card one CUDA graph per engine, captured once and replayed every
step; on the host the same step, eagerly.

``FusedDecode`` holds the lanes (tables, lengths, tokens, keys, temps,
top_k, top_p) as tensors whose addresses never change: the scheduler
edits them in place between steps (``model_runner.set_lane`` and the
other deltas), and the step reads them where the graph recorded them.
One step is the attention half (``paged_fused_step``: K4 over the pages,
``sample``) and the append half (``append_paged``), then the write-back
that ray_tpu does by rebinding donated buffers: the sampled tokens become
the next inputs, the keys advance, every length grows by one. ray_tpu
compiles the two halves as two XLA programs because of buffer-donation
aliasing; on one CUDA stream the append runs after the attention, so
both are captured in one graph.

Capture happens once, when the ``FusedDecode`` is built: a warm-up step
first runs eagerly on a side stream, on copies of the lanes whose tables
point at the trash page (so it writes nothing that a sequence reads), to
do every first-call initialisation (the kernel library's load and shared
memory attribute, K4's cached plan and SM count, cuBLAS's handle and
workspace) outside the capture. Nothing falls back: a failed capture or
replay raises.

A replay ends with a copy of (tokens, logprobs) into one of two pinned
host buffers, used in turn, each with its CUDA event, so the next step's
replay never overwrites a step that the engine has not read yet (the
engine reads step N after it has dispatched step N + 1).

K4's launch counter counts wrapper calls, so a replay adds nothing by
itself: the capture records how many K4 launches one step holds and each
replay adds that many to ``paged_attn_partials.launches``.
"""

from __future__ import annotations

import time

import torch

from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials

LANES = ("tables", "lengths", "tokens", "keys", "temps", "top_k", "top_p")


def _leaf_ptrs(tree, prefix=""):
    """``(path, data_ptr)`` of every tensor in a nested dict."""
    out = []
    for name, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaf_ptrs(value, f"{prefix}{name}/"))
        else:
            out.append((prefix + name, value.data_ptr()))
    return out


class FusedDecode:
    """One engine's decode step over ``lanes`` (a dict with the ``LANES``
    tensors, all on one device). ``attn_fn, append_fn`` come from
    ``model_runner.make_fused_paged_fns``. On a CUDA device the step is
    captured here; ``capture_s`` is what that took (warm-up included)."""

    def __init__(self, attn_fn, append_fn, params, pool, lanes: dict):
        if set(lanes) != set(LANES):
            raise ValueError(f"lanes must be exactly {LANES}, got {sorted(lanes)}")
        self._attn_fn, self._append_fn = attn_fn, append_fn
        self.params, self.pool, self.lanes = params, pool, lanes
        self._ptrs = _leaf_ptrs(params) + _leaf_ptrs(pool, "pool/")
        self.device = lanes["tables"].device
        self.capture_s = 0.0
        self.replays = 0
        self.k4_per_replay = 0
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    @torch.no_grad()
    def _run(self, lanes):
        toks, logps, keys, k_new, v_new, write_page, write_off, lengths, *_ = self._attn_fn(
            self.params, self.pool, *(lanes[name] for name in LANES))
        self._append_fn(self.pool, write_page, write_off, k_new, v_new)
        lanes["tokens"].copy_(toks)
        lanes["keys"].copy_(keys)
        lanes["lengths"].copy_(lengths)
        return toks, logps

    def _capture(self):
        t0 = time.perf_counter()
        dev = self.device
        scratch = {name: t.clone() for name, t in self.lanes.items()}
        scratch["tables"].zero_()  # every write of the warm-up lands in the trash page
        scratch["lengths"].zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        before = paged_attn_partials.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._run(self.lanes)
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

    def _check(self, params, pool):
        now = _leaf_ptrs(params) + _leaf_ptrs(pool, "pool/")
        if now != self._ptrs:
            moved = sorted({path for path, _ in set(now) ^ set(self._ptrs)})
            raise RuntimeError(f"decode step: {moved} moved since the step was built; the captured graph "
                               "reads the old addresses (write the pool and the weights in place)")

    def step(self, params, pool):
        """Advance every lane one token and return a handle for ``read``.
        ``params`` and ``pool`` must be the tensors the step was built on,
        at the same addresses: a moved one raises."""
        self._check(params, pool)
        if self._graph is None:
            return self._run(self.lanes)
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
