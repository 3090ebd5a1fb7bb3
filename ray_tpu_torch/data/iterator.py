"""DataIterator: rebatching consumption of a block-ref stream (port of
ray_tpu/data/iterator.py).

The train integration hands each worker a DataIterator (get_dataset_shard).
``iter_torch_batches`` gives host tensors (``torch.as_tensor`` over each
numpy column), as ray_tpu's does; the caller moves them to the card.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, _num_rows


def _rebatch(blocks: Iterator[Block], batch_size: int | None, batch_format: str, drop_last: bool):
    if batch_size is None:
        for b in blocks:
            if _num_rows(b):
                yield BlockAccessor(b).to_batch(batch_format)
        return
    buf: list[Block] = []
    buffered = 0
    for b in blocks:
        if not _num_rows(b):
            continue
        buf.append(b)
        buffered += _num_rows(b)
        while buffered >= batch_size:
            merged = BlockAccessor.concat(buf)
            out = BlockAccessor(merged).slice(0, batch_size)
            rest = BlockAccessor(merged).slice(batch_size, _num_rows(merged))
            yield BlockAccessor(out).to_batch(batch_format)
            buf = [rest] if _num_rows(rest) else []
            buffered = _num_rows(rest)
    if buffered and not drop_last:
        yield BlockAccessor(BlockAccessor.concat(buf)).to_batch(batch_format)


class DataIterator:
    """Iterates a (re-runnable) stream of block refs."""

    def __init__(self, ref_stream_factory):
        self._factory = ref_stream_factory

    def _blocks(self, prefetch: int) -> Iterator[Block]:
        refs = self._factory()
        window: collections.deque = collections.deque()
        for ref in refs:
            window.append(ref)
            if len(window) > prefetch:
                yield ray_tpu_torch.get(window.popleft())
        while window:
            yield ray_tpu_torch.get(window.popleft())

    def iter_batches(
        self,
        *,
        batch_size: int | None = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 2,
        local_shuffle_buffer_size: int | None = None,
        local_shuffle_seed: int | None = None,
    ):
        blocks = self._blocks(prefetch=max(prefetch_batches, 1))
        if local_shuffle_buffer_size:
            blocks = _shuffle_blocks(blocks, local_shuffle_buffer_size, local_shuffle_seed)
        yield from _rebatch(blocks, batch_size, batch_format, drop_last)

    def iter_rows(self):
        for b in self._blocks(prefetch=2):
            yield from BlockAccessor(b).iter_rows()

    def iter_torch_batches(self, *, batch_size: int | None = 256, drop_last: bool = False, **kw):
        import torch

        for batch in self.iter_batches(batch_size=batch_size, batch_format="numpy", drop_last=drop_last, **kw):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def materialize(self):
        from ray_tpu_torch.data.dataset import MaterializedDataset

        return MaterializedDataset(list(self._factory()))


def _shuffle_blocks(blocks: Iterator[Block], buffer_rows: int, seed):
    rng = np.random.default_rng(seed)
    buf: list[Block] = []
    size = 0
    for b in blocks:
        buf.append(b)
        size += _num_rows(b)
        if size >= buffer_rows:
            merged = BlockAccessor.concat(buf)
            yield BlockAccessor(merged).take_indices(rng.permutation(_num_rows(merged)))
            buf, size = [], 0
    if buf:
        merged = BlockAccessor.concat(buf)
        yield BlockAccessor(merged).take_indices(rng.permutation(_num_rows(merged)))


@ray_tpu_torch.remote(max_concurrency=16)
class SplitCoordinator:
    """Serves one executing stream to n consumers (reference:
    _internal/execution/operators/output_splitter.py + streaming_split
    coordinator actor): each consumer pulls its next block ref; assignment
    is round-robin at pull time, so faster consumers do not starve.

    equal=True re-chunks the stream into fixed-row chunks dealt round-robin
    and splits the tail evenly (dropping up to n-1 remainder rows), so every
    consumer sees exactly the same row count, as synchronized SPMD
    training loops need (reference: output_splitter equal splitting)."""

    EQUAL_CHUNK_ROWS = 256
    # bound on one upstream block materializing: the coordinator is an
    # actor, and an unbounded get on a wedged producer would deadlock every
    # consumer behind it with no error surfacing; generous enough for a
    # slow lineage reconstruction, finite so a hang becomes a
    # GetTimeoutError the consumers actually see
    STREAM_GET_TIMEOUT_S = 600.0

    def __init__(self, dataset, n: int, equal: bool, locality_hints=None):
        self.n = n
        self.equal = equal
        self.queues = [collections.deque() for _ in range(n)]
        self._stream = dataset._ref_stream()
        self._pending = None  # equal mode: pulled-but-not-gotten block ref
        self._exhausted = False
        self._next = 0
        self._carry = None  # equal mode: residual rows awaiting a full chunk
        # locality_hints: node-id hex per consumer (reference:
        # output_splitter.py locality-aware bundle routing): blocks whose
        # primary copy lives on a consumer's hinted node go to that
        # consumer, under a BALANCE BOUND: locality is a preference, so a
        # split whose hinted node holds every block cannot starve the
        # others (unmatched / over-budget blocks round-robin)
        if locality_hints is not None:
            if equal:
                raise ValueError("locality_hints are not supported with equal=True (re-chunked rows have no single "
                                 "home node)")
            if len(locality_hints) != n:
                raise ValueError(f"need one locality hint per split: got {len(locality_hints)} for n={n}")
        self._hints = list(locality_hints) if locality_hints else None
        self._assigned = [0] * n
        self.stats = [{"local": 0, "remote": 0} for _ in range(n)]
        self._lock = threading.Lock()

    LOCALITY_SKEW_BOUND = 4  # max extra blocks a hinted split may run ahead

    def _route(self, ref) -> int:
        """Pick the consumer for a freshly pulled block ref (one location
        lookup per block)."""
        if self._hints:
            from ray_tpu_torch.core import context as _ctx

            loc = _ctx.get_client().object_locations([ref.id]).get(ref.id.hex())
            if loc is not None:
                floor = min(self._assigned)
                matches = [
                    i
                    for i, h in enumerate(self._hints)
                    if h == loc and self._assigned[i] - floor < self.LOCALITY_SKEW_BOUND
                ]
                if matches:
                    target = min(matches, key=lambda i: self._assigned[i])
                    self._assigned[target] += 1
                    self.stats[target]["local"] += 1
                    return target
        target = self._next % self.n
        self._next += 1
        self._assigned[target] += 1
        self.stats[target]["remote"] += 1
        return target

    def locality_stats(self):
        return self.stats

    def _pump_equal(self):
        """Pull source blocks until one full round of n chunks is queued, or
        the stream ends (then deal the tail evenly, dropping < n rows)."""
        chunk = self.EQUAL_CHUNK_ROWS
        while not self._exhausted:
            rows = _num_rows(self._carry) if self._carry is not None else 0
            if rows >= chunk * self.n:
                break
            if self._pending is None:
                try:
                    self._pending = next(self._stream)
                except StopIteration:
                    self._exhausted = True
                    break
            # a timeout leaves the ref parked in _pending: the next call
            # re-gets the SAME block, so a slow producer surfaces as an
            # error without silently dropping its rows from the stream
            block = ray_tpu_torch.get(self._pending, timeout=self.STREAM_GET_TIMEOUT_S)
            self._pending = None
            self._carry = block if self._carry is None else BlockAccessor.concat([self._carry, block])
        buf = self._carry
        if buf is None:
            return
        acc = BlockAccessor(buf)
        if not self._exhausted:
            for i in range(self.n):
                self.queues[i].append(ray_tpu_torch.put(acc.slice(i * chunk, (i + 1) * chunk)))
            self._carry = acc.slice(chunk * self.n, _num_rows(buf))
        else:
            per = _num_rows(buf) // self.n
            if per:
                for i in range(self.n):
                    self.queues[i].append(ray_tpu_torch.put(acc.slice(i * per, (i + 1) * per)))
            self._carry = None

    def next_ref(self, split: int):
        """Returns an ObjectRef or None when the stream is exhausted."""
        with self._lock:
            if self.queues[split]:
                return self.queues[split].popleft()
            if self.equal:
                while not self.queues[split]:
                    self._pump_equal()
                    if self._exhausted and not self.queues[split]:
                        return None
                return self.queues[split].popleft()
            while not self._exhausted:
                try:
                    ref = next(self._stream)
                except StopIteration:
                    self._exhausted = True
                    break
                target = self._route(ref)
                if target == split:
                    return ref
                self.queues[target].append(ref)
            return self.queues[split].popleft() if self.queues[split] else None


class SplitIterator(DataIterator):
    def __init__(self, coordinator, split: int):
        self._coord = coordinator
        self._split = split
        super().__init__(self._pull_refs)

    def _pull_refs(self):
        while True:
            ref = ray_tpu_torch.get(self._coord.next_ref.remote(self._split))
            if ref is None:
                return
            yield ref
