"""Streaming execution of dataset plans (port of ray_tpu/data/executor.py).

Operators move ObjectRef[Block]s, not blocks; concurrency is bounded per
operator (backpressure). The pipeline is pull-driven: downstream demand
(iter_batches consuming) is what triggers upstream task submission, with
a sliding in-flight window per stage standing in for the reference's
resource-budget backpressure policies.

The remote functions and the actor class here are module-level, so a
worker imports them by reference; a MapSpec's user callable travels as an
argument under the standard library's pickle (``dataset.py`` refuses at
the ``map*`` call one that cannot). Shuffle, sort and ``_sample_block``
draw from numpy's ``default_rng`` with ray_tpu's seeds, never from torch,
so ``random_shuffle(seed=...)`` and ``sort`` give ray_tpu's order. Joins
bucket rows with ``_native``'s hashes, which equal ray_tpu's, and join
each bucket pair in numpy where ray_tpu calls Arrow's join.
"""

from __future__ import annotations

import collections
import struct
import types
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, _cells, _infer, _num_rows


# ----------------------------------------------------------------------
# logical ops (a linear plan)
# ----------------------------------------------------------------------
@dataclass
class MapSpec:
    kind: str  # map_batches | map | filter | flat_map
    fn: Any  # callable or callable class
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = field(default_factory=dict)
    batch_size: int | None = None
    batch_format: str = "numpy"
    concurrency: int | None = None
    num_cpus: float = 1.0
    zero_copy_batch: bool = False

    @property
    def is_actor_fn(self) -> bool:
        return isinstance(self.fn, type)


@dataclass
class AllToAllSpec:
    kind: str  # repartition | random_shuffle | sort
    options: dict = field(default_factory=dict)


@dataclass
class LimitSpec:
    n: int


# ----------------------------------------------------------------------
# remote kernels
# ----------------------------------------------------------------------
@ray_tpu_torch.remote
def _exec_read_task(task) -> Block:
    return BlockAccessor.concat(list(task()))


def _apply_map(block: Block, spec: MapSpec, fn) -> Block:
    acc = BlockAccessor(block)
    if spec.kind == "map_batches":
        n = acc.num_rows()
        if n == 0:  # empty blocks pass through; user fns assume rows
            return block
        out_blocks = []
        bs = spec.batch_size or n
        for s in range(0, n, bs):
            sub = BlockAccessor(acc.slice(s, min(s + bs, n)))
            batch = sub.to_batch(spec.batch_format)
            res = fn(batch, *spec.fn_args, **spec.fn_kwargs)
            out_blocks.append(BlockAccessor.batch_to_block(res))
        return BlockAccessor.concat(out_blocks)
    if spec.kind == "map":
        rows = [fn(r, *spec.fn_args, **spec.fn_kwargs) for r in acc.iter_rows()]
        return BlockAccessor.rows_to_block(rows)
    if spec.kind == "filter":
        rows = [r for r in acc.iter_rows() if fn(r, *spec.fn_args, **spec.fn_kwargs)]
        return BlockAccessor.rows_to_block(rows) if rows else acc.slice(0, 0)
    if spec.kind == "flat_map":
        rows = [o for r in acc.iter_rows() for o in fn(r, *spec.fn_args, **spec.fn_kwargs)]
        return BlockAccessor.rows_to_block(rows) if rows else acc.slice(0, 0)
    raise ValueError(spec.kind)


@ray_tpu_torch.remote
def _exec_map_task(block: Block, spec: MapSpec) -> Block:
    return _apply_map(block, spec, spec.fn)


@ray_tpu_torch.remote
class _MapActor:
    """Actor-pool worker holding one instance of the user's callable class
    (reference: actor_pool_map_operator.py)."""

    def __init__(self, spec: MapSpec):
        self.spec = spec
        self.fn = spec.fn(*spec.fn_constructor_args, **spec.fn_constructor_kwargs)

    def apply(self, block: Block) -> Block:
        return _apply_map(block, self.spec, self.fn)


@ray_tpu_torch.remote
def _slice_into(block: Block, n: int, shuffle_seed=None) -> list[Block]:
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        assignment = rng.integers(0, n, rows)
        return [acc.take_indices(np.nonzero(assignment == i)[0]) for i in range(n)]
    bounds = [round(i * rows / n) for i in range(n + 1)]
    return [acc.slice(bounds[i], bounds[i + 1]) for i in range(n)]


@ray_tpu_torch.remote
def _merge_blocks(*blocks: Block) -> Block:
    return BlockAccessor.concat(list(blocks))


@ray_tpu_torch.remote
def _merge_shuffle(seed, *blocks: Block) -> Block:
    out = BlockAccessor.concat(list(blocks))
    rng = np.random.default_rng(seed)
    return BlockAccessor(out).take_indices(rng.permutation(_num_rows(out)))


@ray_tpu_torch.remote
def _partition_by_bounds(block: Block, key: str, bounds: list, descending: bool) -> list[Block]:
    acc = BlockAccessor(block)
    col = acc.to_numpy([key])[key]
    idx = [[] for _ in range(len(bounds) + 1)]
    for i, v in enumerate(col):
        j = int(np.searchsorted(bounds, v, side="right"))
        idx[j].append(i)
    parts = [acc.take_indices(np.array(ix, dtype=np.int64)) for ix in idx]
    return parts[::-1] if descending else parts


@ray_tpu_torch.remote
def _sort_block(block: Block, key: str, descending: bool) -> Block:
    acc = BlockAccessor(block)
    col = acc.to_numpy([key])[key]
    order = np.argsort(col, kind="stable")
    if descending:
        order = order[::-1]
    return acc.take_indices(order)


@ray_tpu_torch.remote
def _hash_partition_block(block: Block, keys: list, n: int) -> list[Block]:
    """Split one block into n buckets by key hash (native kernels:
    _native/hashing.cpp; numpy fallback when no compiler)."""
    from ray_tpu_torch._native import combine_hashes, hash_column, partition_indices

    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return [block] * n if n > 1 else block
    h = hash_column(block[keys[0]])
    for k in keys[1:]:
        h = combine_hashes(h, hash_column(block[k]))
    idx, counts = partition_indices(h, n)
    out, start = [], 0
    for c in counts:
        out.append(acc.take_indices(idx[start : start + int(c)]))
        start += int(c)
    return out if n > 1 else out[0]


_JOIN_TYPES = {
    "inner": "inner",
    "left": "left outer",
    "right": "right outer",
    "outer": "full outer",
    "full": "full outer",
}


def _take_or_null(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` with a null where ``idx`` is -1."""
    if len(idx) and (idx < 0).any():
        cells = _cells(col)
        return _infer([None if i < 0 else cells[i] for i in idx.tolist()])
    return col[idx]


def _key_codes(left: np.ndarray, right: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One key column of both sides as int64 codes in one space. Keys
    compare as Arrow's join compares them: floats by their bits (``-0.0``
    is not ``0.0``; a NaN equals a NaN of its bits), and a null matches
    nothing (code -1)."""
    both = np.concatenate([left, right]) if left.dtype == right.dtype != object else None
    if both is not None and both.ndim == 1 and both.dtype.kind in "biuf":
        bits = both.view(f"i{both.itemsize}") if both.dtype.kind == "f" else both
        codes = np.unique(bits, return_inverse=True)[1].reshape(-1).astype(np.int64)
    else:
        cells = _cells(left) + _cells(right)
        real = any(isinstance(v, float) for v in cells)  # Arrow types such a column float64
        seen: dict = {}

        def code(v):
            if v is None:
                return -1
            if real and isinstance(v, (int, float)) and not isinstance(v, bool):
                v = ("float64 bits", struct.unpack("<q", struct.pack("<d", v))[0])
            return seen.setdefault(v, len(seen))

        codes = np.fromiter(map(code, cells), np.int64, len(cells))
    return codes[: len(left)], codes[len(left) :]


def join_blocks(left: Block, right: Block, keys: list, join_type: str) -> Block:
    """Arrow's ``Table.join`` on numpy blocks: rows whose keys are equal
    (a null key matches nothing), the key columns once (coalesced), left's
    columns then right's; an unmatched side's columns are null. The
    right outer join puts left's non-key columns first, then right's
    columns, as Arrow does. Rows come out in left's order, each with its
    matches in right's order, then right's unmatched rows."""
    join_type = _JOIN_TYPES.get(join_type, join_type)
    if join_type not in ("inner", "left outer", "right outer", "full outer"):
        raise ValueError(f"unsupported join type {join_type!r}")
    clash = [c for c in right if c in left and c not in keys]
    if clash:
        raise ValueError(f"columns {clash} are on both sides of the join and are not keys")
    n_left, n_right = _num_rows(left), _num_rows(right)
    code = None
    for k in keys:  # one code per distinct key tuple, -1 where any part is null
        c = np.concatenate(_key_codes(left[k], right[k]))
        if code is not None:
            c = np.where((code < 0) | (c < 0), -1, code * (int(c.max(initial=0)) + 1) + c)
            c[c >= 0] = np.unique(c[c >= 0], return_inverse=True)[1].reshape(-1)
        code = c
    lcode, rcode = code[:n_left], code[n_left:]
    order = np.argsort(rcode, kind="stable")  # right's rows by key, nulls first, each key's rows in right's order
    per_key = np.bincount(rcode[rcode >= 0], minlength=int(code.max(initial=-1)) + 2)  # the last counts no row
    first = np.cumsum(per_key) - per_key + int((rcode < 0).sum())  # each key's first row in ``order``
    slot = np.where(lcode >= 0, lcode, len(per_key) - 1)
    lo, hits = first[slot], per_key[slot]
    keep = join_type in ("left outer", "full outer")
    counts = np.where(hits > 0, hits, int(keep))
    li = np.repeat(np.arange(n_left, dtype=np.int64), counts)
    offset = np.arange(len(li), dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    hit = np.repeat(hits, counts) > 0
    rj = np.full(len(li), -1, np.int64)
    rj[hit] = order[(np.repeat(lo, counts) + offset)[hit]]
    if join_type in ("right outer", "full outer"):
        matched = np.zeros(n_right, bool)
        matched[rj[rj >= 0]] = True
        rest = np.flatnonzero(~matched)
        li = np.concatenate([li, np.full(len(rest), -1, np.int64)])
        rj = np.concatenate([rj, rest.astype(np.int64)])
    out = {}

    def key_col(k):
        lc, rc = _take_or_null(left[k], li), _take_or_null(right[k], rj)
        if not (li < 0).any():
            return lc
        return _infer([r if l is None else l for l, r in zip(_cells(lc), _cells(rc))])

    if join_type == "right outer":
        for c in left:
            if c not in keys:
                out[c] = _take_or_null(left[c], li)
        for c in right:
            out[c] = key_col(c) if c in keys else _take_or_null(right[c], rj)
        return out
    for c in left:
        out[c] = key_col(c) if c in keys else _take_or_null(left[c], li)
    for c in right:
        if c not in keys:
            out[c] = _take_or_null(right[c], rj)
    return out


@ray_tpu_torch.remote
def _join_buckets(how: str, keys: list, n_left: int, *blocks: Block) -> Block:
    """Join one aligned bucket pair: blocks[:n_left] vs blocks[n_left:]."""
    left = BlockAccessor.concat(list(blocks[:n_left]))
    right = BlockAccessor.concat(list(blocks[n_left:]))
    return join_blocks(left, right, keys, how)


@ray_tpu_torch.remote
def _sample_block(block: Block, key: str, k: int):
    acc = BlockAccessor(block)
    col = acc.to_numpy([key])[key]
    if len(col) <= k:
        return list(col)
    rng = np.random.default_rng(0)
    return list(rng.choice(col, size=k, replace=False))


# ----------------------------------------------------------------------
# streaming pipeline
# ----------------------------------------------------------------------
class _OpResourcePool:
    """Process-wide memory pool DYNAMICALLY shared by every active stage
    (reference: streaming_executor_state.py:745 under_resource_limits over
    resource_manager.py's per-op budgets): each live OpBudget reports its
    estimated in-flight bytes; a stage's share is whatever the pool still
    has, so one active op can use the whole budget while an idle pipeline
    neighbor releases its claim."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._usage: dict[int, int] = {}  # id(OpBudget) -> est. in-flight bytes

    def report(self, op_id: int, inflight_bytes: int):
        with self._lock:
            self._usage[op_id] = int(inflight_bytes)

    def release(self, op_id: int):
        with self._lock:
            self._usage.pop(op_id, None)

    def available(self, op_id: int, total_budget: int) -> int:
        with self._lock:
            others = sum(v for k, v in self._usage.items() if k != op_id)
        return max(0, total_budget - others)


_op_pool = _OpResourcePool()


class OpBudget:
    """Resource-aware in-flight budget for one pipeline stage (reference:
    _internal/execution/streaming_executor_state.py:745 under_resource
    _limits + resource_manager.py). Constraints, re-evaluated as blocks
    are observed:
    - CPU: in-flight tasks <= cluster CPUs / task num_cpus (+ headroom),
    - memory: in-flight bytes <= the share of the GLOBAL object-store
      budget the other active stages are not using (running mean of
      observed block sizes x in-flight count, reported to _op_pool).
    An explicit user `concurrency=` wins outright.
    """

    MIN_WINDOW = 2
    MAX_WINDOW = 64

    def __init__(self, num_cpus_per_task: float = 1.0, explicit: int | None = None, num_stages: int = 1):
        self.explicit = explicit
        self._block_bytes_sum = 0
        self._block_count = 0
        try:
            from ray_tpu_torch._config import get_config

            cpus = float(ray_tpu_torch.cluster_resources().get("CPU", 4))
            store_budget = get_config().object_store_memory
        except Exception:
            cpus, store_budget = 4.0, 2 << 30
        self._cpu_cap = max(self.MIN_WINDOW, int(cpus / max(num_cpus_per_task, 0.25)) + 1)
        # the pool-wide memory budget; this op's share is computed live
        self._total_budget = max(64 << 20, store_budget // 2)
        self._floor = max(64 << 20, self._total_budget // (4 * max(num_stages, 1)))

    def _mean_block(self) -> float:
        return self._block_bytes_sum / self._block_count if self._block_count else 0.0

    def set_inflight(self, n: int):
        """Report this stage's in-flight estimate to the shared pool."""
        _op_pool.report(id(self), int(n * self._mean_block()))

    def close(self):
        _op_pool.release(id(self))

    def try_observe(self, ref) -> bool:
        """Record a block's size if it is sealed in the store yet; returns
        whether it was (unsealed blocks are retried on later ticks so the
        big slow blocks are not systematically missed)."""
        try:
            from ray_tpu_torch.core import context

            entry = context.get_client().store.try_get_entry(ref.id)
            size = entry.size() if entry is not None else 0
        except Exception:
            return True  # unobservable: don't retry forever
        if size <= 0:
            return False
        self._block_bytes_sum += size
        self._block_count += 1
        return True

    @property
    def window(self) -> int:
        if self.explicit:
            return self.explicit
        w = self._cpu_cap
        if self._block_count:
            mean = self._mean_block()
            # dynamic share: whatever the other active stages aren't
            # using right now, never below a per-stage floor (liveness)
            share = max(self._floor, _op_pool.available(id(self), self._total_budget))
            w = min(w, int(share / max(mean, 1)))
        return max(self.MIN_WINDOW, min(self.MAX_WINDOW, w))


def _windowed(submits: Iterator, budget: "OpBudget | int"):
    """Submit lazily, keep <= budget.window tasks in flight, yield in
    order. The budget adapts to block sizes observed as yielded blocks
    seal in the store (checked on later ticks: a just-yielded block is
    usually still running)."""
    if isinstance(budget, int):
        budget = OpBudget(explicit=budget)
    inflight = collections.deque()
    unobserved = collections.deque()

    def sweep():
        for _ in range(len(unobserved)):
            ref = unobserved.popleft()
            if not budget.try_observe(ref):
                unobserved.append(ref)

    try:
        for submit in submits:
            inflight.append(submit())
            sweep()
            budget.set_inflight(len(inflight) + len(unobserved))
            while len(inflight) >= budget.window:
                ref = inflight.popleft()
                unobserved.append(ref)
                yield ref
        while inflight:
            yield inflight.popleft()
    finally:
        budget.close()  # release this stage's pool claim


@ray_tpu_torch.remote
def _split_block(block: Block, n: int):
    """Split one oversized block into n row-balanced chunks (dynamic block
    splitting at target_max_block_size). take_indices (not slice) so each
    chunk owns its buffers and ships only its own rows."""
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    bounds = [round(i * rows / n) for i in range(n + 1)]
    return tuple(acc.take_indices(np.arange(bounds[i], bounds[i + 1])) for i in range(n))


# blocks split by _split_oversized in this process, and the chunks they became
split_stats = types.SimpleNamespace(blocks=0, chunks=0)


def _split_oversized(upstream: Iterator, target_bytes: int) -> Iterator:
    """Transparently replace any block that SEALED above target_bytes with
    ~target-sized chunks. Unsealed blocks park briefly (re-checked each
    tick) so slow big blocks are not systematically missed; stragglers
    split at stream end."""
    from ray_tpu_torch.core import context, direct

    def entry_size(ref):
        """-1 = still running; 0 = completed small (owned/inline: below
        the split target by construction); >0 = sealed store entry size."""
        k = ref.id.binary()
        ready = direct.owned_ready(k)
        if ready is True:
            return 0  # direct-plane inline result: < 100KB by protocol
        if ready is False:
            return -1  # direct call still in flight
        try:
            entry = context.get_client().store.try_get_entry(ref.id)
            return entry.size() if entry is not None else -1
        except Exception:
            return 0

    def maybe_split(ref, size):
        n = -(-size // target_bytes)
        if n <= 1:
            return [ref]
        split_stats.blocks += 1
        split_stats.chunks += int(n)
        return list(_split_block.options(num_returns=int(n)).remote(ref, int(n)))

    # FIFO with head-of-line gating: block order is part of Dataset
    # semantics, so a block whose size is still unknown holds later ones
    # back (they are already submitted upstream, so execution still
    # overlaps; only the yield order waits)
    pending = collections.deque()
    for ref in upstream:
        pending.append(ref)
        while pending:
            size = entry_size(pending[0])
            if size < 0:
                break  # head still running; keep order
            yield from maybe_split(pending.popleft(), size)

    while pending:
        r = pending.popleft()
        size = entry_size(r)
        if size < 0:
            ray_tpu_torch.wait([r], num_returns=1, timeout=None)  # force seal
            size = max(entry_size(r), 0)
        yield from maybe_split(r, size)


def _read_submit(task):
    return lambda: _exec_read_task.remote(task)


def execute_plan(source_tasks: list, ops: list) -> Iterator:
    """Returns an iterator of ObjectRef[Block]. Pulling drives execution."""
    from ray_tpu_torch._config import get_config

    num_stages = 1 + sum(isinstance(op, MapSpec) for op in ops)
    target = get_config().target_max_block_size
    stream: Iterator = _windowed((_read_submit(t) for t in source_tasks), OpBudget(num_stages=num_stages))
    if target > 0:
        stream = _split_oversized(stream, target)
    for op in ops:
        if isinstance(op, MapSpec):
            stream = _map_stage(stream, op, num_stages)
            if target > 0:
                stream = _split_oversized(stream, target)
        elif isinstance(op, LimitSpec):
            stream = _limit_stage(stream, op.n)
        elif isinstance(op, AllToAllSpec):
            stream = _all_to_all_stage(stream, op)
        else:
            raise TypeError(f"unknown op {op}")
    return stream


def _map_stage(upstream: Iterator, spec: MapSpec, num_stages: int = 1) -> Iterator:
    if spec.is_actor_fn:
        n_actors = spec.concurrency or 2
        window = max(spec.concurrency or 0, n_actors * 2)  # int: actor pool depth
    elif spec.concurrency:
        window = spec.concurrency  # explicit user bound wins outright
    else:
        window = OpBudget(num_cpus_per_task=spec.num_cpus, num_stages=num_stages)
    if spec.is_actor_fn:
        actors = [_MapActor.options(num_cpus=spec.num_cpus).remote(spec) for _ in range(n_actors)]
        rr = iter(range(10**12))
        submitted: list = []

        def submits():
            for ref in upstream:
                def sub(ref=ref):
                    out = actors[next(rr) % n_actors].apply.remote(ref)
                    submitted.append(out)
                    return out

                yield sub

        def gen():
            try:
                yield from _windowed(submits(), window)
            finally:
                # results must be sealed in the object store before the
                # producing actors die, else consumers see ActorDiedError
                try:
                    ray_tpu_torch.wait(submitted, num_returns=len(submitted), timeout=None)
                except Exception:
                    pass
                for a in actors:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass

        return gen()

    task = _exec_map_task.options(num_cpus=spec.num_cpus)

    def submit_local(ref):
        """Prefer the node holding the input block (soft affinity: falls
        back to any node if that one is busy/gone), so the map task maps
        the block's segment where it lies (reference: locality-aware
        dispatch in the streaming executor)."""
        loc = _block_location(ref)
        if loc is not None:
            from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

            return task.options(
                num_cpus=spec.num_cpus,
                scheduling_strategy=NodeAffinitySchedulingStrategy(node_id=loc, soft=True),
            ).remote(ref, spec)
        return task.remote(ref, spec)

    def submits():
        for ref in upstream:
            yield lambda ref=ref: submit_local(ref)

    return _windowed(submits(), window)


def _block_location(ref) -> str | None:
    """Node-id hex of the block's primary copy, if known (sealed)."""
    try:
        from ray_tpu_torch.core import context as _ctx

        return _ctx.get_client().object_locations([ref.id]).get(ref.id.hex())
    except Exception:
        return None


@ray_tpu_torch.remote
def _block_rows(block: Block) -> int:
    return _num_rows(block)


@ray_tpu_torch.remote
def _head_block(block: Block, n: int) -> Block:
    return BlockAccessor(block).slice(0, n)


def _limit_stage(upstream: Iterator, n: int) -> Iterator:
    remaining = n
    for ref in upstream:
        if remaining <= 0:
            break
        rows = ray_tpu_torch.get(_block_rows.remote(ref))
        if rows <= remaining:
            remaining -= rows
            yield ref  # pass-through: no payload round-trip off the store
        else:
            yield _head_block.remote(ref, remaining)
            remaining = 0


def _all_to_all_stage(upstream: Iterator, spec: AllToAllSpec) -> Iterator:
    refs = list(upstream)  # barrier: all-to-all needs the full input
    kind = spec.kind
    if kind == "repartition":
        n = spec.options["num_blocks"]
        if n == 1:
            yield _merge_blocks.remote(*refs)
            return
        parts = [_slice_into.options(num_returns=n).remote(r, n) for r in refs]
        for i in range(n):
            yield _merge_blocks.remote(*[p[i] for p in parts])
    elif kind == "random_shuffle":
        import os as _os

        seed = spec.options.get("seed")
        n = max(len(refs), 1)
        # seed=None draws fresh entropy: re-shuffles differ per epoch/run
        base = seed if seed is not None else int.from_bytes(_os.urandom(4), "little")
        if n == 1:
            yield _merge_shuffle.remote(base, *refs)
            return
        parts = [
            _slice_into.options(num_returns=n).remote(r, n, base + 17 * i) for i, r in enumerate(refs)
        ]
        for i in range(n):
            yield _merge_shuffle.remote(base + i, *[p[i] for p in parts])
    elif kind == "sort":
        key = spec.options["key"]
        desc = spec.options.get("descending", False)
        n = len(refs)
        if n == 0:
            return
        if n > 1:
            sample_refs = [_sample_block.remote(ref, key, 16) for ref in refs]
            samples = sorted(s for chunk in ray_tpu_torch.get(sample_refs) for s in chunk)
            m = len(samples)
            bounds = [samples[min(round(i * m / n), m - 1)] for i in range(1, n)] if samples else []
        if n == 1 or not bounds:
            yield _sort_block.remote(_merge_blocks.remote(*refs), key, desc)
            return
        parts = [
            _partition_by_bounds.options(num_returns=n).remote(r, key, bounds, desc) for r in refs
        ]
        for i in range(n):
            yield _sort_block.remote(_merge_blocks.remote(*[p[i] for p in parts]), key, desc)
    else:
        raise ValueError(kind)
