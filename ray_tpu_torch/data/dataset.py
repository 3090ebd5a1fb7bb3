"""Dataset: the lazy, streaming distributed dataset (port of
ray_tpu/data/dataset.py).

A lazy logical plan, executed by the streaming executor on iteration or
materialize. Transforms return new Datasets sharing the upstream plan
(immutable).

**UDFs travel by reference.** ray_tpu ships a UDF by value; the port
pickles a MapSpec with the standard library, which sends a function or
class as its module and qualified name. So ``map``, ``map_batches``,
``filter``, ``flat_map`` and ``add_column`` check their callable when
called, before anything runs: a function or class as
``core/serialization.py::code_ref`` checks a remote function (a lambda, a
closure or a file-less ``__main__``'s function raises TypeError naming
the difference), anything else (a ``functools.partial``, a callable
instance) by pickling it. ray_tpu's own ops that built closures
(``add_column``, ``drop_columns``, ``select_columns``,
``rename_columns``, ``MaterializedDataset``'s read tasks) hold
module-level callables with their arguments here.

Group-bys aggregate in numpy (ray_tpu's go through pandas) with pandas'
defaults: groups in key order, null keys dropped.
"""

from __future__ import annotations

import builtins
import functools
import inspect
import pickle
from typing import Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, _cells, _infer, _need, _num_rows
from ray_tpu_torch.data.datasource import Datasource, ReadTask, _one_block
from ray_tpu_torch.data.executor import AllToAllSpec, LimitSpec, MapSpec, execute_plan
from ray_tpu_torch.data.iterator import DataIterator, SplitCoordinator, SplitIterator


def check_udf(fn, what: str = "UDF"):
    """TypeError, at the call that takes ``fn``, when a worker could not
    receive it (UDFs travel by reference; module docstring)."""
    from ray_tpu_torch.core.serialization import _DIFFERENCE, code_ref

    if inspect.isfunction(fn) or inspect.isclass(fn):
        code_ref(fn)
        return
    try:
        pickle.dumps(fn, protocol=5)
    except Exception as e:  # noqa: BLE001
        raise TypeError(f"the {what} {fn!r} cannot be sent to a worker: pickling it failed ({e}). Use a function "
                        f"or class defined at the top level of a module. {_DIFFERENCE}") from e


class _AddColumn:
    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn

    def __call__(self, batch):
        batch[self.name] = self.fn(batch)
        return batch


class _DropColumns:
    def __init__(self, cols):
        self.cols = list(cols)

    def __call__(self, batch):
        return {k: v for k, v in batch.items() if k not in self.cols}


class _SelectColumns:
    def __init__(self, cols):
        self.cols = list(cols)

    def __call__(self, batch):
        return {k: batch[k] for k in self.cols}


class _RenameColumns:
    def __init__(self, mapping: dict):
        self.mapping = dict(mapping)

    def __call__(self, batch):
        return {self.mapping.get(k, k): v for k, v in batch.items()}


class Dataset:
    def __init__(self, source_tasks: list[ReadTask], ops: tuple = ()):
        self._source_tasks = source_tasks
        self._ops = tuple(ops)

    # ---------------- plan building ----------------
    def _with_op(self, op) -> "Dataset":
        return Dataset(self._source_tasks, self._ops + (op,))

    def map_batches(
        self,
        fn: Callable | type,
        *,
        batch_size: int | None = None,
        batch_format: str = "numpy",
        concurrency: int | None = None,
        num_cpus: float = 1.0,
        fn_args: tuple = (),
        fn_kwargs: dict | None = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: dict | None = None,
        zero_copy_batch: bool = False,
    ) -> "Dataset":
        check_udf(fn, "map_batches UDF")
        return self._with_op(
            MapSpec(
                "map_batches",
                fn,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs or {},
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs or {},
                batch_size=batch_size,
                batch_format=batch_format,
                concurrency=concurrency,
                num_cpus=num_cpus,
                zero_copy_batch=zero_copy_batch,
            )
        )

    def map(self, fn, *, concurrency=None, num_cpus: float = 1.0, fn_args=(), fn_kwargs=None) -> "Dataset":
        check_udf(fn, "map UDF")
        return self._with_op(
            MapSpec("map", fn, fn_args=fn_args, fn_kwargs=fn_kwargs or {}, concurrency=concurrency, num_cpus=num_cpus)
        )

    def filter(self, fn, *, concurrency=None, fn_args=(), fn_kwargs=None) -> "Dataset":
        check_udf(fn, "filter UDF")
        return self._with_op(MapSpec("filter", fn, fn_args=fn_args, fn_kwargs=fn_kwargs or {}, concurrency=concurrency))

    def flat_map(self, fn, *, concurrency=None, fn_args=(), fn_kwargs=None) -> "Dataset":
        check_udf(fn, "flat_map UDF")
        return self._with_op(MapSpec("flat_map", fn, fn_args=fn_args, fn_kwargs=fn_kwargs or {},
                                     concurrency=concurrency))

    def add_column(self, name: str, fn) -> "Dataset":
        check_udf(fn, "add_column function")
        return self.map_batches(_AddColumn(name, fn), batch_format="pandas")

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(_DropColumns(cols))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(_SelectColumns(cols))

    def rename_columns(self, mapping: dict) -> "Dataset":
        return self.map_batches(_RenameColumns(mapping))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(LimitSpec(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(AllToAllSpec("repartition", {"num_blocks": num_blocks}))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return self._with_op(AllToAllSpec("random_shuffle", {"seed": seed}))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with_op(AllToAllSpec("sort", {"key": key, "descending": descending}))

    def union(self, *others: "Dataset") -> "Dataset":
        """Only unions of plain (un-transformed or materialized) datasets
        keep laziness; otherwise operands materialize."""
        all_tasks = list(self._materialized_tasks())
        for o in others:
            all_tasks += o._materialized_tasks()
        return Dataset(all_tasks)

    def join(self, other: "Dataset", on, how: str = "inner", *, num_partitions: int | None = None) -> "Dataset":
        """Distributed hash-shuffle join. Both sides are partitioned on the
        key columns with the native row hasher (``_native``: FNV-1a over
        string and bytes keys, splitmix64 over numeric bit patterns, the
        same values as ray_tpu's), and aligned buckets are joined in
        parallel tasks (``executor.join_blocks``).

        how: inner | left | right | outer (plus Arrow's full names)."""
        from ray_tpu_torch._native import MAX_PARTITIONS
        from ray_tpu_torch.data.executor import _hash_partition_block, _join_buckets

        on = [on] if isinstance(on, str) else list(on)
        left_refs = list(self._ref_stream())
        right_refs = list(other._ref_stream())
        if not left_refs or not right_refs:
            # an empty side has no schema to join against: inner joins are
            # empty by definition; outer joins cannot synthesize the
            # missing side's columns
            if how == "inner":
                return MaterializedDataset([])
            raise ValueError(
                f"{how} join with an empty-side dataset is unsupported: the "
                "empty side has no schema to pad from"
            )
        P = min(num_partitions or max(len(left_refs), len(right_refs), 2), MAX_PARTITIONS)
        lparts = [_hash_partition_block.options(num_returns=P).remote(r, on, P) for r in left_refs]
        rparts = [_hash_partition_block.options(num_returns=P).remote(r, on, P) for r in right_refs]
        if P == 1:
            lparts = [[p] for p in lparts]
            rparts = [[p] for p in rparts]
        out = [
            _join_buckets.remote(how, on, len(lparts), *[lp[i] for lp in lparts], *[rp[i] for rp in rparts])
            for i in builtins.range(P)
        ]
        return MaterializedDataset(out)

    def zip(self, other: "Dataset") -> "Dataset":
        left = self.materialize()
        right = other.materialize()
        lt = BlockAccessor.concat(ray_tpu_torch.get(left._refs))
        rt = BlockAccessor.concat(ray_tpu_torch.get(right._refs))
        if _num_rows(lt) != _num_rows(rt):
            raise ValueError(f"zip row mismatch: {_num_rows(lt)} vs {_num_rows(rt)}")
        merged = dict(lt)
        for name, col in rt.items():
            merged[name if name not in lt else f"{name}_1"] = col
        return _from_blocks([merged])

    # ---------------- execution ----------------
    def _ref_stream(self):
        return execute_plan(list(self._source_tasks), list(self._ops))

    def _materialized_tasks(self) -> list[ReadTask]:
        if not self._ops:
            return list(self._source_tasks)
        mat = self.materialize()
        return mat._materialized_tasks()

    def iterator(self) -> DataIterator:
        return DataIterator(self._ref_stream)

    def iter_batches(self, **kw):
        return self.iterator().iter_batches(**kw)

    def iter_rows(self):
        return self.iterator().iter_rows()

    def iter_torch_batches(self, **kw):
        return self.iterator().iter_torch_batches(**kw)

    def materialize(self) -> "MaterializedDataset":
        return MaterializedDataset(list(self._ref_stream()))

    def take(self, n: int = 20) -> list[dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20, batch_format: str = "numpy"):
        for b in self.iter_batches(batch_size=batch_size, batch_format=batch_format):
            return b
        return {}

    def count(self) -> int:
        # submit all count kernels first, then one batched get (keeps the
        # streaming window full instead of serializing on each block)
        refs = [_count_block.remote(r) for r in self._ref_stream()]
        return sum(ray_tpu_torch.get(refs))

    def schema(self):
        for ref in self._ref_stream():
            return BlockAccessor(ray_tpu_torch.get(ref)).schema()
        return None

    def columns(self) -> list[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    # ---------------- aggregations ----------------
    def _agg(self, col: str, kind: str):
        refs = [_agg_block.remote(r, col, kind) for r in self._ref_stream()]
        vals = [v for v in ray_tpu_torch.get(refs) if v is not None]
        if not vals:
            return None
        if kind in ("sum", "count"):
            return sum(vals)
        if kind == "min":
            return min(vals)
        if kind == "max":
            return max(vals)
        if kind == "sum_count":  # single-pass mean support
            return (sum(s for s, _ in vals), sum(c for _, c in vals))
        raise ValueError(kind)

    def sum(self, col: str):
        return self._agg(col, "sum")

    def min(self, col: str):
        return self._agg(col, "min")

    def max(self, col: str):
        return self._agg(col, "max")

    def mean(self, col: str):
        # one pass over the plan (sum+count per block), not two executions
        out = self._agg(col, "sum_count")
        if out is None:
            return None
        s, c = out
        return None if not c else s / c

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # ---------------- splits ----------------
    def split(self, n: int, *, equal: bool = False) -> list["MaterializedDataset"]:
        refs = list(self._ref_stream())
        if equal:
            total = BlockAccessor.concat(ray_tpu_torch.get(refs))
            rows = _num_rows(total) - (_num_rows(total) % n)
            per = rows // n
            return [
                MaterializedDataset([ray_tpu_torch.put(BlockAccessor(total).slice(i * per, (i + 1) * per))])
                for i in builtins.range(n)
            ]
        outs = [[] for _ in builtins.range(n)]
        for i, r in enumerate(refs):
            outs[i % n].append(r)
        return [MaterializedDataset(o) for o in outs]

    def streaming_split(self, n: int, *, equal: bool = False, locality_hints=None) -> list[DataIterator]:
        """locality_hints: one node-id hex per split; each block routes to
        the split whose hinted node holds its primary copy (reference:
        streaming_split locality_hints -> output_splitter routing)."""
        coord = SplitCoordinator.remote(self, n, equal, locality_hints)
        return [SplitIterator(coord, i) for i in builtins.range(n)]

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        mat = ds.materialize()  # single plan execution; count from the blocks
        merged = BlockAccessor.concat(ray_tpu_torch.get(mat._refs))
        total = _num_rows(merged)
        k = int(total * (1 - test_size))
        acc = BlockAccessor(merged)
        return (
            MaterializedDataset([ray_tpu_torch.put(acc.slice(0, k))]),
            MaterializedDataset([ray_tpu_torch.put(acc.slice(k, total))]),
        )

    # ---------------- writes ----------------
    def _write(self, path: str, fmt: str):
        import os

        os.makedirs(path, exist_ok=True)
        refs = [_write_block.remote(ref, path, i, fmt) for i, ref in enumerate(self._ref_stream())]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str):
        return self._write(path, "parquet")

    def write_csv(self, path: str):
        return self._write(path, "csv")

    def write_json(self, path: str):
        return self._write(path, "json")

    def to_pandas(self):
        return BlockAccessor(BlockAccessor.concat(ray_tpu_torch.get(list(self._ref_stream())))).to_pandas()

    def to_arrow_refs(self):
        return list(self._ref_stream())

    def __repr__(self):
        ops = " -> ".join(type(o).__name__ for o in self._ops) or "read"
        return f"Dataset({len(self._source_tasks)} source tasks, plan: {ops})"


class MaterializedDataset(Dataset):
    """A dataset whose blocks already exist in the object store."""

    def __init__(self, refs: list):
        self._refs = refs
        super().__init__([ReadTask(None) for _ in refs])

    def _ref_stream(self):
        if self._ops:
            return execute_plan_from_refs(self._refs, list(self._ops))
        return iter(self._refs)

    def _with_op(self, op):
        out = MaterializedDataset(self._refs)
        out._ops = self._ops + (op,)
        return out

    def _materialized_tasks(self):
        if self._ops:
            return self.materialize()._materialized_tasks()
        return [ReadTask(functools.partial(_one_block, b), num_rows=None) for b in ray_tpu_torch.get(self._refs)]

    def num_blocks(self) -> int:
        return len(self._refs)


def execute_plan_from_refs(refs, ops):
    return execute_plan([], ops) if not refs else _execute_from_refs(refs, ops)


def _execute_from_refs(refs, ops):
    from ray_tpu_torch.data import executor as ex

    stream = iter(refs)
    for op in ops:
        if isinstance(op, MapSpec):
            stream = ex._map_stage(stream, op)
        elif isinstance(op, LimitSpec):
            stream = ex._limit_stage(stream, op.n)
        elif isinstance(op, AllToAllSpec):
            stream = ex._all_to_all_stage(stream, op)
    return stream


def _groups(block: Block, key: str):
    """(order, starts, counts, keys) of ``block``'s rows grouped by ``key``
    in key order, rows with a null (or NaN) key dropped (pandas'
    ``groupby(sort=True)``)."""
    col = block[key]
    cells = _cells(col)
    keep = np.asarray([v is not None and v == v for v in cells], bool)
    rows = np.flatnonzero(keep)
    sub = col[rows] if col.dtype != object else _infer([cells[i] for i in rows.tolist()])
    order = rows[np.argsort(sub, kind="stable")]
    sk = [cells[i] for i in order.tolist()]
    starts = [i for i in builtins.range(len(sk)) if i == 0 or sk[i] != sk[i - 1]]
    counts = np.diff(np.asarray(starts + [len(sk)], np.int64))
    return order, np.asarray(starts, np.int64), counts, [sk[i] for i in starts]


_REDUCE = {"sum": np.add, "min": np.minimum, "max": np.maximum}


def _aggregate(values: np.ndarray, starts: np.ndarray, counts: np.ndarray, how: str) -> np.ndarray:
    if values.dtype != object and values.dtype.kind in "biuf" and len(starts):
        if how == "mean":
            return np.add.reduceat(values.astype(np.float64), starts) / counts
        if values.dtype.kind == "b" and how == "sum":
            values = values.astype(np.int64)
        return _REDUCE[how].reduceat(values, starts)
    cells = _cells(values)
    ends = np.append(starts[1:], len(cells)).tolist()
    groups = [cells[s:e] for s, e in zip(starts.tolist(), ends)]
    if how == "mean":
        return _infer([sum(g) / len(g) for g in groups])
    if how == "sum":
        return _infer([functools.reduce(lambda a, b: a + b, g) for g in groups])
    return _infer([builtins.min(g) if how == "min" else builtins.max(g) for g in groups])


class GroupedData:
    """Group-bys over the dataset sorted by the key (reference:
    data/grouped_data.py); aggregated in numpy."""

    def __init__(self, ds: Dataset, key: str):
        self.ds = ds
        self.key = key

    def _grouped_blocks(self):
        sorted_ds = self.ds.sort(self.key)
        return list(sorted_ds._ref_stream())

    def _apply(self, agg_fn_name: str, cols: list[str] | None):
        merged = BlockAccessor.concat(ray_tpu_torch.get(self._grouped_blocks()))
        if not _num_rows(merged):
            return _from_blocks([{}])
        order, starts, counts, keys = _groups(merged, self.key)
        out = {self.key: _infer(keys)}
        if agg_fn_name == "count":
            out["count()"] = counts
        else:
            cols = cols or [c for c in merged if c != self.key]
            for c in cols:
                out[f"{agg_fn_name}({c})"] = _aggregate(merged[c][order], starts, counts, agg_fn_name)
        return _from_blocks([out])

    def count(self):
        return self._apply("count", None)

    def sum(self, *cols):
        return self._apply("sum", list(cols) or None)

    def mean(self, *cols):
        return self._apply("mean", list(cols) or None)

    def min(self, *cols):
        return self._apply("min", list(cols) or None)

    def max(self, *cols):
        return self._apply("max", list(cols) or None)

    def map_groups(self, fn, *, batch_format: str = "pandas"):
        merged = BlockAccessor.concat(ray_tpu_torch.get(self._grouped_blocks()))
        order, starts, counts, _ = _groups(merged, self.key) if _num_rows(merged) else ([], [], [], [])
        outs = []
        for s, c in zip(starts, counts):
            group = BlockAccessor(merged).take_indices(order[s : s + c])
            res = fn(BlockAccessor(group).to_batch(batch_format))
            outs.append(BlockAccessor.batch_to_block(res))
        return MaterializedDataset([ray_tpu_torch.put(b) for b in outs])


# ----------------------------------------------------------------------
# remote kernels for terminal ops
# ----------------------------------------------------------------------
@ray_tpu_torch.remote
def _count_block(block: Block) -> int:
    return _num_rows(block)


@ray_tpu_torch.remote
def _agg_block(block: Block, col: str, kind: str):
    if _num_rows(block) == 0:
        return None
    vals = block[col]
    if kind == "sum":
        return vals.sum()
    if kind == "min":
        return vals.min()
    if kind == "max":
        return vals.max()
    if kind == "count":
        return len(vals)
    if kind == "sum_count":
        return (vals.sum(), len(vals))


@ray_tpu_torch.remote
def _write_block(block: Block, path: str, idx: int, fmt: str) -> str:
    import json
    import os

    f = os.path.join(path, f"part-{idx:05d}.{fmt}")
    if fmt == "parquet":
        _need("pyarrow", "write_parquet")
        import pyarrow.parquet as pq

        pq.write_table(BlockAccessor(block).to_arrow(), f)
    elif fmt == "csv":
        _need("pyarrow", "write_csv")
        import pyarrow.csv as pacsv

        pacsv.write_csv(BlockAccessor(block).to_arrow(), f)
    elif fmt == "json":
        # JSON lines (pandas' orient="records", lines=True), written with the stdlib
        with open(f, "w") as fh:
            for row in BlockAccessor(block).iter_rows():
                fh.write(json.dumps(row) + "\n")
    return f


# ----------------------------------------------------------------------
# read API (module-level; re-exported by ray_tpu_torch.data.__init__)
# ----------------------------------------------------------------------
def read_datasource(ds: Datasource, *, parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = 8
    return Dataset(ds.get_read_tasks(parallelism))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    from ray_tpu_torch.data.datasource import RangeDatasource

    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import ItemsDatasource

    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def _from_blocks(batches: list) -> Dataset:
    from ray_tpu_torch.data.datasource import BlocksDatasource

    return read_datasource(BlocksDatasource(batches), parallelism=1)


def from_numpy(arr, column: str = "data") -> Dataset:
    return _from_blocks([{column: np.asarray(arr)}])


def from_pandas(df) -> Dataset:
    return _from_blocks([df])


def from_arrow(table) -> Dataset:
    return _from_blocks([table])


def _file_reader(cls):
    def reader(paths, *, parallelism: int = -1, **kw) -> Dataset:
        return read_datasource(cls(paths, **kw), parallelism=parallelism)

    return reader


from ray_tpu_torch.data.datasource import (  # noqa: E402
    BinaryDatasource,
    CSVDatasource,
    ImageDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
)

read_parquet = _file_reader(ParquetDatasource)
read_csv = _file_reader(CSVDatasource)
read_json = _file_reader(JSONDatasource)
read_numpy = _file_reader(NumpyDatasource)
read_binary_files = _file_reader(BinaryDatasource)


def read_images(paths, *, size=None, mode=None, parallelism: int = -1) -> Dataset:
    return read_datasource(ImageDatasource(paths, size=size, mode=mode), parallelism=parallelism)

