"""Data on the port's runtime (``ray_tpu_torch.data``) against ray_tpu's, on
the CPU: every case of ``tests/test_data.py``.

A case that runs on both packages is parametrised over both. Each
parameter runs the case's own assertions on its package; the port's
parameter also holds its output against ray_tpu's on the same inputs
(ray_tpu's output is cached from its parameter, or computed): rows,
batches and orders equal, ``random_shuffle(seed)``, ``sort`` and
group-by included. Arrow's join returns its rows in no set order, so a
join's rows compare sorted, and each hash bucket's rows compare as a set
(the buckets hold the same rows because the hashes are equal).

The hash cases hold the port's ``hash_column``, ``combine_hashes`` and
``partition_indices`` on numpy columns (native and fallback) against
ray_tpu's on Arrow arrays of the same keys. The locality cases put blocks
on nodes with shared-memory namespaces of their own
(``add_node(shm_isolation=True)``, agents), as ray_tpu's do: a block's
namespace is its location.
``test_train_integration_dataset_shard`` runs its data half
(``streaming_split`` iterators drained in actors) and its train half (a
two-worker trainer over ``get_dataset_shard``) on both packages.

One runtime of each package for the module (4 CPUs each); the cases that
need their own configuration start their own. UDFs live in
``tests/torch_data_defs.py`` (UDFs travel by reference on the port)."""

import functools
import importlib
import json
import sys
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch_data_defs as defs
import torch_train_defs as tdefs
from test_torch_trainer import fit as bounded_fit

import ray_tpu
import ray_tpu_torch
from ray_tpu import _native as jnat
from ray_tpu import data as jdata
from ray_tpu_torch import _native as tnat
from ray_tpu_torch import data as tdata
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch.data.block import BlockAccessor as TBlock

PKGS = ("ray_tpu", "ray_tpu_torch")
MODS = {"ray_tpu": (ray_tpu, jdata), "ray_tpu_torch": (ray_tpu_torch, tdata)}
T = 120  # seconds: the bound on the gets and threads here
_REF: dict = {}


@pytest.fixture(scope="module")
def runtimes():
    for rt, _ in MODS.values():
        rt.shutdown()
        rt.init(num_cpus=4)
    yield
    for rt, _ in MODS.values():
        rt.shutdown()


@pytest.fixture(params=PKGS)
def pkg(request, runtimes):
    return request.param


def same(pkg: str, case, key: str | None = None):
    """``case(rt, data)`` on ``pkg``; on the port also equal to ray_tpu's."""
    key = key or case.__qualname__
    out = case(*MODS[pkg])
    if pkg == "ray_tpu":
        _REF[key] = out
    else:
        want = _REF[key] if key in _REF else case(*MODS["ray_tpu"])
        assert out == want, (out, want)
    return out


# ---------------------------------------------------------------- test_data.py's cases
def test_range_count_take(pkg):
    def case(rt, rd):
        ds = rd.range(100)
        return ds.count(), ds.take(5)

    count, rows = same(pkg, case)
    assert count == 100 and [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_map_batches_numpy(pkg):
    assert same(pkg, lambda rt, rd: int(rd.range(64).map_batches(defs.double_id).sum("id")),
                "map_batches") == 2 * sum(range(64))


def test_map_filter_flat_map(pkg):
    def case(rt, rd):
        ds = rd.from_items([{"x": i} for i in range(10)])
        out = ds.map(defs.inc_x).filter(defs.x_even)
        fm = rd.from_items([{"x": 1}, {"x": 2}]).flat_map(defs.plus_minus)
        return out.take_all(), fm.take_all()

    out, fm = same(pkg, case)
    assert sorted(r["x"] for r in out) == [2, 4, 6, 8, 10]
    assert sorted(r["y"] for r in fm) == [-2, -1, 1, 2]


def test_actor_pool_map(pkg):
    def case(rt, rd):
        ds = rd.range(32).map_batches(defs.AddConst, concurrency=2, fn_constructor_kwargs={"c": 100})
        return ds.take_all()

    rows = same(pkg, case)
    assert sorted(r["id"] for r in rows) == list(range(100, 132))


def test_iter_batches_rebatching(pkg):
    def case(rt, rd):
        ds = rd.range(50, parallelism=4)
        full = [b["id"].tolist() for b in ds.iter_batches(batch_size=16)]
        dropped = [b["id"].tolist() for b in ds.iter_batches(batch_size=16, drop_last=True)]
        return full, dropped

    full, dropped = same(pkg, case)
    sizes = [len(b) for b in full]
    assert sum(sizes) == 50 and all(s == 16 for s in sizes[:-1])
    assert all(len(b) == 16 for b in dropped)


def test_limit_and_schema(pkg):
    def case(rt, rd):
        return rd.range(1000).limit(7).count(), rd.range(3).columns()

    assert same(pkg, case) == (7, ["id"])


def test_sort_and_shuffle(pkg):
    def case(rt, rd):
        vals = np.random.default_rng(0).permutation(200)
        out = [r["v"] for r in rd.from_items([{"v": int(v)} for v in vals]).sort("v").take_all()]
        desc = [r["v"] for r in rd.from_items([{"v": int(v)} for v in vals], parallelism=4).sort("v", True).take_all()]
        ids = [r["id"] for r in rd.range(100).random_shuffle(seed=42).take_all()]
        return out, desc, ids

    out, desc, ids = same(pkg, case)
    assert out == sorted(out) and desc == sorted(desc, reverse=True)
    assert sorted(ids) == list(range(100)) and ids != list(range(100))


def test_repartition(pkg):
    def case(rt, rd):
        mat = rd.range(100, parallelism=10).repartition(3).materialize()
        return mat.num_blocks(), mat.count(), [r["id"] for r in mat.take_all()]

    blocks, count, _ = same(pkg, case)
    assert (blocks, count) == (3, 100)


def test_groupby(pkg):
    def case(rt, rd):
        ds = rd.from_items([{"k": i % 3, "v": i} for i in range(30)])
        return (ds.groupby("k").count().take_all(), ds.groupby("k").sum("v").take_all(),
                ds.groupby("k").mean("v").take_all(), ds.groupby("k").min("v").take_all(),
                ds.groupby("k").max("v").take_all())

    counts, sums, *_ = same(pkg, case)
    assert {r["k"]: r["count()"] for r in counts} == {0: 10, 1: 10, 2: 10}
    assert {r["k"]: r["sum(v)"] for r in sums}[0] == sum(i for i in range(30) if i % 3 == 0)


def test_aggregations(pkg):
    def case(rt, rd):
        ds = rd.range(10)
        return ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id")

    assert same(pkg, case) == (45, 0, 9, 4.5)


def test_parquet_roundtrip(pkg, tmp_path):
    def case(rt, rd):
        path = str(tmp_path / rt.__name__ / "pq")
        rd.range(40).write_parquet(path)
        back = rd.read_parquet(path)
        return back.count(), int(back.sum("id")), back.take(3)

    assert same(pkg, case)[:2] == (40, sum(range(40)))


def test_csv_json_roundtrip(pkg, tmp_path):
    def case(rt, rd):
        ds = rd.from_items([{"a": i, "b": float(i)} for i in range(10)])
        ds.write_csv(str(tmp_path / rt.__name__ / "csv"))
        ds.write_json(str(tmp_path / rt.__name__ / "json"))
        csv = rd.read_csv(str(tmp_path / rt.__name__ / "csv"))
        back = rd.read_json(str(tmp_path / rt.__name__ / "json"))
        return csv.count(), int(back.sum("a")), sorted(r["b"] for r in back.take_all())

    count, total, _ = same(pkg, case)
    assert (count, total) == (10, 45)


def test_split_and_streaming_split(pkg):
    def case(rt, rd):
        ds = rd.range(60, parallelism=6)
        shards = [[r["id"] for r in s.take_all()] for s in ds.split(3)]
        its = ds.streaming_split(2)
        seen = []
        for it in its:
            for b in it.iter_batches(batch_size=None):
                seen.extend(b["id"].tolist())
        return shards, sorted(seen)

    shards, seen = same(pkg, case)
    assert sum(len(s) for s in shards) == 60 and seen == list(range(60))


def test_streaming_split_equal(pkg):
    def case(rt, rd):
        its = rd.range(55, parallelism=5).streaming_split(2, equal=True)
        return [[x for b in it.iter_batches(batch_size=None) for x in b["id"].tolist()] for it in its]

    rows = same(pkg, case)
    assert len(rows[0]) == len(rows[1]) == 27


def test_empty_block_pipeline(pkg):
    def case(rt, rd):
        ds = rd.range(10).filter(defs.never).map_batches(defs.first_id)
        s = rd.range(40, parallelism=4).filter(defs.id_is_3).sort("id")
        return ds.count(), [r["id"] for r in s.take_all()]

    assert same(pkg, case) == (0, [3])


def test_zip_union(pkg):
    def case(rt, rd):
        a = rd.from_items([{"x": i} for i in range(5)])
        b = rd.from_items([{"y": i * 10} for i in range(5)])
        return a.zip(b).take_all(), a.union(b).count(), a.zip(a).take(2)

    rows, n, clash = same(pkg, case)
    assert rows[2]["x"] == 2 and rows[2]["y"] == 20 and n == 10 and clash[1] == {"x": 1, "x_1": 1}


def test_train_integration_dataset_shard(pkg, tmp_path):
    """get_dataset_shard: the data half (two streaming_split iterators,
    each drained by its own actor in batches of 8), then the train half,
    test_data.py's own: a two-worker DataParallelTrainer whose loop sums
    its shard's ids (``tests/torch_train_defs.py``)."""

    def case(rt, rd):
        its = rd.range(40).streaming_split(2)
        actors = [rt.remote(defs.ShardSum).remote() for _ in its]
        out = rt.get([a.total.remote(it, 8) for a, it in zip(actors, its)], timeout=T)
        for a in actors:
            rt.kill(a)
        return sum(t for t, _ in out), sum(r for _, r in out)

    assert same(pkg, case) == (sum(range(40)), 40)

    def train_case(rt, rd):
        name = rd.__name__.split(".")[0]
        train = importlib.import_module(name + ".train")
        out = tmp_path / name
        out.mkdir(exist_ok=True)
        result = bounded_fit(train.DataParallelTrainer(
            tdefs.dataset_id_sum,
            train_loop_config={"pkg": name, "out": str(out)},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="d", storage_path=str(tmp_path)),
            datasets={"train": rd.range(40)},
        ), timeout=T)
        assert result.error is None
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
        return sum(r["total"] for r in ranks), sum(r["rows"] for r in ranks), result.metrics["rank"]

    assert same(pkg, train_case) == (sum(range(40)), 40, 0)


_HOLD_DRIVER = """
import sys
sys.path[:0] = [{tests!r}, {repo!r}]
import numpy as np
import ray_tpu_torch
from ray_tpu_torch import data
import torch_data_defs as defs

if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=4)
    rng = np.random.default_rng(0)
    rows = [{{"tokens": rng.integers(0, 32000, 2048).astype(np.int32),
              "targets": rng.integers(0, 32000, 2048).astype(np.int32)}} for _ in range(48)]
    it = data.from_items(rows, parallelism=4).streaming_split(1)[0]
    actor = ray_tpu_torch.remote(defs.ShardSum).remote()
    got = ray_tpu_torch.get(actor.slow_total.remote(it, 8, 1.2), timeout=120)
    want = (sum(int(r["tokens"].astype(np.int64).sum()) for r in rows), 48)
    print("HELD", got == want, got, want)
    ray_tpu_torch.shutdown()
"""


def test_split_iterator_keeps_blocks_its_consumer_holds(tmp_path):
    """A consumer in another process holds shm-sized blocks (4 blocks of
    12 rows of 2 x 2048 int32, sealed in the head's store) in its prefetch
    window for ~3.6 s (1.2 s a batch of 8: a training step), longer than
    the split coordinator keeps the refs it handed out alive (3 s). The
    coordinator sent each ref with its own owner hint, so the consumer's
    borrow went to the coordinator and not to the head, which freed the
    blocks once the coordinator let go: the consumer's get raised
    ObjectLostError. A ref the head owns now travels without that hint
    (``core/direct.py::mark_serialized_out``). A driver script of its own
    (the fault shows there, not under pytest's driver)."""
    import os
    import subprocess
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    path = tmp_path / "hold_driver.py"
    path.write_text(_HOLD_DRIVER.format(tests=str(tests), repo=str(tests.parent)))
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=T,
                         cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": str(tests.parent)})
    assert out.returncode == 0 and "HELD True" in out.stdout, (out.stdout[-2000:], out.stderr[-4000:])


def test_tensor_columns(pkg):
    def case(rt, rd):
        arr = np.arange(24, dtype=np.float32).reshape(6, 4)
        b = rd.from_numpy(arr).take_batch(6)
        out = rd.from_numpy(arr).map_batches(defs.double_data).take_batch(6)
        rows = rd.from_numpy(arr).take(2)
        return (b["data"].shape, str(b["data"].dtype), out["data"].tolist(), str(out["data"].dtype), rows)

    shape, dtype, doubled, _, rows = same(pkg, case)
    assert shape == (6, 4) and dtype == "float32"
    np.testing.assert_allclose(doubled, np.arange(24, dtype=np.float32).reshape(6, 4) * 2)
    assert rows[1] == {"data": [4.0, 5.0, 6.0, 7.0]}


def test_op_budget_resource_aware(pkg):
    def case(rt, rd):
        OpBudget = sys.modules[rd.__name__ + ".executor"].OpBudget
        b = OpBudget(num_cpus_per_task=1.0, num_stages=2)
        w0 = b.window
        assert OpBudget.MIN_WINDOW <= w0 <= OpBudget.MAX_WINDOW
        # simulate huge observed blocks: memory constraint must bind
        b._block_bytes_sum = b._total_budget * 10
        b._block_count = 1
        w_big = b.window
        b2 = OpBudget(num_cpus_per_task=1.0)
        b2._block_bytes_sum, b2._block_count = 1024, 1
        return w0, w_big, OpBudget(explicit=7).window, b2.window == b2._cpu_cap or b2.window == OpBudget.MAX_WINDOW

    w0, w_big, explicit, cpu_bound = same(pkg, case)
    assert w_big == 2 and explicit == 7 and cpu_bound


def test_native_hash_kernels():
    """C++ hashing/partitioning parity with the numpy fallback, and with
    ray_tpu's on Arrow arrays of the same keys."""
    ints = np.arange(512, dtype=np.int64)
    strs = [f"k{i % 37}" for i in range(512)]
    assert tnat.native_available()
    h_int, h_str = tnat.hash_column(ints), tnat.hash_column(np.array(strs, dtype=object))
    lib, tnat._lib = tnat._lib, None
    try:
        assert (tnat.hash_column(ints) == h_int).all()  # fallback parity
        assert (tnat.hash_column(strs) == h_str).all()
        idx_f, counts_f = tnat.partition_indices(h_int, 8)
    finally:
        tnat._lib = lib
    idx, counts = tnat.partition_indices(h_int, 8)
    assert (counts == counts_f).all() and (idx == idx_f).all()
    assert counts.sum() == 512
    assert h_str[0] == h_str[37] and h_str[0] != h_str[1]
    np.testing.assert_array_equal(h_int, jnat.hash_column(ints))
    np.testing.assert_array_equal(h_str, jnat.hash_column(pa.array(strs)))
    j_idx, j_counts = jnat.partition_indices(h_str, 8)
    t_idx, t_counts = tnat.partition_indices(h_str, 8)
    np.testing.assert_array_equal(j_idx, t_idx)
    np.testing.assert_array_equal(j_counts, t_counts)


KEYS = {
    "int": ([3, -1, 0, 2**40, 3], None),
    "float": ([0.1, 0.2, -0.0, 0.0, float("nan"), 1e300], None),
    "str": (["alpha", "beta", None, "alpha", "γάμμα", ""], None),
    "bytes": ([b"ab", None, b"\x00x", b"", b"ab"], pa.binary()),
    "null int": ([1, None, 3], None),
    "bool": ([True, False, True], None),
    "all null": ([None, None], None),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
@pytest.mark.parametrize("kind", list(KEYS))
def test_hash_parity_with_ray_tpu(kind, native):
    """``hash_column`` on a numpy column (typed, or an object array where
    the keys are str, bytes or null-bearing) equals ray_tpu's on the Arrow
    array of the same keys; ``combine_hashes`` and ``partition_indices``
    on them too. Both of the port's paths, and ray_tpu's native path."""
    vals, typ = KEYS[kind]
    want = jnat.hash_column(pa.array(vals, type=typ))
    col = _port_column(vals)
    lib = tnat._lib
    if not native:
        tnat._lib = None
    try:
        got = tnat.hash_column(col)
        both = tnat.combine_hashes(got, tnat.hash_column(np.arange(len(vals))))
        parts = tnat.partition_indices(got, 3)
    finally:
        tnat._lib = lib
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(both, jnat.combine_hashes(want, jnat.hash_column(np.arange(len(vals)))))
    for a, b in zip(parts, jnat.partition_indices(want, 3)):
        np.testing.assert_array_equal(a, b)


def _port_column(vals):
    """The column the port's block holds for these values."""
    return TBlock.batch_to_block({"k": vals})["k"]


def test_join_inner_and_left(pkg):
    def case(rt, rd):
        left = rd.from_items([{"id": i, "a": i * 10} for i in range(20)])
        right = rd.from_items([{"id": i, "b": i * 100} for i in range(10, 30)])
        inner = sorted(left.join(right, on="id").materialize().take_all(), key=lambda r: r["id"])
        lj = sorted(left.join(right, on="id", how="left").materialize().take_all(), key=lambda r: r["id"])
        return inner, lj

    inner, lj = same(pkg, case)
    assert [r["id"] for r in inner] == list(range(10, 20))
    assert all(r["b"] == r["id"] * 100 and r["a"] == r["id"] * 10 for r in inner)
    assert len(lj) == 20 and lj[0]["b"] is None and lj[-1]["b"] == 19 * 100


def _bucket_sets(rt, rd, left_rows, right_rows, on, how, parts):
    """A join's rows sorted, and each hash bucket's rows as a sorted list."""
    left, right = rd.from_items(left_rows, parallelism=3), rd.from_items(right_rows, parallelism=2)
    joined = left.join(right, on=on, how=how, num_partitions=parts)
    per = [rt.get(r, timeout=T) for r in joined._refs]
    rows = [list(_accessor(rd, b).iter_rows()) for b in per]
    key = lambda r: tuple(sorted((k, repr(v)) for k, v in r.items()))  # noqa: E731
    return sorted((r for b in rows for r in b), key=key), [sorted(b, key=key) for b in rows]


def _accessor(rd, block):
    return sys.modules[rd.__name__ + ".block"].BlockAccessor(block)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("kind", ["int", "float", "str"])
def test_join_keys_and_buckets_equal_ray_tpu(runtimes, kind, how):
    """Joins on int, float and string keys over 5 partitions: the port's
    rows equal ray_tpu's, and each bucket holds the same rows."""
    keyf = {"int": lambda i: i, "float": lambda i: i / 4.0, "str": lambda i: f"user{i}"}[kind]
    left_rows = [{"k": keyf(i % 13), "x": i} for i in range(64)]
    right_rows = [{"k": keyf(i), "rank": i} for i in range(3, 13)]
    got = _bucket_sets(*MODS["ray_tpu_torch"], left_rows, right_rows, "k", how, 5)
    want = _bucket_sets(*MODS["ray_tpu"], left_rows, right_rows, "k", how, 5)
    assert got == want
    assert len(got[0]) == (64 if how == "left" else sum(1 for r in left_rows if r["k"] in
                                                        {x["k"] for x in right_rows}))


def test_join_string_keys_multi_partition(pkg):
    def case(rt, rd):
        left = rd.from_items([{"name": f"user{i % 13}", "x": i} for i in range(64)])
        right = rd.from_items([{"name": f"user{i}", "rank": i} for i in range(13)])
        return sorted(left.join(right, on="name", num_partitions=5).materialize().take_all(), key=lambda r: r["x"])

    rows = same(pkg, case)
    assert len(rows) == 64 and all(r["rank"] == int(r["name"][4:]) for r in rows)


def test_hash_consistency_sliced_null_and_fallback():
    """Every hash path (native, fallback, sliced columns, nulls) yields
    IDENTICAL values, equal to ray_tpu's Arrow path."""
    base = np.array(["alpha", "beta", None, "alpha", "gamma"], dtype=object)
    h_full = tnat.hash_column(base)
    assert h_full[0] == h_full[3]
    np.testing.assert_array_equal(tnat.hash_column(base[1:]), h_full[1:])
    lib, tnat._lib = tnat._lib, None
    try:
        np.testing.assert_array_equal(tnat.hash_column(base), h_full)
    finally:
        tnat._lib = lib
    arrow = pa.array(["alpha", "beta", None, "alpha", "gamma"])
    np.testing.assert_array_equal(h_full, jnat.hash_column(arrow))
    np.testing.assert_array_equal(h_full[1:], jnat.hash_column(arrow.slice(1)))


def test_join_empty_side(pkg):
    def case(rt, rd):
        left = rd.from_items([{"id": i} for i in range(4)])
        empty = rd.from_items([{"id": 1}]).filter(defs.never)
        return left.join(empty, on="id").materialize().count()

    assert same(pkg, case) == 0


_JOIN_KEYS = {  # one key column, or two: values a row draws from by its index
    "int": [3, 1, 4, 1, 5],
    "float": [0.0, -0.0, 1.5, float("nan"), 2.25],
    "str": ["a", "b", None, "a", "c"],
    "bytes": [b"x", b"", None, b"y"],
    "null int": [None, 7, 8, 7],
    "two": [(1, "p"), (1, "q"), (2, "p"), (2, None)],
}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("kind", list(_JOIN_KEYS))
def test_join_blocks_equal_arrow_join(kind, how):
    """One bucket pair's join on numpy blocks against the Arrow join
    ray_tpu runs on the same rows (``_join_buckets``): the same rows,
    floats compared by their bits (``-0.0`` is not ``0.0``, NaN meets
    NaN), a null key matching nothing, unmatched sides null; and an
    empty side. Arrow's rows come in no set order, so both are sorted."""
    from ray_tpu.data.executor import _ARROW_JOIN_TYPES
    from ray_tpu_torch.data.executor import join_blocks

    vals = _JOIN_KEYS[kind]
    keys = ["k", "k2"] if kind == "two" else ["k"]

    def rows(n, col, seed):
        out = []
        for i, j in enumerate(np.random.default_rng(seed).integers(0, len(vals), n).tolist()):
            key = dict(zip(keys, vals[j] if kind == "two" else (vals[j],)))
            out.append({**key, col: i})
        return out

    def norm(rows):
        return sorted(tuple((k, repr(v)) for k, v in r.items()) for r in rows)

    for n_left, n_right in [(17, 11), (0, 5), (6, 0)]:
        left, right = rows(n_left, "x", 1), rows(n_right, "y", 2)
        got = join_blocks(TBlock.rows_to_block(left) if left else {c: np.zeros(0, np.int64) for c in keys + ["x"]},
                          TBlock.rows_to_block(right) if right else {c: np.zeros(0, np.int64) for c in keys + ["y"]},
                          keys, how)
        if not (left and right):
            want = {"inner": 0, "left": n_left, "right": n_right, "outer": n_left + n_right}[how]
            assert len(list(TBlock(got).iter_rows())) == want
            continue
        arrow = pa.Table.from_pylist(left).join(pa.Table.from_pylist(right), keys=keys,
                                                join_type=_ARROW_JOIN_TYPES[how])
        assert norm(TBlock(got).iter_rows()) == norm(arrow.to_pylist())


def _locality_cluster(node_cpus: float = 2.0):
    from ray_tpu_torch.core import context as tctx

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    client = tctx.get_client()
    na = client.add_node({"CPU": node_cpus, "na": 1.0}, shm_isolation=True)
    nb = client.add_node({"CPU": node_cpus, "nb": 1.0}, shm_isolation=True)
    return client, na, nb


def _blocks_on(node_res: str, n_blocks: int, tag: float):
    """shm-sized blocks made on one isolated node: their primary copies'
    namespace records that node as their location."""
    make = ray_tpu_torch.remote(defs.block_on_node).options(resources={node_res: 0.01}, num_cpus=0)
    return [make.remote(i, tag) for i in range(n_blocks)]


def test_streaming_split_honors_locality_hints():
    client, na, nb = _locality_cluster()
    try:
        refs_a = _blocks_on("na", 4, 0.0)
        refs_b = _blocks_on("nb", 4, 100.0)
        ready, _ = ray_tpu_torch.wait(refs_a + refs_b, num_returns=8, timeout=T)
        assert len(ready) == 8
        locs = client.object_locations([r.id for r in refs_a + refs_b])
        assert [locs[r.id.hex()] for r in refs_a + refs_b] == [na.node_id.hex()] * 4 + [nb.node_id.hex()] * 4
        interleaved = [r for pair in zip(refs_a, refs_b) for r in pair]
        ds = tdata.MaterializedDataset(interleaved)
        its = ds.streaming_split(2, locality_hints=[na.node_id.hex(), nb.node_id.hex()])
        rows = [[], []]

        def drain(i):
            for batch in its[i].iter_batches(batch_size=None):
                rows[i].append(float(batch["x"][0]))

        ts = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in ts)
        stats = ray_tpu_torch.get(its[0]._coord.locality_stats.remote(), timeout=T)
        local = sum(s["local"] for s in stats)
        remote = sum(s["remote"] for s in stats)
        assert local > remote, f"split routing mostly non-local: {stats}"
        # every node-A block (tag < 100) went to split 0, node-B's to split 1
        assert all(v < 100 for v in rows[0]) and all(v >= 100 for v in rows[1]), rows
        assert len(rows[0]) == 4 and len(rows[1]) == 4
    finally:
        ray_tpu_torch.shutdown()


def test_map_tasks_dispatch_to_block_node():
    # to_arrow_refs drives the whole stream, so all 6 map tasks submit at
    # once: node A holds them all, and the soft preference is deterministic
    client, na, nb = _locality_cluster(node_cpus=8.0)
    try:
        refs_a = _blocks_on("na", 6, 0.0)
        ready, _ = ray_tpu_torch.wait(refs_a, num_returns=6, timeout=T)
        assert len(ready) == 6
        ds = tdata.MaterializedDataset(refs_a).map_batches(defs.node_of, batch_size=None)
        out = [ray_tpu_torch.get(r, timeout=T) for r in ds.to_arrow_refs()]
        ran_on = [int(TBlock(o).to_batch("numpy")["nid"][0]) for o in out]
        expect = int(na.node_id.hex()[:8], 16)
        frac_local = sum(1 for n in ran_on if n == expect) / len(ran_on)
        # soft affinity: preferred whenever the node has capacity
        assert frac_local >= 0.8, (ran_on, expect)
    finally:
        ray_tpu_torch.shutdown()


def test_float_key_hash_uses_bit_pattern():
    keys = np.array([0.1, 0.2, 0.3, 0.9, 0.0, -0.0], np.float64)
    h = tnat.hash_column(keys)
    assert len(set(h[:4].tolist())) == 4, "fractional floats collided"
    assert h[4] == h[5], "-0.0 and 0.0 must hash equally"
    np.testing.assert_array_equal(h, jnat.hash_column(keys))


def test_groupby_on_float_keys(pkg):
    def case(rt, rd):
        ds = rd.from_items([{"k": (i % 4) / 4.0, "v": 1} for i in range(32)])
        return ds.groupby("k").sum("v").take_all()

    rows = same(pkg, case)
    assert {r["k"]: r["sum(v)"] for r in rows} == {0.0: 8, 0.25: 8, 0.5: 8, 0.75: 8}


def test_op_budget_pool_is_shared_dynamically(pkg):
    def case(rt, rd):
        ex = sys.modules[rd.__name__ + ".executor"]
        cfgmod = sys.modules[rt.__name__ + "._config"]
        cfgmod.reset_config()
        a = ex.OpBudget(num_cpus_per_task=0.25, num_stages=2)
        b = ex.OpBudget(num_cpus_per_task=0.25, num_stages=2)
        try:
            for op in (a, b):
                op._cpu_cap = 1000
                op._total_budget = 32 * 2**20
                op._floor = 2 * 2**20
                op._block_bytes_sum, op._block_count = 8 * 2**20, 8  # 1 MiB blocks
            b.set_inflight(0)
            idle = a.window
            b.set_inflight(24)
            busy = a.window
            b.close()
            return idle, busy, a.window
        finally:
            a.close()
            b.close()
            cfgmod.reset_config()

    idle, busy, back = same(pkg, case)
    assert busy < idle and back == idle and busy >= 2


def test_dynamic_block_splitting_bounded_memory():
    """A dataset above the store's budget, with skewed block sizes, streams
    through bounded: no output block above ~the split target."""
    from ray_tpu_torch.core import context
    from ray_tpu_torch.data.executor import split_stats

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, _system_config={"object_store_memory": 64 * 1024 * 1024,
                                                   "target_max_block_size": 1 * 1024 * 1024})
    try:
        before = split_stats.blocks
        ds = tdata.range(16, parallelism=16).map_batches(defs.skewed, batch_size=None)
        store = context.get_client().store
        total_rows, max_block_bytes = 0, 0
        for ref in ds._ref_stream():
            entry = store.try_get_entry(ref.id)
            if entry is not None:
                max_block_bytes = max(max_block_bytes, entry.size())
            total_rows += len(ray_tpu_torch.get(ref, timeout=T)["x"])
            ray_tpu_torch.internal_free([ref])
        assert total_rows == 4 * 1_000_000 + 12 * 1_000
        assert max_block_bytes <= 2 * 1024 * 1024, max_block_bytes
        assert split_stats.blocks - before == 4
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._config import reset_config

        reset_config()


def test_dataset_3x_store_size_materializes(tmp_path):
    """tests/test_spilling.py's case on the port: a dataset ~3x the store's
    budget materializes and iterates, spilling instead of dying."""
    from ray_tpu_torch.core import context

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, _system_config={"object_store_memory": 8 * 2**20,
                                                   "object_store_eviction_threshold": 1.0,
                                                   "object_spill_dir": str(tmp_path / "spill")})
    try:
        n_blocks, elems = 24, 2**17  # 24 x 1 MB = 3x the 8 MB budget
        ds = tdata.range(n_blocks, parallelism=n_blocks).map_batches(defs.fill_block, batch_size=None,
                                                                    fn_kwargs={"elems": elems})
        mat = ds.materialize()
        seen, total = set(), 0
        for batch in mat.iter_batches(batch_size=None):
            total += batch["x"].size
            seen.update(np.unique(batch["x"]).astype(int).tolist())
        assert total == n_blocks * elems and seen == set(range(n_blocks))
        assert context.get_client().store.stats()["spill_count"] > 0, context.get_client().store.stats()
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._config import reset_config

        reset_config()


# ---------------------------------------------------------------- the port's own rules
def test_blocks_equal_ray_tpus_numpy_batches_and_rows():
    """``to_batch("numpy")`` equals ray_tpu's ``to_numpy()`` (keys, dtypes,
    shapes, values) and ``iter_rows`` its ``to_pylist()``, for int, float,
    string, bytes, bool, tensor and ragged columns; slices and takes too."""
    from ray_tpu.data.block import BlockAccessor as JBlock

    rng = np.random.default_rng(0)
    rows = [{"i": int(i), "f": float(i) / 3, "s": f"s{i}", "b": bytes([i]), "ok": bool(i % 2),
             "t": rng.standard_normal(3).tolist(), "r": list(range(i % 4 + 1))} for i in range(12)]
    j, t = JBlock(JBlock.rows_to_block(rows)), TBlock(TBlock.rows_to_block(rows))
    jb, tb = j.to_batch("numpy"), t.to_batch("numpy")
    assert list(jb) == list(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
        for x, y in zip(jb[k], tb[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert list(j.iter_rows()) == list(t.iter_rows())
    assert list(JBlock(j.slice(3, 7)).iter_rows()) == list(TBlock(t.slice(3, 7)).iter_rows())
    idx = [5, 0, 11, 5]
    assert list(JBlock(j.take_indices(idx)).iter_rows()) == list(TBlock(t.take_indices(idx)).iter_rows())
    taken = t.take_indices(idx)
    assert all(c.base is None or c.base is not t.block[k].base for k, c in taken.items())
    assert t.schema().names == list(jb) and t.num_rows() == 12
    batch = {"x": np.arange(6).reshape(3, 2), "y": ["a", "b", None]}
    assert list(JBlock(JBlock.batch_to_block(batch)).iter_rows()) == list(TBlock(TBlock.batch_to_block(batch)).iter_rows())


def test_lambda_and_closure_udfs_raise_at_the_call(runtimes):
    """UDFs travel by reference: a lambda or a closure raises TypeError
    naming the difference at map/map_batches/filter/flat_map, before
    anything runs; a partial of a module-level function is fine."""
    def local(b):
        return b

    ds = tdata.range(4)
    for call in (lambda: ds.map(lambda r: r), lambda: ds.map_batches(lambda b: b), lambda: ds.filter(local),
                 lambda: ds.flat_map(local), lambda: ds.map_batches(functools.partial(local)),
                 lambda: ds.add_column("z", lambda b: b["id"])):
        with pytest.raises(TypeError, match="by reference"):
            call()
    out = ds.map_batches(functools.partial(defs.scale_sum, factor=2.0), batch_format="numpy")
    assert out is not None


def test_udf_error_surfaces_as_task_error(runtimes):
    with pytest.raises(texc.TaskError, match="kaboom in a UDF"):
        tdata.range(8).map_batches(defs.boom_batch).take_all()
    with pytest.raises(texc.RayTpuError, match="kaboom in a UDF"):
        tdata.range(8).map_batches(defs.AddConst, concurrency=1).map_batches(defs.boom_batch).take_all()


def test_missing_optional_packages_raise_naming_them(monkeypatch):
    """Without pandas or pyarrow the conversions that need them raise
    ImportError naming the package; numpy blocks need neither."""
    block = TBlock.batch_to_block({"a": [1, 2]})
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pandas"):
        TBlock(block).to_batch("pandas")
    with pytest.raises(ImportError, match="pyarrow"):
        TBlock(block).to_arrow()
    assert TBlock(block).to_batch("numpy")["a"].tolist() == [1, 2]


def test_wait_sees_a_direct_result_redirected_to_the_head(runtimes):
    """A fault the feed found in the port's runtime (core/direct.py
    ``wait_mixed``, as in ray_tpu's): a wait that starts while a direct
    task runs classified its result as owned; when the worker sealed the
    large result in the head's store, the owned entry turned REDIRECT,
    which no owner answers for, and the wait spun for ever
    (``_split_oversized``'s straggler wait hung on a large read block).
    The wait now asks the head's store for such ids."""
    ref = ray_tpu_torch.remote(defs.slow_big).remote(0.5, 1 << 20)
    ready, rest = ray_tpu_torch.wait([ref], num_returns=1, timeout=30)
    assert ready == [ref] and rest == []
    assert ray_tpu_torch.get(ref, timeout=T).shape == (1 << 20,)
    ref2 = ray_tpu_torch.remote(defs.slow_big).remote(0.5, 1 << 20)
    assert ray_tpu_torch.wait([ref2], num_returns=1, timeout=0) == ([], [ref2])
    assert ray_tpu_torch.wait([ref2], num_returns=1, timeout=None) == ([ref2], [])


def test_union_of_transformed_datasets(runtimes):
    """The port's union reads a transformed operand's materialized blocks
    (ray_tpu's returns a MaterializedDataset's placeholder read tasks,
    ROADMAP.md queue 3 item 5)."""
    a = tdata.range(6, parallelism=2).map_batches(defs.double_id)
    b = tdata.from_items([{"id": 100}])
    assert sorted(r["id"] for r in a.union(b).take_all()) == [0, 2, 4, 6, 8, 10, 100]
    assert sorted(r["id"] for r in a.materialize().union(b).take_all()) == [0, 2, 4, 6, 8, 10, 100]
