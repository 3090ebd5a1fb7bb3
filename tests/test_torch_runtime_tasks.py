"""Tasks on the port's runtime (``ray_tpu_torch``) against ray_tpu's, on
the CPU: every case of ``tests/test_core_tasks.py``, each run on both
runtimes (one of each for the module, 4 CPUs) on the same seeded inputs,
numpy on ray_tpu's side and torch tensors on the port's, with the same
results and the same error types.

Also the reference-count deadlock's regression (ROADMAP.md queue 3 item
1): many small tasks, twice, with cyclic garbage holding refs and the
garbage collector run between submissions and at every allocation, on
the port only (the deadlock is ray_tpu's); and local mode. Every get
carries a timeout."""

import gc
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch_runtime_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu import exceptions as jexc
from ray_tpu_torch import exceptions as texc

T = 60  # seconds: every get's bound
PKGS = (ray_tpu, ray_tpu_torch)
EXC = {ray_tpu: jexc, ray_tpu_torch: texc}


def test_local_mode():
    """A runtime in local mode runs tasks in the driver (before the module's runtimes start)."""
    out = []
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4, local_mode=True)
        try:
            out.append(pkg.get(pkg.remote(defs.add).remote(2, 3), timeout=T))
        finally:
            pkg.shutdown()
    assert out == [5, 5]


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    yield
    for pkg in PKGS:
        pkg.shutdown()


def run(fn, *args, **kwargs):
    """fn(pkg, *args) on each package; the two results."""
    return [fn(pkg, *args, **kwargs) for pkg in PKGS]


def same(fn, *args, **kwargs):
    a, b = run(fn, *args, **kwargs)
    assert a == b, (a, b)
    return a


def test_put_get(both):
    assert same(lambda pkg: pkg.get(pkg.put({"a": 1, "b": [1, 2, 3]}), timeout=T)) == {"a": 1, "b": [1, 2, 3]}


def test_put_get_large_array(both):
    arr = np.arange(1_000_000, dtype=np.float32)
    j = ray_tpu.get(ray_tpu.put(arr), timeout=T)
    t = ray_tpu_torch.get(ray_tpu_torch.put(torch.from_numpy(arr)), timeout=T)
    np.testing.assert_array_equal(j, arr)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), j)


def test_simple_task(both):
    assert same(lambda pkg: pkg.get(pkg.remote(defs.add).remote(1, 2), timeout=T)) == 3


def test_task_with_ref_arg(both):
    def case(pkg):
        d = pkg.remote(defs.double)
        return pkg.get(d.remote(d.remote(10)), timeout=T)

    assert same(case) == 40


def test_task_kwargs(both):
    assert same(lambda pkg: pkg.get(pkg.remote(defs.kw).remote(1, c=10), timeout=T)) == 12


def test_task_large_arg_and_return(both):
    arr = np.random.default_rng(0).standard_normal((512, 1024)).astype(np.float32)
    mj, dj = ray_tpu.get(ray_tpu.remote(defs.mean_and_copy).remote(arr), timeout=T)
    mt, dt = ray_tpu_torch.get(ray_tpu_torch.remote(defs.mean_and_copy).remote(torch.from_numpy(arr)), timeout=T)
    assert isinstance(dt, torch.Tensor) and np.array_equal(dt.numpy(), dj)
    assert abs(mt - mj) <= 1e-5 * max(1.0, abs(mj))


def test_multiple_returns(both):
    def case(pkg):
        a, b, c = pkg.remote(defs.three).options(num_returns=3).remote()
        return pkg.get([a, b, c], timeout=T)

    assert same(case) == [1, 2, 3]


def test_task_error_propagates(both):
    def case(pkg):
        with pytest.raises(EXC[pkg].TaskError) as ei:
            pkg.get(pkg.remote(defs.boom).remote(), timeout=T)
        return "kaboom" in str(ei.value), type(ei.value.cause).__name__

    assert same(case) == (True, "ValueError")


def test_error_through_dependency(both):
    def case(pkg):
        with pytest.raises(EXC[pkg].TaskError) as ei:
            pkg.get(pkg.remote(defs.ident).remote(pkg.remote(defs.dep_boom).remote()), timeout=T)
        return type(ei.value).__name__, "dep failed" in str(ei.value)

    assert same(case) == ("TaskError", True)


def test_wait(both):
    def case(pkg):
        s = pkg.remote(defs.sleepy)
        fast, slow = s.remote(0.01), s.remote(5.0)
        ready, not_ready = pkg.wait([fast, slow], num_returns=1, timeout=3.0)
        return ready == [fast], not_ready == [slow]

    assert same(case) == (True, True)


def test_get_timeout(both):
    def case(pkg):
        ref = pkg.remote(defs.forever).remote()
        with pytest.raises(EXC[pkg].GetTimeoutError):
            pkg.get(ref, timeout=0.2)
        pkg.cancel(ref, force=True)  # its worker goes, and with it the CPU it holds
        return True

    assert same(case)


def test_nested_tasks(both):
    assert same(lambda pkg: pkg.get(pkg.remote(defs.outer).remote(1), timeout=T)) == 12


def test_nested_object_ref_in_list(both):
    def case(pkg):
        refs = [pkg.put(i) for i in range(5)]
        return pkg.get(pkg.remote(defs.consume_refs).remote(refs), timeout=T)

    assert same(case) == 10


def test_max_retries_worker_crash(both):
    def case(pkg):
        with pytest.raises(EXC[pkg].WorkerCrashedError):
            pkg.get(pkg.remote(defs.die).options(max_retries=0).remote(), timeout=T)
        return True

    assert same(case)


def test_retry_exceptions(both):
    def case(pkg):
        path = os.path.join(tempfile.mkdtemp(), "flag")
        return pkg.get(pkg.remote(defs.flaky).options(max_retries=3, retry_exceptions=True).remote(path), timeout=T)

    assert same(case) == "ok"


def test_streaming_generator(both):
    def case(pkg):
        return [pkg.get(r, timeout=T) for r in pkg.remote(defs.gen).options(num_returns="streaming").remote(5)]

    assert same(case) == [0, 1, 4, 9, 16]


def test_many_small_tasks(both):
    def case(pkg):
        s = pkg.remote(defs.sq)
        return pkg.get([s.remote(i) for i in range(100)], timeout=T)

    assert same(case) == [i * i for i in range(100)]


def test_many_small_tasks_under_gc_do_not_deadlock(both):
    """ray_tpu's _incref holds its count lock while an allocation can start
    a garbage-collection pass whose ObjectRef.__del__ takes the same lock
    (ROADMAP.md queue 3 item 1). The port releases through a lock-free
    deque: run 2 x 100 submissions with refs in cyclic garbage, the
    collector forced between submissions and run at (nearly) every
    allocation, and every result arrives."""
    want = [[i * i for i in range(100)]] * 2
    s = ray_tpu_torch.remote(defs.sq)
    old = gc.get_threshold()
    got = []
    try:
        for _ in range(2):
            refs = []
            gc.set_threshold(1, 1, 1)
            for i in range(100):
                r = s.remote(i)
                refs.append(r)
                cycle = [ray_tpu_torch.ObjectRef(r.id)]
                cycle.append(cycle)  # garbage only the collector frees, holding a ref
                del cycle
                if i % 10 == 0:
                    gc.collect()
            gc.set_threshold(*old)
            got.append(ray_tpu_torch.get(refs, timeout=T))
            gc.collect()
    finally:
        gc.set_threshold(*old)
    assert got == want


def test_runtime_resources_and_context(both):
    """The cluster's resources as ray_tpu reports them, "TPU" <-> "GPU"
    (absent on a host with no card), and the driver's runtime context."""
    j = ray_tpu.cluster_resources()
    t = ray_tpu_torch.cluster_resources()
    assert {k.replace("TPU", "GPU"): v for k, v in j.items()} == t
    assert t.get("GPU", 0) == 0 and t["CPU"] == 4.0
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and ray_tpu_torch.available_resources() != t:
        time.sleep(0.05)
    assert ray_tpu_torch.available_resources() == t
    assert len(ray_tpu.nodes()) == len(ray_tpu_torch.nodes()) == 1
    assert ray_tpu_torch.get_runtime_context().node_id.hex() == ray_tpu_torch.nodes()[0]["node_id"]
    assert ray_tpu.get_runtime_context().node_id.hex() == ray_tpu.nodes()[0]["node_id"]
