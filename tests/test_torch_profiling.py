"""Profiling and the test cluster in the port (``util/profiling.py``,
``cluster_utils.py``), against ray_tpu on the CPU. ray_tpu has no test of
either.

``profile_trace`` writes a Chrome trace on the CPU that names the plain
K1's ops; ``WallProfiler.report()`` has ray_tpu's shape for the same
spans; the capture endpoint (``start_profiler_server``, the port's own:
``jax.profiler.start_server`` has no PyTorch twin) records another
thread's ops for the requested milliseconds; ``cluster_utils.Cluster``
adds and removes a node in both packages, ``num_tpus`` folding into
``"GPU"`` in the port."""

import glob
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch
import torch_tooling_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import profiling as jprof
from ray_tpu_torch.util import profiling as tprof

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
ids = {"ids": lambda p: p.__name__}


def _trace_names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_trace_writes_a_chrome_trace_of_the_plain_k1(tmp_path):
    logdir = str(tmp_path / "prof")
    with tprof.profile_trace(logdir) as d:
        o, lse = defs.attention_ops()
    assert d == logdir and o.shape == (1, 4, 32, 16) and lse.shape == (1, 4, 32)
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    names = _trace_names(path)
    # attention_with_lse_ref's ops: the two products, the causal mask, logsumexp
    assert {"aten::einsum", "aten::logsumexp", "aten::exp"} <= names, sorted(n for n in names if n)[:40]


def test_wall_profiler_report_matches_ray_tpu():
    import jax.numpy as jnp

    reports = []
    for prof_mod, value in ((jprof, jnp.ones(4)), (tprof, torch.ones(4))):
        prof = prof_mod.WallProfiler()
        for _ in range(3):
            with prof.span("step", sync_value=value):
                pass
        with prof.span("load"):
            pass
        with prof.span("nested", sync_value={"a": [value, (value,)]} if prof_mod is tprof else value):
            pass
        reports.append(prof.report())
    j, t = reports
    assert list(j) == list(t) == ["step", "load", "nested"]
    for name in j:
        assert sorted(j[name]) == sorted(t[name]) == ["count", "mean_s", "total_s"]
        assert j[name]["count"] == t[name]["count"]
        assert t[name]["mean_s"] == pytest.approx(t[name]["total_s"] / t[name]["count"])


def test_capture_endpoint_records_another_threads_ops(tmp_path):
    port = tprof.start_profiler_server(0, logdir=str(tmp_path))
    stop = threading.Event()

    def work():
        while not stop.is_set():
            defs.attention_ops()

    t = threading.Thread(target=work)
    t.start()
    try:
        assert tprof.start_profiler_server(0) == port  # one endpoint a process
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?ms=200", timeout=120) as r:
            path = json.loads(r.read())["path"]
        assert os.path.dirname(path) == str(tmp_path)
        assert "aten::logsumexp" in _trace_names(path)
        for bad in ("ms=0", "ms=x", "ms=600000"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?{bad}", timeout=30)
            assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert exc.value.code == 404
    finally:
        stop.set()
        t.join(timeout=30)
        tprof.stop_profiler_server()
    assert not t.is_alive()


def _cluster_utils(pkg):
    if pkg is ray_tpu_torch:
        from ray_tpu_torch import cluster_utils
    else:
        from ray_tpu import cluster_utils
    return cluster_utils


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_cluster_utils_adds_and_removes_a_node(pkg):
    for p in PKGS:
        p.shutdown()
    cluster = _cluster_utils(pkg).Cluster(head_node_args={"num_cpus": 2})
    try:
        assert cluster.address.startswith("local://")
        rt = cluster.connect()
        node = cluster.add_node(num_cpus=1, resources={"x": 1})
        card = cluster.add_node(num_cpus=1, num_tpus=1, remote=False)
        assert card.total_resources == ({"CPU": 1.0, "GPU": 1.0} if pkg is ray_tpu_torch else {"CPU": 1.0, "TPU": 1.0})
        assert len(rt.node_list()) == 3 and cluster.wait_for_nodes()
        p = pkg.get(pkg.remote(defs.pid).options(resources={"x": 1}, num_cpus=0).remote(), timeout=T)
        assert p != os.getpid()
        cluster.remove_node(node)
        cluster.remove_node(card.node_id)
        assert [n.node_id for n in rt.node_list()] == [cluster.head_node.node_id]
    finally:
        cluster.shutdown()
        pkg.shutdown()
