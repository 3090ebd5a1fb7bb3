"""The lock sanitizer in the port (``core/lock_sanitizer.py``), against
ray_tpu on the CPU.

Twins of ``tests/test_observability.py``'s three lock-sanitizer cases,
each run on both packages: an inverted order flagged as a cycle with no
deadlock, no false cycle for a consistent order with a slow hold
recorded, and the whole runtime under ``RT_LOCK_SANITIZER=1`` (tasks, a
node added and removed) with no cycle. Then the port's own: where the
runtime takes sanitized locks, and a plain ``RLock`` with the variable
unset."""

import threading
import time

import pytest
import torch_tooling_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu.core import lock_sanitizer as jls
from ray_tpu_torch.core import context as tcontext
from ray_tpu_torch.core import lock_sanitizer as tls

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
LS = {ray_tpu: jls, ray_tpu_torch: tls}
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
ids = {"ids": lambda p: p.__name__}


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_lock_sanitizer_detects_inverted_order(pkg):
    ls = LS[pkg]
    ls.reset()
    a, b = ls.SanitizedLock("A"), ls.SanitizedLock("B")
    with a:
        with b:
            pass
    done = threading.Event()

    def inverted():
        with b:
            with a:
                pass
        done.set()

    t = threading.Thread(target=inverted)
    t.start()
    t.join(timeout=5)
    assert done.is_set()
    rep = ls.report()
    assert ("A", "B") in rep["cycles"] or ("B", "A") in rep["cycles"]
    assert "A" in rep["order_graph"] and "B" in rep["order_graph"]


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_lock_sanitizer_no_false_positive_and_slow_holds(pkg, monkeypatch):
    ls = LS[pkg]
    ls.reset()
    a, b = ls.SanitizedLock("outer"), ls.SanitizedLock("inner")
    for _ in range(3):  # consistent ordering: no cycles
        with a:
            with b:
                pass
    assert ls.report()["cycles"] == []
    monkeypatch.setattr(ls, "SLOW_HOLD_S", 0.01)
    with a:
        time.sleep(0.05)
    assert any(name == "outer" for name, _ in ls.report()["slow_holds"])


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_runtime_under_lock_sanitizer(pkg, monkeypatch):
    """The whole runtime runs with sanitized core locks and reports no
    inverted lock order under tasks and a node added and removed."""
    ls = LS[pkg]
    monkeypatch.setenv("RT_LOCK_SANITIZER", "1")
    ls.reset()
    pkg.shutdown()
    try:
        pkg.init(num_cpus=2)
        f = pkg.remote(defs.double)
        assert pkg.get([f.remote(i) for i in range(4)], timeout=T) == [0, 2, 4, 6]
        client = CTX[pkg].get_client()
        assert isinstance(client._nodes_lock, ls.SanitizedLock)
        n = client.add_node({"CPU": 1, "x": 1})
        assert isinstance(n._lock, ls.SanitizedLock)
        assert pkg.get(pkg.remote(defs.nop).options(resources={"x": 1}, num_cpus=0).remote(), timeout=T) == 1
        client.remove_node(n.node_id)
        rep = ls.report()
        assert rep["cycles"] == [], f"lock order cycle: {rep['cycles']}"
    finally:
        pkg.shutdown()


# ---------------------------------------------------------------- the port's own
def test_make_lock_is_a_plain_rlock_when_off(monkeypatch):
    monkeypatch.delenv("RT_LOCK_SANITIZER", raising=False)
    for ls in LS.values():
        lock = ls.make_lock("node")
        assert type(lock) is type(threading.RLock())
        with lock:
            with lock:  # reentrant
                pass
    monkeypatch.setenv("RT_LOCK_SANITIZER", "on")
    assert isinstance(tls.make_lock("node"), tls.SanitizedLock)
