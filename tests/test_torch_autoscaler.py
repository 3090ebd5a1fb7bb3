"""The autoscaler and the cluster launcher in the port (``autoscaler/``,
``Scheduler.pending_demand``, ``Runtime.pending_pg_demand``, ``rt up`` and
``rt down``), against ray_tpu on the CPU.

Twins, each run on both packages with a fresh runtime: the three cases of
``tests/test_ops_layer.py`` (scale up for demand and down when idle,
``max_workers``, the ``min_workers`` floor) and two of
``tests/test_distributed.py`` (a ``CommandNodeProvider`` whose shell line
starts a joining ``rt agent``; the launcher from a YAML configuration,
and from JSON beside it). Then the port's own: a card actor parked on a
card-less head shows in the demand as ray_tpu's does, ``reconcile``
makes ray_tpu's launch and terminate decisions over a fake provider for
the same demand sequence (a ``{"TPU": 1}`` request folding into
``"GPU"``), and ``rt up config.json`` then ``rt down`` through the CLI.
Remote code lives in ``tests/torch_tooling_defs.py``."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch_tooling_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu_torch.core import context as tcontext

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
T = 90
PKGS = (ray_tpu, ray_tpu_torch)
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
ids = {"ids": lambda p: p.__name__}


def _auto(pkg):
    if pkg is ray_tpu_torch:
        import ray_tpu_torch.autoscaler as a
    else:
        import ray_tpu.autoscaler as a
    return a


@pytest.fixture
def rt(request):
    """The parameter's package with a fresh runtime of 4 CPUs."""
    pkg = request.param
    for p in PKGS:
        p.shutdown()
    pkg.init(num_cpus=4)
    yield pkg
    pkg.shutdown()


def _agent_command(pkg) -> str:
    """A shell line that starts ``rt agent`` of ``pkg`` joining the head."""
    return (f"PYTHONPATH={REPO}{os.pathsep}{TESTS} {sys.executable} -m {pkg.__name__}.scripts.cli agent "
            "--address {address} --authkey {authkey} --transfer-authkey {transfer_authkey} "
            "--num-cpus {num_cpus} --reconnect 0")


# ---------------------------------------------------------------- test_ops_layer.py
@pytest.mark.parametrize("rt", PKGS, indirect=True, **ids)
def test_autoscaler_scales_up_for_demand_and_down_when_idle(rt):
    a = _auto(rt)
    client = CTX[rt].get_client()
    sc = a.Autoscaler(client, [a.NodeTypeConfig("gpuless", {"CPU": 2.0, "bonus": 2.0}, min_workers=0, max_workers=3)],
                      idle_timeout_s=1.0, interval_s=0.1).start()
    try:
        f = rt.remote(defs.node_hex).options(resources={"bonus": 1}, num_cpus=0)
        # no node has "bonus": the demand must launch one
        out = rt.get([f.remote() for _ in range(2)], timeout=T)
        assert len(out) == 2 and client.node_id.hex() not in out
        assert sc.status()["managed_count"] >= 1
        deadline = time.time() + 30
        while time.time() < deadline and sc.status()["managed_count"] > 0:
            time.sleep(0.2)
        assert sc.status()["managed_count"] == 0, "idle node never scaled down"
    finally:
        sc.stop()


@pytest.mark.parametrize("rt", PKGS, indirect=True, **ids)
def test_autoscaler_respects_max_workers(rt):
    a = _auto(rt)
    client = CTX[rt].get_client()
    sc = a.Autoscaler(client, [a.NodeTypeConfig("small", {"CPU": 1.0, "tag": 1.0}, max_workers=2)],
                      idle_timeout_s=60.0, interval_s=0.1).start()
    try:
        hold = rt.remote(defs.hold).options(resources={"tag": 1}, num_cpus=0)
        refs = [hold.remote(3.0) for _ in range(5)]
        time.sleep(2.0)
        assert sc.status()["managed_count"] <= 2
        assert sum(rt.get(refs, timeout=120)) == 5  # all complete eventually
    finally:
        sc.stop()


@pytest.mark.parametrize("rt", PKGS, indirect=True, **ids)
def test_autoscaler_min_workers_floor(rt):
    a = _auto(rt)
    client = CTX[rt].get_client()
    sc = a.Autoscaler(client, [a.NodeTypeConfig("floor", {"CPU": 1.0}, min_workers=2, max_workers=4)],
                      interval_s=0.1).start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and sc.status()["managed_count"] < 2:
            time.sleep(0.2)
        assert sc.status()["managed_count"] >= 2
    finally:
        sc.stop()


# ---------------------------------------------------------------- test_distributed.py
@pytest.mark.parametrize("rt", PKGS, indirect=True, **ids)
def test_command_node_provider_launches_joining_agent(rt):
    """The cloud's seam: a shell line starts an ``rt agent`` that joins over
    TCP; terminate removes the node and its process."""
    a = _auto(rt)
    client = CTX[rt].get_client()
    provider = a.CommandNodeProvider(client, _agent_command(rt))
    node = provider.create_node(a.NodeTypeConfig(name="cpu_worker", resources={"CPU": 2}))
    assert node.labels["ray_tpu.io/node-type"] == "cpu_worker"
    assert node.total_resources.get("CPU") == 2.0
    if rt is ray_tpu_torch:
        from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    else:
        from ray_tpu.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    strategy = NodeAffinitySchedulingStrategy(node_id=node.node_id.hex(), soft=False)
    p = rt.get(rt.remote(defs.pid).options(num_cpus=1, scheduling_strategy=strategy).remote(), timeout=T)
    assert p != os.getpid()
    proc = provider._procs[node.node_id]
    provider.terminate_node(node)
    deadline = time.monotonic() + 15
    while any(n.node_id == node.node_id for n in client.node_list()):
        assert time.monotonic() < deadline
        time.sleep(0.2)
    proc.wait(timeout=30)


def _launcher_config(pkg, fmt: str) -> str:
    if fmt == "yaml":
        return f"""
cluster_name: test
head:
  num_cpus: 2
provider:
  type: command
  launch_command: >-
    {_agent_command(pkg)}
available_node_types:
  cpu_worker:
    resources: {{CPU: 2}}
    min_workers: 1
    max_workers: 2
"""
    return json.dumps({"cluster_name": "test", "head": {"num_cpus": 2},
                       "provider": {"type": "command", "launch_command": _agent_command(pkg)},
                       "available_node_types": {"cpu_worker": {"resources": {"CPU": 2}, "min_workers": 1,
                                                               "max_workers": 2}}})


def _yaml_missing() -> bool:
    try:
        import yaml  # noqa: F401
    except ImportError:
        return True
    return False


@pytest.mark.parametrize("fmt", [pytest.param("yaml", marks=pytest.mark.skipif(_yaml_missing(), reason="no pyyaml")),
                                 "json"])
@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_cluster_launcher(pkg, fmt, tmp_path):
    """The ``rt up`` launch: a configuration gives the head, the
    ``min_workers`` floor through the provider and a running autoscaler."""
    a = _auto(pkg)
    for p in PKGS:
        p.shutdown()
    cfg_path = tmp_path / f"cluster.{fmt}"
    cfg_path.write_text(_launcher_config(pkg, fmt))
    cluster = a.LaunchedCluster(a.load_config(str(cfg_path)))
    try:
        nodes = cluster.runtime.node_list()
        workers = [n for n in nodes if n.labels.get("ray_tpu.io/node-type") == "cpu_worker"]
        assert len(workers) == 1, [n.labels for n in nodes]
        assert cluster.autoscaler._thread is not None and cluster.autoscaler._thread.is_alive()
        assert pkg.get(pkg.remote(defs.two).remote(), timeout=60) == 2
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------- the port's own
def test_yaml_without_pyyaml_names_it(tmp_path, monkeypatch):
    """The YAML path imports yaml only there; without it ImportError names
    pyyaml, and a JSON configuration still loads."""
    from ray_tpu_torch.autoscaler import load_config

    monkeypatch.setitem(sys.modules, "yaml", None)  # an import of yaml now raises ImportError
    (tmp_path / "c.yaml").write_text("head: {num_cpus: 1}\n")
    with pytest.raises(ImportError, match="pyyaml"):
        load_config(str(tmp_path / "c.yaml"))
    (tmp_path / "c.json").write_text('{"head": {"num_cpus": 1}}')
    assert load_config(str(tmp_path / "c.json")) == {"head": {"num_cpus": 1}}


@pytest.mark.parametrize("rt", PKGS, indirect=True, **ids)
def test_card_actor_parks_and_shows_in_the_demand(rt):
    """A card actor on a card-less head waits (it is not refused), and the
    demand the autoscaler reads holds it, with a STRICT_PACK group's
    bundles merged: ray_tpu's ``"TPU"`` is the port's ``"GPU"``."""
    from ray_tpu_torch.accelerators.gpu import fold_card

    client = CTX[rt].get_client()
    card = {"num_gpus": 1} if rt is ray_tpu_torch else {"num_tpus": 1}
    actor = rt.remote(**card)(defs.Pinger).remote()
    if rt is ray_tpu_torch:
        from ray_tpu_torch.util.placement_group import placement_group
    else:
        from ray_tpu.util.placement_group import placement_group
    res = "GPU" if rt is ray_tpu_torch else "TPU"
    pg = placement_group([{"CPU": 1, res: 1}, {"CPU": 1}], strategy="STRICT_PACK")
    deadline = time.monotonic() + 10
    while not client.scheduler.pending_demand() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert [fold_card(r) for r in client.scheduler.pending_demand()] == [{"GPU": 1.0}]
    assert [fold_card(r) for r in client.pending_pg_demand()] == [{"CPU": 2.0, "GPU": 1.0}]
    assert rt.wait([actor.ping.remote()], timeout=0.5)[0] == []  # still waiting
    rt.kill(actor)
    if rt is ray_tpu_torch:
        from ray_tpu_torch.util.placement_group import remove_placement_group
    else:
        from ray_tpu.util.placement_group import remove_placement_group
    remove_placement_group(pg)


class _FakeId:
    def __init__(self, name: str):
        self.name = name

    def hex(self) -> str:
        return self.name.encode().hex()


class _FakeNode:
    def __init__(self, name: str, resources: dict, labels: dict | None = None):
        self.node_id = _FakeId(name)
        self.total_resources = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels or {})
        self.workers, self.pg_bundles, self.dispatch_queue = {}, {}, []


class _FakeRuntime:
    """What the autoscaler reads of a head: its nodes and its demand."""

    def __init__(self, head: dict):
        self.nodes = [_FakeNode("head", head)]
        self.demand, self.pg_demand = [], []
        self.scheduler = self

    def node_list(self):
        return list(self.nodes)

    def pending_demand(self):
        return [dict(r) for r in self.demand]

    def pending_pg_demand(self):
        return [dict(r) for r in self.pg_demand]


class _FakeProvider:
    def __init__(self, rt: _FakeRuntime):
        self.rt, self.log, self.made = rt, [], {}
        self._lock = threading.Lock()

    def create_node(self, node_type):
        with self._lock:  # launches run on threads: names count per type
            self.made[node_type.name] = self.made.get(node_type.name, 0) + 1
            node = _FakeNode(f"{node_type.name}-{self.made[node_type.name]}", node_type.resources)
            self.rt.nodes.append(node)
            self.log.append(("launch", node.node_id.name))
        return node

    def terminate_node(self, node):
        with self._lock:
            self.rt.nodes.remove(node)
            self.log.append(("terminate", node.node_id.name))


LONG = 1e9
# each pass: (task demand, placement-group demand, nodes made busy, idle timeout)
SCHEDULE = [
    ([{"CPU": 1}] * 3, [], [], LONG),  # a "small" node and the "floor" one
    ([{"CPU": 1}] * 5, [], [], LONG),  # a second "small"
    ([{"TPU": 1}], [], [], LONG),  # ray_tpu's name for the card: a "card" node
    ([], [{"CPU": 2, "TPU": 1}] * 3, [], LONG),  # one more "card", then max_workers
    ([], [], ["small-1"], 0.0),  # idle nodes go, the busy one and the floor stay
    ([], [], [], 0.0),
]


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_reconcile_decisions_match_across_packages(pkg):
    """The same demand sequence over a fake provider: the launch and
    terminate decisions of each pass equal ray_tpu's, and a ``{"TPU": 1}``
    request launches the card type (``"GPU"`` in the port)."""

    def run(p) -> tuple:
        a = _auto(p)
        rt = _FakeRuntime({"CPU": 1})
        prov = _FakeProvider(rt)
        types = [a.NodeTypeConfig("small", {"CPU": 2}, max_workers=2),
                 a.NodeTypeConfig("card", {"CPU": 2, "TPU": 1}, max_workers=2),
                 a.NodeTypeConfig("floor", {"CPU": 1, "f": 1}, min_workers=1, max_workers=1)]
        sc = a.Autoscaler(rt, types, provider=prov, upscaling_speed=8)
        passes, card_res = [], []
        for demand, pg_demand, busy, idle in SCHEDULE:
            rt.demand, rt.pg_demand, sc.idle_timeout_s = demand, pg_demand, idle
            for n in rt.nodes:
                n.dispatch_queue = ["spec"] if n.node_id.name in busy else []
            prov.log.clear()
            sc.reconcile()
            deadline = time.monotonic() + 10
            while any(sc._launching.values()) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not any(sc._launching.values())
            passes.append((sorted(prov.log), sorted(n.node_id.name for n in rt.nodes)))
            card_res = card_res or [n.total_resources for n in rt.nodes if n.node_id.name.startswith("card")]
        return passes, card_res

    mine, card_res = run(pkg)
    ref, _ = run(ray_tpu)
    assert mine == ref
    assert [names for _, names in ref][3] == ["card-1", "card-2", "floor-1", "head", "small-1", "small-2"], ref
    assert [names for _, names in ref][-1] == ["floor-1", "head"], ref
    if pkg is ray_tpu_torch:
        assert card_res == [{"CPU": 2, "GPU": 1}], card_res  # the first card node, for {"TPU": 1}


def _cli(*args, env, timeout=60):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def test_rt_up_and_down_through_the_cli(tmp_path):
    """``rt up config.json`` runs the head, its floor node and the
    autoscaler in the foreground; ``rt down`` from another shell stops it,
    and a second ``rt down`` finds none."""
    cfg = tmp_path / "cluster.json"
    cfg.write_text(json.dumps({"cluster_name": "cli", "head": {"num_cpus": 2}, "provider": {"type": "local"},
                               "available_node_types": {"cpu_worker": {"resources": {"CPU": 1, "w": 1},
                                                                       "min_workers": 1, "max_workers": 1}}}))
    env = {**os.environ, "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO)}
    up = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.scripts.cli", "up", str(cfg)], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pidfile = tmp_path / "ray_tpu_torch" / f"session_{up.pid}" / "cluster.pid"
        deadline = time.monotonic() + T
        while not pidfile.exists() and up.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert pidfile.exists() and pidfile.read_text() == str(up.pid), up.communicate(timeout=5)[0] if up.poll() else ""
        nodes = []
        while time.monotonic() < deadline:
            p = _cli("list", "nodes", env=env)
            nodes = json.loads(p.stdout) if p.returncode == 0 else []
            if len(nodes) == 2:
                break
            time.sleep(0.5)
        assert len(nodes) == 2 and any(n["resources"].get("w") == 1 for n in nodes), nodes
        p = _cli("down", env=env)
        assert p.returncode == 0 and "sent shutdown" in p.stdout, p.stderr
        out, _ = up.communicate(timeout=T)
        assert up.returncode == 0 and "launching the cluster of" in out, out
        p = _cli("down", env=env)
        assert p.returncode == 1 and "no running `rt up` head" in p.stderr
    finally:
        if up.poll() is None:
            up.kill()
            up.wait(timeout=10)
