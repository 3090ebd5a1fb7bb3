"""Scheduling on the port's runtime (``ray_tpu_torch``) against ray_tpu's,
on the CPU.

- Every case of ``tests/test_core_scheduling.py`` (custom resources, an
  infeasible task queued until a node is added, SPREAD, placement groups
  PACK/STRICT_SPREAD, their atomicity, an actor in a group, a node's
  death with a task retried, lineage after an eviction, the cluster's
  resources), each on fresh runtimes of both packages with nodes added
  through ``add_node(remote=False)``.
- Pure parity, no processes: ``SchedulingPolicy.pick`` on 200 seeded
  random clusters and requests gives the same node index, "retry" or
  None; ``_plan_pg`` on seeded bundles and strategies the same plan;
  ``_sched_options`` the same options ("TPU" <-> "GPU"); ``Gcs``'s KV,
  pubsub and events the same answers over seeded operation sequences.

Every get carries a timeout."""

import random
import time

import numpy as np
import pytest
import torch_runtime_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu.core import gcs as jgcs
from ray_tpu.core import node as jnode
from ray_tpu.core import runtime as jruntime
from ray_tpu.core import scheduler as jsched
from ray_tpu.core import task_spec as jspec
from ray_tpu.core.ids import NodeID as JNodeID
from ray_tpu.core.ids import PlacementGroupID as JPGID
from ray_tpu.core.ids import TaskID as JTaskID
from ray_tpu.util import placement_group as jpg
from ray_tpu.util import scheduling_strategies as jss
from ray_tpu_torch.core import context as tcontext
from ray_tpu_torch.core import gcs as tgcs
from ray_tpu_torch.core import node as tnode
from ray_tpu_torch.core import runtime as truntime
from ray_tpu_torch.core import scheduler as tsched
from ray_tpu_torch.core import task_spec as tspec
from ray_tpu_torch.core.ids import NodeID as TNodeID
from ray_tpu_torch.core.ids import PlacementGroupID as TPGID
from ray_tpu_torch.core.ids import TaskID as TTaskID
from ray_tpu_torch.util import placement_group as tpg
from ray_tpu_torch.util import scheduling_strategies as tss

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
PG = {ray_tpu: jpg, ray_tpu_torch: tpg}
SS = {ray_tpu: jss, ray_tpu_torch: tss}


@pytest.fixture
def both():
    """Fresh single-node runtimes of both packages, 4 CPUs each."""
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    yield
    for pkg in PKGS:
        pkg.shutdown()


def same(fn):
    a, b = fn(ray_tpu), fn(ray_tpu_torch)
    assert a == b, (a, b)
    return a


def client(pkg):
    return CTX[pkg].get_client()


# ---------------------------------------------------------------- test_core_scheduling.py's cases
def test_custom_resources(both):
    def case(pkg):
        client(pkg).add_node({"CPU": 2, "widget": 1}, remote=False)
        return pkg.get(pkg.remote(defs.made).options(resources={"widget": 1}, num_cpus=0).remote(), timeout=T)

    assert same(case) == "made"


def test_infeasible_task_queued_until_node_added(both):
    def case(pkg):
        ref = pkg.remote(defs.forty_two).options(resources={"special": 1}, num_cpus=0).remote()
        ready, _ = pkg.wait([ref], timeout=0.5)
        client(pkg).add_node({"CPU": 1, "special": 1}, remote=False)
        return ready, pkg.get(ref, timeout=30)

    assert same(case) == ([], 42)


def test_spread_strategy(both):
    def case(pkg):
        for _ in range(2):
            client(pkg).add_node({"CPU": 4}, remote=False)
        w = pkg.remote(defs.where).options(scheduling_strategy="SPREAD")
        return len(set(pkg.get([w.remote() for _ in range(6)], timeout=T))) >= 2

    assert same(case)


def test_placement_group_pack(both):
    def case(pkg):
        pg = PG[pkg].placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        strat = SS[pkg].PlacementGroupSchedulingStrategy(placement_group=pg, placement_group_bundle_index=0)
        out = pkg.get(pkg.remote(defs.in_pg).options(num_cpus=1, scheduling_strategy=strat).remote(), timeout=T)
        PG[pkg].remove_placement_group(pg)
        return out, [r["state"] for r in PG[pkg].placement_group_table()]

    assert same(case) == ("in-pg", ["REMOVED"])


def test_placement_group_strict_spread_infeasible_single_node(both):
    def case(pkg):
        pg = PG[pkg].placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        first = pg.wait(timeout_seconds=0.5)
        client(pkg).add_node({"CPU": 2}, remote=False)
        client(pkg).add_node({"CPU": 2}, remote=False)
        return first, pg.wait(timeout_seconds=10)

    assert same(case) == (False, True)


def test_placement_group_atomicity(both):
    def case(pkg):
        c = client(pkg)
        before = dict(c.cluster_info("available_resources"))
        pg = PG[pkg].placement_group([{"CPU": 2}, {"CPU": 100}], strategy="SPREAD")
        placed = pg.wait(timeout_seconds=0.5)
        after = dict(c.cluster_info("available_resources"))
        return placed, before.get("CPU") == after.get("CPU")

    assert same(case) == (False, True)


def test_actor_in_placement_group(both):
    def case(pkg):
        pg = PG[pkg].placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        strat = SS[pkg].PlacementGroupSchedulingStrategy(placement_group=pg)
        a = pkg.remote(defs.Hi).options(num_cpus=1, scheduling_strategy=strat).remote()
        return pkg.get(a.hi.remote(), timeout=T)

    assert same(case) == "hi"


def test_node_death_task_retry(both):
    def case(pkg):
        c = client(pkg)
        node = c.add_node({"CPU": 2, "doomed": 2}, remote=False)
        ref = pkg.remote(defs.slow_on_doomed).options(resources={"doomed": 1}, num_cpus=0, max_retries=2).remote()
        time.sleep(0.6)  # the task started on the doomed node
        c.remove_node(node.node_id)
        c.add_node({"CPU": 2, "doomed": 2}, remote=False)  # the task was infeasible; now it is not
        return pkg.get(ref, timeout=30)

    assert same(case) == "done"


def test_object_eviction_reconstruction(both):
    """An evicted store-sized task output is rebuilt through lineage."""
    def case(pkg):
        ref = pkg.remote(defs.produce).remote(42)
        first = np.asarray(pkg.get(ref, timeout=T)).copy()
        assert client(pkg).store.evict(ref.id)
        second = np.asarray(pkg.get(ref, timeout=30))
        return bool((first == second).all()), first.tolist()[:8]

    assert same(case)[0]


def test_cluster_resources_api(both):
    def case(pkg):
        total = pkg.cluster_resources()
        return total.get("CPU", 0) >= 4, len(pkg.nodes())

    assert same(case) == (True, 1)


# ---------------------------------------------------------------- pure parity
def _cluster(rng: random.Random, idx: int):
    """One seeded random cluster, built in both packages: (jax nodes,
    torch nodes, pg ids); node i has NodeID bytes i+1 repeated."""
    n = rng.randint(1, 5)
    jn, tn = [], []
    pg = bytes([0xA0 + idx % 16]) * 16
    for i in range(n):
        res = {"CPU": float(rng.choice([0, 1, 2, 4, 8])), "memory": 8.0}
        cards = rng.choice([0, 0, 1, 2, 4])
        if cards:
            res["CARD"] = float(cards)
        if rng.random() < 0.3:
            res["widget"] = float(rng.randint(1, 2))
        labels = {"zone": rng.choice("ab"), "tier": rng.choice("xy")}
        nid = bytes([i + 1]) * 16
        j = jnode.Node(JNodeID(nid), {k.replace("CARD", "TPU"): v for k, v in res.items()}, labels=labels)
        t = tnode.Node(TNodeID(nid), {k.replace("CARD", "GPU"): v for k, v in res.items()}, labels=labels)
        take = {k: float(rng.randint(0, int(v))) for k, v in res.items() if rng.random() < 0.5}
        if rng.random() < 0.3 and res["CPU"] >= 1:
            bundle = {"CPU": 1.0}
            assert j.reserve_bundle(JPGID(pg), i, bundle) == t.reserve_bundle(TPGID(pg), i, bundle)
        assert j.allocate({k.replace("CARD", "TPU"): v for k, v in take.items()}) == t.allocate(
            {k.replace("CARD", "GPU"): v for k, v in take.items()})
        j.alive = t.alive = rng.random() > 0.1
        jn.append(j)
        tn.append(t)
    return jn, tn, pg


def _request(rng: random.Random, n_nodes: int, pg: bytes):
    res = {}
    if rng.random() < 0.8:
        res["CPU"] = float(rng.choice([0.5, 1, 2, 4]))
    if rng.random() < 0.3:
        res["CARD"] = float(rng.choice([1, 2]))
    if rng.random() < 0.15:
        res["widget"] = 1.0
    kw = {}
    r = rng.random()
    if r < 0.15:
        kw["node_id"] = (bytes([rng.randint(1, n_nodes + 1)]) * 16).hex()
    elif r < 0.3:
        kw["soft_node_id"] = (bytes([rng.randint(1, n_nodes)]) * 16).hex()
    elif r < 0.45:
        kw["placement_group"] = pg
        kw["bundle_index"] = rng.choice([-1, 0, 1, 2])
    if rng.random() < 0.2:
        kw["label_selector"] = rng.choice([{"zone": "a"}, {"tier": "!x"}, {"zone": "b", "tier": "y"}])
    strategy = "SPREAD" if rng.random() < 0.25 else "DEFAULT"
    return res, kw, strategy


def _spec(mod, pkg_card, task_id_cls, pg_cls, res, kw, strategy):
    kw = dict(kw)
    if "placement_group" in kw:
        kw["placement_group"] = pg_cls(kw["placement_group"])
    sched = mod.SchedulingOptions(resources={k.replace("CARD", pkg_card): v for k, v in res.items()},
                                  scheduling_strategy=strategy, **kw)
    return mod.TaskSpec(task_id=task_id_cls(b"\x01" * 16), name="t", func_id="f", args=[], scheduling=sched)


def test_scheduling_policy_pick_matches_ray_tpu():
    """200 seeded random clusters (1-5 nodes, cards, custom resources,
    labels, a placement group, dead nodes) and requests (resources, hard
    and soft affinity, labels, bundles, SPREAD): the same node index,
    "retry" or None from both policies, SPREAD's round robin included."""
    rng = random.Random(20261017)
    jp, tp = jsched.SchedulingPolicy(), tsched.SchedulingPolicy()
    outcomes = set()
    for idx in range(200):
        jn, tn, pg = _cluster(rng, idx)
        for _ in range(3):
            res, kw, strategy = _request(rng, len(jn), pg)
            js = _spec(jspec, "TPU", JTaskID, JPGID, res, kw, strategy)
            ts = _spec(tspec, "GPU", TTaskID, TPGID, res, kw, strategy)
            j, t = jp.pick(js, jn), tp.pick(ts, tn)
            ji = j if j in (None, "retry") else jn.index(j)
            ti = t if t in (None, "retry") else tn.index(t)
            assert ji == ti, (idx, res, kw, strategy)
            outcomes.add("node" if isinstance(ji, int) else ji)
    assert outcomes == {"node", "retry", None}


def test_plan_pg_matches_ray_tpu():
    rng = random.Random(7)
    plans = set()
    for idx in range(150):
        jn, tn, _ = _cluster(rng, idx)
        jn = [n for n in jn if n.alive]
        tn = [n for n in tn if n.alive]
        bundles = [{"CPU": float(rng.choice([1, 2])), **({"CARD": 1.0} if rng.random() < 0.2 else {})}
                   for _ in range(rng.randint(1, 4))]
        strategy = rng.choice(["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"])
        j = jruntime._plan_pg([{k.replace("CARD", "TPU"): v for k, v in b.items()} for b in bundles], strategy, jn)
        t = truntime._plan_pg([{k.replace("CARD", "GPU"): v for k, v in b.items()} for b in bundles], strategy, tn)
        ji = None if j is None else [jn.index(n) for n in j]
        ti = None if t is None else [tn.index(n) for n in t]
        assert ji == ti, (idx, bundles, strategy)
        plans.add(ji is None)
    assert plans == {True, False}


def test_sched_options_match_ray_tpu():
    pg_bytes = b"\x07" * 16
    jpgo, tpgo = jpg.PlacementGroup(JPGID(pg_bytes)), tpg.PlacementGroup(TPGID(pg_bytes))
    cases = [
        ({}, False), ({}, True), ({"num_cpus": 2}, False), ({"num_cpus": 0}, False), ({"num_gpus": 1}, False),
        ({"num_tpus": 2}, True), ({"num_gpus": 4, "num_cpus": 1}, False), ({"resources": {"widget": 2}}, False),
        ({"memory": 1024}, False), ({"placement_group": "PG", "placement_group_bundle_index": 1}, False),
        ({"scheduling_strategy": "SPREAD"}, False), ({"scheduling_strategy": "NA_HARD"}, False),
        ({"scheduling_strategy": "NA_SOFT"}, True), ({"scheduling_strategy": "PGS"}, False),
        ({"label_selector": {"zone": "a"}}, False),
    ]
    for opts, is_actor in cases:
        built = []
        for mod, ss, pgo, card in ((jruntime, jss, jpgo, "TPU"), (truntime, tss, tpgo, "GPU")):
            o = dict(opts)
            if o.get("placement_group") == "PG":
                o["placement_group"] = pgo
            strat = o.get("scheduling_strategy")
            if strat in ("NA_HARD", "NA_SOFT"):
                o["scheduling_strategy"] = ss.NodeAffinitySchedulingStrategy(node_id="ab" * 16, soft=strat == "NA_SOFT")
            elif strat == "PGS":
                o["scheduling_strategy"] = ss.PlacementGroupSchedulingStrategy(placement_group=pgo,
                                                                               placement_group_bundle_index=0)
            s = mod._sched_options(o, is_actor=is_actor)
            built.append(({k.replace(card, "CARD"): v for k, v in s.resources.items()}, s.node_id, s.soft_node_id,
                          None if s.placement_group is None else s.placement_group.binary(), s.bundle_index,
                          s.scheduling_strategy, s.label_selector))
        assert built[0] == built[1], opts
    for bad in (3, 0.5, 16):
        with pytest.raises(ValueError):
            jruntime._sched_options({"num_tpus": bad})
        with pytest.raises(ValueError):
            truntime._sched_options({"num_gpus": bad})


def _kv_ops(g, rng):
    out = []
    keys = [b"a", b"ab", b"b", "s", "st", b"", ("t", 1)]
    for _ in range(400):
        op = rng.choice(["put", "put", "get", "delete", "exists", "keys"])
        ns = rng.choice(["default", "n1"])
        k = rng.choice(keys)
        if op == "put":
            out.append(g.kv.put(k, rng.randint(0, 9), overwrite=rng.random() < 0.7, namespace=ns))
        elif op == "get":
            out.append(g.kv.get(k, namespace=ns))
        elif op == "delete":
            out.append(g.kv.delete(k, namespace=ns))
        elif op == "exists":
            out.append(g.kv.exists(k, namespace=ns))
        else:
            prefix = rng.choice([b"", b"a", "s", b"z"])
            out.append(sorted(map(repr, g.kv.keys(prefix, namespace=ns))))
    return out


def _pubsub_ops(g, rng):
    out, subs = [], []
    for i in range(200):
        op = rng.choice(["sub", "pub", "pub", "unsub"])
        ch = rng.choice(["node", "actor"])
        if op == "sub":
            box = []
            subs.append((box, g.pubsub.subscribe(ch, box.append)))
        elif op == "pub":
            g.pubsub.publish(ch, {"i": i, "ch": ch})
        elif subs:
            subs.pop(rng.randrange(len(subs)))[1]()
    for box, unsub in subs:
        out.append(list(box))
        unsub()
    return out


def _event_ops(g, rng):
    g.events.capacity = 50
    for i in range(300):
        g.events.record(rng.choice(["task_submitted", "actor_created", "node_added"]), name=rng.choice(["f", "g.m"]), i=i)
    return [[(e["kind"], e["name"], e["i"]) for e in g.events.query(kind=k, pattern=p, limit=lim)]
            for k, p, lim in ((None, None, 1000), ("node_added", None, 10), (None, "g.*", 5), ("task_submitted", "f", 3))]


@pytest.mark.parametrize("ops", [_kv_ops, _pubsub_ops, _event_ops], ids=["kv", "pubsub", "events"])
def test_gcs_matches_ray_tpu(ops):
    """Gcs's KV (namespaces, overwrite, prefixes, mixed key types), pubsub
    (subscribe, publish, unsubscribe) and event buffer (its bound, kind and
    name filters) over one seeded operation sequence per package."""
    j = ops(jgcs.Gcs(), random.Random(3))
    t = ops(tgcs.Gcs(), random.Random(3))
    assert j == t and len(j) > 0
    jg, tg = jgcs.Gcs(), tgcs.Gcs()
    for g in (jg, tg):
        assert g.register_named_actor("a", "ns", 1) and not g.register_named_actor("a", "ns", 2)
        g.unregister_named_actor("a", "ns")
        assert g.lookup_named_actor("a", "ns") is None
    assert jg.list_named_actors() == tg.list_named_actors()
