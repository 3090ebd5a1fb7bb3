"""The direct call plane and the runtime's rules in the port
(``ray_tpu_torch``), against ray_tpu where both have the behaviour, on the
CPU (one runtime of each for the module, 4 CPUs, no card).

- Direct calls (``core/direct.py``): small puts owned by the driver, an
  owned argument fetched from its owner, ``promote`` before a
  constrained task, actor calls direct and ordered across a lane switch,
  an actor's death and restart under direct calls, a leased worker's
  death failing over, an idle lease released, owner-side lineage of a
  lost large result, the ``direct_call`` and ``direct_result`` chaos
  sites, ``wait_mixed`` over owned and head ids, and
  ``ObjectRef.get``/``wait``/``future``/``await``.
- The port's rules: its workers hold no jax and no ray_tpu module (with
  ray_tpu's runtime up in the same process) and are forked by the port's
  own zygote, not multiprocessing's forkserver, with the driver's
  ``sys.path``; a lambda, a closure and a function of a file-less
  ``__main__`` raise TypeError at ``.remote()`` naming the difference; a
  ``num_gpus=1`` task on a host with no card stays pending and never runs;
  a tensor off the host is refused by ``put``; the card count is read
  without a CUDA context; the paths still not ported raise naming their
  ROADMAP.md items; the head never replays a direct call's result from
  its record of the call (the owner does, from its lineage); the ``to_worker`` chaos site and an inbound one;
  a worker that cannot start fails the work that waited for it.

Every get carries a timeout."""

import asyncio
import gc
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch_runtime_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu.core import direct as jdirect
from ray_tpu.core import rpc_chaos as jchaos
from ray_tpu_torch.core import context as tcontext
from ray_tpu_torch.core import direct as tdirect
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch.core import rpc_chaos as tchaos

T = 60
REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = (ray_tpu, ray_tpu_torch)
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
DIRECT = {ray_tpu: jdirect, ray_tpu_torch: tdirect}
CHAOS = {ray_tpu: jchaos, ray_tpu_torch: tchaos}


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    yield
    for pkg in PKGS:
        pkg.shutdown()


@pytest.fixture(autouse=True)
def _clear_port_chaos():
    tchaos.clear()
    yield
    tchaos.clear()


def same(fn):
    a, b = fn(ray_tpu), fn(ray_tpu_torch)
    assert a == b, (a, b)
    return a


def client(pkg):
    return CTX[pkg].get_client()


def until(cond, timeout=15.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


# ---------------------------------------------------------------- owned objects
def test_worker_that_cannot_start_fails_what_waited(monkeypatch):
    """A worker that cannot start (here: worker_start_method='fork' from a
    driver that holds a CUDA context, which the port refuses) fails the
    card-bound task, the plain task and the actor creation that waited for
    it with the start's error, and their resources come back: nothing
    stays queued. Runs before the module's runtimes start."""
    ray_tpu_torch.shutdown()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       _system_config={"worker_start_method": "fork", "prestart_workers": False})
    try:
        for opts in ({"num_gpus": 1}, {"num_cpus": 1}):
            with pytest.raises(texc.TaskError, match="CUDA context"):
                ray_tpu_torch.get(ray_tpu_torch.remote(defs.pid).options(**opts).remote(), timeout=T)
        a = ray_tpu_torch.remote(defs.Hi).options(num_gpus=1).remote()
        with pytest.raises(texc.RayTpuError, match="CUDA context"):
            ray_tpu_torch.get(a.hi.remote(), timeout=T)
        total = ray_tpu_torch.cluster_resources()
        assert until(lambda: ray_tpu_torch.available_resources() == total)
    finally:
        ray_tpu_torch.shutdown()


def test_small_put_is_owner_local_and_freed(both):
    def case(pkg):
        st = DIRECT[pkg].state()
        ref = pkg.put({"k": 1})
        k = ref.id.binary()
        local = not client(pkg).store.contains(ref.id) and st.owned.owns(k)
        value = pkg.get(ref, timeout=T)
        del ref
        gc.collect()
        return local, value, until(lambda: st.owned.entry(k) is None)

    assert same(case) == (True, {"k": 1}, True)


def test_worker_fetches_owned_arg_from_owner(both):
    assert same(lambda pkg: pkg.get(pkg.remote(defs.total).remote(pkg.put(list(range(50)))), timeout=T)) == 1225


def test_owned_ref_promoted_for_constrained_task(both):
    def case(pkg):
        c = client(pkg)
        ref = pkg.put(41)
        node = c.add_node({"CPU": 1, "spice": 1}, remote=False)
        try:
            out = pkg.get(pkg.remote(defs.inc).options(resources={"spice": 1}, num_cpus=0).remote(ref), timeout=T)
            return out, c.store.contains(ref.id)  # promotion moved it into the head's store
        finally:
            c.remove_node(node.node_id)

    assert same(case) == (42, True)


def test_promote_moves_an_owned_object_to_the_head(both):
    def case(pkg):
        c = client(pkg)
        ref = pkg.put([1, 2, 3])
        k = ref.id.binary()
        moved = DIRECT[pkg].promote(c, k)
        again = DIRECT[pkg].promote(c, k)  # idempotent
        return moved, again, c.store.contains(ref.id), DIRECT[pkg].state().owned.owns(k), pkg.get(ref, timeout=T)

    assert same(case) == (True, True, True, False, [1, 2, 3])


# ---------------------------------------------------------------- actors
def test_actor_calls_are_direct_and_ordered(both):
    def case(pkg):
        s = pkg.remote(defs.Seq).remote()
        refs = [s.add.remote(i) for i in range(50)]
        out = pkg.get(refs[-1], timeout=T), pkg.get(s.get_log.remote(), timeout=T)
        return out, any(r.addr is not None for r in DIRECT[pkg].state().routes.values())

    assert same(case) == ((50, list(range(50))), True)


def test_lane_switch_preserves_order(both):
    def case(pkg):
        r = pkg.remote(defs.Rec).remote()
        r.mark.remote("a")
        items = [pkg.get(x, timeout=T) for x in r.stream.options(num_returns="streaming").remote(2)]  # head lane
        r.mark.remote("b")  # direct again: the fence drains the head lane
        return items, pkg.get(r.get_log.remote(), timeout=T)

    assert same(case) == ([0, 1], ["a", "s0", "s1", "b"])


def test_actor_death_fails_inflight_direct_calls(both):
    def case(pkg):
        a = pkg.remote(defs.Sleeper).remote()
        warm = pkg.get(a.nap.remote(0.01), timeout=T)
        slow = a.nap.remote(30)
        time.sleep(0.3)
        pkg.kill(a)
        with pytest.raises(Exception) as ei:
            pkg.get(slow, timeout=30)
        return warm, type(ei.value).__name__

    assert same(case)[0] == "ok"


def test_actor_restart_failover_reruns_direct_call(both):
    def case(pkg):
        w = pkg.remote(defs.Restarting).options(max_restarts=2).remote()
        first = pkg.get(w.work.remote(), timeout=T)
        dead = w.work.remote(die=True)  # kills the worker mid direct call
        with pytest.raises(Exception):  # max_task_retries=0: at most once
            pkg.get(dead, timeout=T)
        return first, pkg.get(w.work.remote(), timeout=T)  # restarted, fresh state

    assert same(case) == (1, 1)


def test_direct_result_drop_triggers_failover(both):
    def case(pkg):
        e = pkg.remote(defs.Echo).options(max_task_retries=2).remote()
        warm = pkg.get(e.hi.remote(1), timeout=T)
        CHAOS[pkg].inject("direct_result", drop_prob=1.0, max_hits=1)
        try:
            # the dropped reply fails the connection; a retriable call fails over to the head path
            return warm, pkg.get(e.hi.remote(2), timeout=T), CHAOS[pkg]._rules["direct_result"].hits
        finally:
            CHAOS[pkg].clear()

    assert same(case) == (1, 2, 1)


# ---------------------------------------------------------------- leases
def test_leased_worker_death_fails_over(both):
    def case(pkg):
        marker = os.path.join(tempfile.mkdtemp(), "marker")
        return pkg.get(pkg.remote(defs.die_once).options(max_retries=3).remote(marker), timeout=120)

    assert same(case) == "second"


def test_lease_released_when_idle(both):
    def case(pkg):
        c = client(pkg)
        one = pkg.get(pkg.remote(defs.sq).remote(1), timeout=T)
        with c._leases_lock:
            live = len(c._leases) >= 1  # a lease is live right after use
        return one, live, until(lambda: not c._leases)

    assert same(case) == (1, True, True)


def test_owner_lineage_replays_lost_large_result(both):
    def case(pkg):
        c = client(pkg)
        ref = pkg.remote(defs.big).remote(3)
        first = np.asarray(pkg.get(ref, timeout=T)).copy()
        sealed = c.store.contains(ref.id)  # a large direct result is sealed in the head's store
        evicted = c.store.evict(ref.id)
        second = np.asarray(pkg.get(ref, timeout=T))
        return sealed, evicted, bool((first == second).all())

    assert same(case) == (True, True, True)


def test_owner_lineage_replays_lost_large_result_after_the_heads_record(both, tmp_path):
    """The race behind ``test_owner_lineage_replays_lost_large_result``,
    made deterministic: the worker's task events of the direct call reach
    the head (its task table then holds a record of the call, with no
    function) before the large result is evicted. The head must not
    replay that record itself; the owner (this driver) replays the call
    from its lineage, and the function runs twice."""
    c = client(ray_tpu_torch)
    path = str(tmp_path / "runs")
    ref = ray_tpu_torch.remote(defs.counted_big).remote(path, 3)
    first = np.asarray(ray_tpu_torch.get(ref, timeout=T)).copy()
    assert c.store.contains(ref.id)
    deadline = time.monotonic() + T
    while c.task_manager.get(ref.id.task_id()) is None:
        assert time.monotonic() < deadline, "the worker's task events never reached the head"
        time.sleep(0.05)
    assert c.store.evict(ref.id)
    second = np.asarray(ray_tpu_torch.get(ref, timeout=T))
    assert (first == second).all()
    with open(path) as f:
        assert len(f.read().split()) == 2


def test_direct_call_drop_degrades_to_head_path(both):
    def case(pkg):
        s = pkg.remote(defs.sq)
        warm = pkg.get(s.remote(2), timeout=T)
        CHAOS[pkg].inject("direct_call", drop_prob=1.0)
        try:
            out = pkg.get([s.remote(i) for i in range(8)], timeout=T)
            return warm, out, CHAOS[pkg]._rules["direct_call"].hits >= 8
        finally:
            CHAOS[pkg].clear()

    assert same(case) == (4, [i * i for i in range(8)], True)


# ---------------------------------------------------------------- waits and refs
def test_wait_mixed_and_ref_methods(both):
    def case(pkg):
        owned = pkg.put(5)
        head = pkg.remote(defs.sq).options(num_cpus=2).remote(3)  # head path: not one CPU
        slow = pkg.remote(defs.sleepy).options(num_cpus=2).remote(3.0)
        ready, rest = pkg.wait([owned, head, slow], num_returns=2, timeout=30)
        fut = head.future().result(timeout=T)
        awaited = asyncio.run(asyncio.wait_for(_await(head), T))
        return ready == [owned, head], rest == [slow], head.get(timeout=T), head.wait(timeout=5), fut, awaited

    assert same(case) == (True, True, 9, True, 9, 9)


async def _await(ref):
    return await ref


# ---------------------------------------------------------------- the port's rules
def test_port_worker_holds_no_jax_and_comes_from_the_zygote(both):
    """With ray_tpu's runtime (and jax) up in this process, a port worker
    imports neither: it is forked by the port's own zygote (not
    multiprocessing's forkserver, which ray_tpu uses) and has the
    driver's sys.path."""
    from ray_tpu_torch.core import node as tnode

    assert "jax" in sys.modules and jcontext.maybe_client() is not None
    bad, is_worker = ray_tpu_torch.get(ray_tpu_torch.remote(defs.loaded_modules).remote(), timeout=T)
    assert bad == [] and is_worker
    ppid, path = ray_tpu_torch.get(ray_tpu_torch.remote(defs.worker_facts).remote(), timeout=T)
    from multiprocessing import forkserver

    assert ppid == tnode.zygote_pid() and ppid != forkserver._forkserver._forkserver_pid and ppid != os.getpid()
    assert str(REPO / "tests") in path and path == [p for p in sys.path]
    jbad, jworker = ray_tpu.get(ray_tpu.remote(defs.loaded_modules).remote(), timeout=T)
    assert not jworker and any(m.startswith("ray_tpu") for m in jbad)


def _closure():
    def local(x):
        return x

    return local


def test_code_without_an_importable_name_raises_type_error(both):
    with pytest.raises(TypeError, match="lambda.*by reference"):
        ray_tpu_torch.remote(lambda x: x).remote(1)
    with pytest.raises(TypeError, match="inside a function.*by reference"):
        ray_tpu_torch.remote(_closure()).remote(1)

    class Local:
        pass

    with pytest.raises(TypeError, match="inside a function.*by reference"):
        ray_tpu_torch.remote(Local).remote()
    # ray_tpu ships both by value
    assert ray_tpu.get(ray_tpu.remote(lambda x: x + 1).remote(1), timeout=T) == 2


DRIVER = """
import ray_tpu_torch as rt
rt.init(num_cpus=1, _system_config={"prestart_workers": False})
def f(x):
    return x
try:
    f_ref = rt.remote(f).remote(1)
    print("no error")
except TypeError as e:
    print("TypeError:", e)
rt.shutdown()
"""


@pytest.mark.parametrize("how", ["-c", "stdin"])
def test_file_less_main_raises_type_error(how):
    """A function of a driver with no file (``python -c``, a heredoc on
    stdin) raises TypeError at .remote(), naming the difference."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    args = [sys.executable, "-c", DRIVER] if how == "-c" else [sys.executable, "-"]
    out = subprocess.run(args, input=None if how == "-c" else DRIVER, capture_output=True, text=True, env=env,
                         timeout=120, cwd=tempfile.gettempdir())
    assert out.returncode == 0, out.stderr
    assert "TypeError: the function f is defined in a __main__ with no file" in out.stdout
    assert "by reference" in out.stdout


def test_gpu_task_on_a_host_with_no_card_stays_pending(both):
    path = os.path.join(tempfile.mkdtemp(), "ran")
    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    ref = ray_tpu_torch.remote(defs.touch).options(num_gpus=1).remote(path)
    ready, _ = ray_tpu_torch.wait([ref], timeout=1.5)
    assert ready == [] and not os.path.exists(path)
    assert ray_tpu_torch.cancel(ref) is None
    with pytest.raises(ray_tpu_torch.exceptions.RayTpuError, match="cancelled"):
        ray_tpu_torch.get(ref, timeout=T)
    assert not os.path.exists(path)  # never run, on the CPU or anywhere


def test_device_tensor_put_raises(both):
    with pytest.raises(TypeError, match=r"\.cpu\(\)"):
        ray_tpu_torch.put(torch.ones(4, device="meta"))
    with pytest.raises(TypeError, match=r"\.cpu\(\)"):
        ray_tpu_torch.remote(defs.ident).remote(torch.ones(4, device="meta"))


def test_card_count_is_read_without_a_cuda_context(monkeypatch):
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager as G

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert G.get_current_node_num_accelerators() == torch.cuda.device_count()
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("RT_NUM_GPUS", "2")
    assert G.get_current_node_num_accelerators() == 2
    assert G.worker_env_for_chips([1]) == {"CUDA_VISIBLE_DEVICES": "1"} and G.get_resource_name() == "GPU"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")  # the driver's own cards: a worker's index maps into them
    assert G.worker_env_for_chips([1]) == {"CUDA_VISIBLE_DEVICES": "5"}
    assert G.validate_resource_request_quantity(1) == (True, None) and not G.validate_resource_request_quantity(3)[0]


def test_paths_not_ported_name_their_roadmap_items(both):
    """Each path still not ported raises naming its ROADMAP.md queue 1
    item, and each item is a bold one there."""
    from ray_tpu_torch import serve as tserve
    from ray_tpu_torch.scripts import cli as tcli

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.parallel.mesh import create_mesh

    roadmap = (REPO / "ROADMAP.md").read_text()
    # serving over a pure tp mesh is ported (tests/test_torch_engine_tp.py);
    # meshes in training and a serving mesh with other axes still raise
    mixed = create_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    calls = [
        (lambda: tserve.start(grpc_port=0), tcontext.GRPC_ITEM),
        (lambda: tcli.main(["lint"]), tcontext.LINT_ITEM),
        (lambda: tts.make_train_step(lambda p, b: None, lambda ps: None, mesh=mixed, device="cpu"),
         tcontext.MESH_ITEM),
        (lambda: LLMEngine(LlamaConfig.tiny(dtype="float32"), max_seq_len=64, mesh=mixed), tcontext.MESH_ITEM),
    ]
    for call, item in calls:
        with pytest.raises(NotImplementedError, match=item):
            call()
    for item in (tcontext.GRPC_ITEM, tcontext.LINT_ITEM, tcontext.MESH_ITEM):
        assert "**" + item.split(", ", 1)[1].lower() in roadmap.lower(), item  # a bold item of ROADMAP.md's queue 1


def test_to_worker_and_inbound_chaos_sites(both):
    """``to_worker`` delays every message the head sends a worker, and an
    inbound site (``done``, by the message's type) delays what a worker
    sends the head: a task down the head path still completes."""
    s = ray_tpu_torch.remote(defs.sq).options(num_cpus=2)  # the head path: dispatched over the pipe
    try:
        tchaos.inject("to_worker", delay_s=0.05)
        tchaos.inject("done", delay_s=0.05)
        assert ray_tpu_torch.get(s.remote(7), timeout=T) == 49
        assert tchaos._rules["to_worker"].hits >= 1 and tchaos._rules["done"].hits >= 1
    finally:
        tchaos.clear()
