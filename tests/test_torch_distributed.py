"""The distributed control plane in the port (``core/node.py``'s agents,
``core/node_agent.py``, the health loop, the RPC chaos sites): the first
five cases of ``tests/test_distributed.py`` on ray_tpu_torch. Its two
cluster-launcher cases wait for ROADMAP.md's **Cluster tooling**.

``add_node`` (``remote=True``, ray_tpu's default) starts a node agent
process whose workers are its children (through its zygote), not the
head's; an actor on it restarts in a fresh process; a SIGKILLed agent is
seen (its socket's end of file) and its tasks retry elsewhere; the
``to_worker`` site delays dispatch through an agent; dropping every
``pong`` makes the health loop declare the node dead. Remote code lives
in ``tests/torch_cluster_defs.py``; every wait has its own bound."""

import os
import signal
import time

import pytest
import torch_cluster_defs as defs

import ray_tpu_torch
from ray_tpu_torch.core import context
from ray_tpu_torch.core import rpc_chaos as tchaos

T = 60
R = ray_tpu_torch.remote


@pytest.fixture(autouse=True)
def _clear_port_chaos():
    tchaos.clear()
    yield
    tchaos.clear()


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield context.get_client()
    ray_tpu_torch.shutdown()


def test_remote_node_is_a_separate_process(rt):
    """add_node starts a node agent process; its workers are the agent's
    children (through its zygote), not the head's."""
    node = rt.add_node({"CPU": 2, "pin": 1})
    assert node.remote
    assert node.agent_proc.pid is not None and node.agent_proc.pid != os.getpid()
    wpid, wppid = ray_tpu_torch.get(R(defs.pid_and_parent).options(resources={"pin": 1}, num_cpus=0).remote(),
                                    timeout=T)
    assert wpid != os.getpid()
    assert wppid != os.getpid()  # the agent's zygote, not the head
    rt.remove_node(node.node_id)
    assert node.agent_proc.poll() is not None  # the agent is gone with its node


def test_actor_on_remote_node_and_restart(rt):
    """The actor's life, restarts included, across the agent's transport."""
    node = rt.add_node({"CPU": 2, "pin": 1})
    a = R(defs.Counter).options(resources={"pin": 1}, num_cpus=0, max_restarts=1).remote()
    assert ray_tpu_torch.get(a.incr.remote(), timeout=T) == 1
    pid0 = ray_tpu_torch.get(a.pid.remote(), timeout=T)
    try:
        ray_tpu_torch.get(a.die.remote(), timeout=10)
    except Exception:  # noqa: BLE001 — the call dies with its actor
        pass
    deadline = time.time() + 30
    pid1 = None
    while time.time() < deadline:
        try:
            pid1 = ray_tpu_torch.get(a.pid.remote(), timeout=5)
            break
        except Exception:  # noqa: BLE001 — the restart is under way
            time.sleep(0.2)
    assert pid1 is not None and pid1 != pid0  # restarted in a fresh process
    rt.remove_node(node.node_id)


def test_agent_crash_fails_over(rt):
    """A SIGKILLed node agent is seen (its socket's end of file) and its
    tasks retry on a node that lives."""
    node1 = rt.add_node({"CPU": 2, "doomed": 1})
    ref = R(defs.slow_done).options(resources={"doomed": 1}, num_cpus=0, max_retries=2).remote(2.0)
    deadline = time.time() + 30
    while time.time() < deadline and not any(w.state == "busy" for w in node1.workers.values()):
        time.sleep(0.1)
    os.kill(node1.agent_proc.pid, signal.SIGKILL)
    node2 = rt.add_node({"CPU": 2, "doomed": 1})
    assert ray_tpu_torch.get(ref, timeout=T) == "done"
    assert not node1.alive
    rt.remove_node(node2.node_id)


def test_agent_relays_worker_frames_unread(rt):
    """A head-bound frame is relayed as bytes the agent never unpickles:
    a task error whose class only the worker and the head know (its
    message spelling "agent_req") reaches the driver, and the node serves
    on."""
    import sys
    import types

    modname = "rt_head_and_worker_only"
    m = types.ModuleType(modname)
    exec("class Boom(Exception):\n    pass\n", m.__dict__)
    sys.modules[modname] = m
    node = rt.add_node({"CPU": 2, "pin": 1})
    try:
        f = R(defs.raise_unknown_to_the_agent).options(resources={"pin": 1}, num_cpus=0, max_retries=0)
        with pytest.raises(Exception, match="agent_req") as ei:
            ray_tpu_torch.get(f.remote(modname), timeout=T)
        assert "Boom" in repr(ei.value) or "Boom" in str(ei.value)
        assert node.alive and node.agent_proc.poll() is None
        g = R(defs.plus_one).options(resources={"pin": 1}, num_cpus=0)
        assert ray_tpu_torch.get(g.remote(1), timeout=T) == 2
    finally:
        sys.modules.pop(modname, None)
        rt.remove_node(node.node_id)


def test_chaos_dispatch_delay(rt):
    """An injected transport delay slows dispatch; nothing breaks."""
    node = rt.add_node({"CPU": 2, "pin": 1})
    f = R(defs.plus_one).options(resources={"pin": 1}, num_cpus=0)
    assert ray_tpu_torch.get(f.remote(1), timeout=T) == 2  # a warm worker first
    tchaos.inject("to_worker", delay_s=0.3)
    t0 = time.time()
    assert ray_tpu_torch.get(f.remote(41), timeout=T) == 42
    assert time.time() - t0 >= 0.3
    tchaos.clear()
    rt.remove_node(node.node_id)


def test_chaos_pong_starvation_kills_node():
    """Dropping every pong makes the health loop declare the node dead,
    and the work that needs its resource runs on a new one."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, _system_config={"health_check_period_s": 0.2,
                                                   "health_check_failure_threshold": 4})
    try:
        client = context.get_client()
        node = client.add_node({"CPU": 2, "pin": 1})
        f = R(defs.ok).options(resources={"pin": 1}, num_cpus=0, max_retries=2)
        assert ray_tpu_torch.get(f.remote(), timeout=T) == "ok"  # the node works
        tchaos.inject("pong", drop_prob=1.0)
        deadline = time.time() + 20
        while time.time() < deadline and node.alive:
            time.sleep(0.1)
        assert not node.alive, "the health loop never declared the starved node dead"
        tchaos.clear()
        client.add_node({"CPU": 2, "pin": 1})
        assert ray_tpu_torch.get(f.remote(), timeout=T) == "ok"
    finally:
        tchaos.clear()
        ray_tpu_torch.shutdown()


def test_stopped_agent_is_declared_dead_and_spares_the_others():
    """A stopped agent (its socket open, no pongs) is declared dead by the
    health loop alone, within period x threshold and a slack; the node's
    removal waits for the hung agent off the loop, so the other node's
    pings go on and it stays alive."""
    period, threshold = 0.2, 3
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, _system_config={"health_check_period_s": period,
                                                   "health_check_failure_threshold": threshold})
    hung = None
    try:
        client = context.get_client()
        hung = client.add_node({"CPU": 1, "a": 1})
        other = client.add_node({"CPU": 1, "b": 1})
        t0 = time.time()
        os.kill(hung.agent_proc.pid, signal.SIGSTOP)
        while hung.alive and time.time() - t0 < period * threshold + 5.0:
            time.sleep(0.02)
        detect = time.time() - t0
        assert not hung.alive, "the health loop never declared the stopped agent's node dead"
        # threshold - 1 periods pass after the last pong at least; one period less for the loop's own timing
        assert period * (threshold - 2) <= detect <= period * threshold + 5.0, detect
        # the removal waits for the hung agent meanwhile
        time.sleep(1.0)
        assert other.alive, "the other node was declared dead while the hung one was being removed"
        os.kill(hung.agent_proc.pid, signal.SIGKILL)
        t1 = time.time()
        while time.time() - t1 < 1.0:
            assert other.alive, "the other node was declared dead after the hung one's removal"
            time.sleep(0.05)
        assert ray_tpu_torch.get(R(defs.ok).options(resources={"b": 1}, num_cpus=0).remote(), timeout=T) == "ok"
    finally:
        if hung is not None and hung.agent_proc.poll() is None:
            os.kill(hung.agent_proc.pid, signal.SIGKILL)
        ray_tpu_torch.shutdown()
