"""Objects across shm namespaces in the port (``core/transport.py``,
``object_store.ensure_local_segment``, the agents' ``fetch_object``): the
cases of ``tests/test_transport.py`` on ray_tpu_torch.

The "hosts" are nodes with a shm namespace of their own
(``add_node(shm_isolation=True)``): every object that crosses a node's
boundary rides the TCP transfer service, so the transfer counters and the
cached copies' segment names show it. ray_tpu's JaxTrainer case becomes
the port's JaxTrainer, whose two workers (one per isolated node) join a
torch.distributed gloo group and all-gather. Then a standalone ``rt
agent`` joining over TCP, and ``_recv_to_file``'s splice path.

One head and two isolated nodes serve the module; the node-death case
kills a node of its own. Remote code lives in ``tests/torch_cluster_defs.py``.
Every wait has its own bound."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch_cluster_defs as defs

import ray_tpu_torch
from ray_tpu_torch.core import context, transport
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60
R = ray_tpu_torch.remote


def _pin(node, soft: bool = False):
    return NodeAffinitySchedulingStrategy(node_id=node.node_id.hex(), soft=soft)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A head and two isolated nodes; the session under a temporary
    directory of its own, so a joining `rt agent` (given it as TMPDIR)
    finds this head and not another test process's."""
    import tempfile

    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("sessions"))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1)
    try:
        client = context.get_client()
        n1 = client.add_node({"CPU": 2.0, "trainer": 1.0}, shm_isolation=True)
        n2 = client.add_node({"CPU": 2.0, "trainer": 1.0}, shm_isolation=True)
        yield client, n1, n2
    finally:
        ray_tpu_torch.shutdown()
        tempfile.tempdir = old


@pytest.fixture
def iso_cluster(cluster):
    transport.reset_stats()
    return cluster


def test_isolated_nodes_have_distinct_namespaces(iso_cluster):
    client, n1, n2 = iso_cluster
    assert n1.shm_ns and n2.shm_ns
    assert len({client._head_ns, n1.shm_ns, n2.shm_ns}) == 3
    # the head's directory knows every namespace's transfer address
    assert n1.shm_ns in client._ns_addrs and n2.shm_ns in client._ns_addrs


def test_driver_pulls_remote_object_over_tcp(iso_cluster):
    client, n1, _ = iso_cluster
    ref = R(defs.arange).options(scheduling_strategy=_pin(n1)).remote(500_000)
    v = ray_tpu_torch.get(ref, timeout=T)
    assert v.shape == (500_000,) and v[-1] == 499_999
    # the bytes crossed the transfer service into the head's namespace
    assert transport.STATS["pulls"] >= 1
    assert transport.STATS["pull_bytes"] >= v.nbytes


def test_cross_node_transfer_no_fast_path(iso_cluster):
    """n2 consumes n1's output: n2's agent pulls it node to node and leaves
    a cached copy in n2's namespace."""
    client, n1, n2 = iso_cluster
    ref = R(defs.full).options(scheduling_strategy=_pin(n1)).remote(300_000, 7.0)
    total = ray_tpu_torch.get(R(defs.total).options(scheduling_strategy=_pin(n2)).remote(ref), timeout=T)
    assert total == 7.0 * 300_000
    oid = ref.id.hex()
    assert os.path.exists(f"/dev/shm/rt{n1.shm_ns}_{oid}")  # the producer's segment, in n1's namespace
    deadline = time.monotonic() + 10
    while not os.path.exists(f"/dev/shm/rt{n2.shm_ns}_{oid}"):
        assert time.monotonic() < deadline, "no cached copy in the consumer's namespace"
        time.sleep(0.1)


def test_worker_put_fetched_by_driver(iso_cluster):
    client, n1, _ = iso_cluster
    inner = ray_tpu_torch.get(R(defs.put_inner).options(scheduling_strategy=_pin(n1)).remote(300_000), timeout=T)[0]
    assert ray_tpu_torch.get(inner, timeout=T).sum() == 300_000
    assert transport.STATS["pulls"] >= 1


def test_remote_free_unlinks_producer_segment(iso_cluster):
    client, n1, _ = iso_cluster
    ref = R(defs.zeros).options(scheduling_strategy=_pin(n1)).remote(200_000)
    ray_tpu_torch.get(ref, timeout=T)
    name = f"/dev/shm/rt{n1.shm_ns}_{ref.id.hex()}"
    assert os.path.exists(name)
    client.free_objects([ref.id])
    deadline = time.monotonic() + 10
    while os.path.exists(name):
        assert time.monotonic() < deadline, "free_shm never reached the producer's agent"
        time.sleep(0.1)


def test_node_death_triggers_lineage_reconstruction(iso_cluster):
    """The producing node dies with its namespace; get() falls back to
    lineage reconstruction on a node that lives."""
    client, _, _ = iso_cluster
    n3 = client.add_node({"CPU": 2.0}, shm_isolation=True)
    ref = R(defs.arange).options(scheduling_strategy=_pin(n3, soft=True), max_retries=3).remote(100_000)
    v1 = ray_tpu_torch.get(ref, timeout=T)
    client.remove_node(n3.node_id)
    # the head's cached copy must not answer the second get: drop it, so the
    # path is the lost namespace -> reconstruction
    from ray_tpu_torch.core.object_store import local_shm_name

    entry = client.store.try_get_entry(ref.id)
    if entry is not None and entry.shm is not None:
        try:
            os.unlink("/dev/shm/" + local_shm_name(entry.shm))
        except OSError:
            pass
        client.store.mark_lost(ref.id)
    v2 = ray_tpu_torch.get(ref, timeout=120)
    np.testing.assert_array_equal(v1, v2)


def test_killed_agents_namespace_is_unlinked_with_its_node(iso_cluster):
    """An agent killed with SIGKILL cannot unlink its namespace's segments;
    the head does when it removes the node."""
    import signal

    client, _, _ = iso_cluster
    n3 = client.add_node({"CPU": 2.0, "doomed": 1.0}, shm_isolation=True)
    ref = R(defs.arange).options(resources={"doomed": 1.0}, num_cpus=0).remote(500_000)
    ray_tpu_torch.wait([ref], timeout=T)
    ns = n3.shm_ns

    def mine():
        return [n for n in os.listdir("/dev/shm") if n.startswith(f"rt{ns}_")]

    assert mine(), "the task's result is not in its node's namespace"
    os.kill(n3.agent_proc.pid, signal.SIGKILL)
    deadline = time.time() + 30
    while time.time() < deadline and (n3.alive or mine() or n3.node_id in client.nodes):
        time.sleep(0.05)
    assert not n3.alive and not mine(), mine()
    del ref


def test_jax_distributed_trainer_across_isolated_nodes(iso_cluster):
    """ray_tpu's JaxTrainer case on the port: two workers on isolated nodes
    join a torch.distributed gloo group and all-gather, the control plane,
    the object plane and the collective's bootstrap all over the network
    transports."""
    from ray_tpu_torch.train import JaxTrainer, ScalingConfig
    from test_torch_trainer import fit

    trainer = JaxTrainer(defs.gloo_allgather, scaling_config=ScalingConfig(
        num_workers=2, resources_per_worker={"CPU": 1, "trainer": 1}))
    result = fit(trainer, timeout=150, raise_on_error=False)
    assert result.error is None, f"{result.error!r}; training_error={getattr(result.error, 'training_error', None)!r}"
    assert result.metrics["nproc"] == 2
    assert result.metrics["total"] == 3.0


def test_agent_join_over_tcp(cluster):
    """A standalone `rt agent` (the cross-host join) finds the head through
    cluster_info.json, connects through its TCP listener and serves tasks
    from a namespace of its own."""
    client, _, _ = cluster
    # code travels by reference: the joined host's workers import the remote
    # functions' module from the agent's own path
    import tempfile

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
           "TMPDIR": tempfile.gettempdir()}
    env.pop("RT_SHM_NS", None)
    proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.scripts.cli", "agent", "--num-cpus", "2"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        joined = None
        while joined is None:
            assert time.monotonic() < deadline, f"the agent never joined: {proc.stdout.read1(4096)}"
            time.sleep(0.2)
            joined = next((n for n in client.node_list() if n.labels.get("ray_tpu.io/node-type") == "joined"),
                          None)
        assert joined.shm_ns and joined.shm_ns != client._head_ns
        pid = ray_tpu_torch.get(R(defs.pid).options(scheduling_strategy=_pin(joined)).remote(), timeout=T)
        assert pid != os.getpid()
        v = ray_tpu_torch.get(R(defs.ones).options(scheduling_strategy=_pin(joined)).remote(200_000), timeout=T)
        assert v.sum() == 200_000
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    # the head sees the agent's death and removes its node
    deadline = time.monotonic() + 15
    while any(n.labels.get("ray_tpu.io/node-type") == "joined" for n in client.node_list()):
        assert time.monotonic() < deadline, "the joined node was never removed after its agent's death"
        time.sleep(0.2)


# --------------------------------------------------------------------------
# _recv_to_file's splice path: a mid-stream EAGAIN (the receive buffer
# momentarily empty) waits for readability and resumes; a truncation stays
# fatal
# --------------------------------------------------------------------------
def _fake_splice(script):
    """An os.splice stand-in driven by ``script``, per-call actions for the
    socket->pipe leg ('data' | 'eagain'); the pipe->file leg moves bytes
    for real. Reading the socket with os.read keeps its non-blocking
    behaviour: an empty socket raises BlockingIOError as splice does."""

    def splice(fd_in, fd_out, count, offset_dst=None):
        if offset_dst is not None:
            data = os.read(fd_in, count)
            os.pwrite(fd_out, data, offset_dst)
            return len(data)
        action = script.pop(0) if script else "data"
        if action == "eagain":
            raise BlockingIOError(11, "Resource temporarily unavailable")
        data = os.read(fd_in, min(count, 16384))
        if not data:
            return 0
        os.write(fd_out, data)
        return len(data)

    return splice


@pytest.mark.skipif(not hasattr(os, "splice"), reason="no os.splice on this platform")
def test_recv_to_file_resumes_after_midstream_eagain(tmp_path, monkeypatch):
    import socket as socket_mod

    payload = os.urandom(48 * 1024)
    a, b = socket_mod.socketpair()
    try:
        b.settimeout(10.0)  # O_NONBLOCK: the configuration that yields EAGAIN
        a.sendall(payload[: 16 * 1024])

        def _late_send():
            time.sleep(0.3)
            a.sendall(payload[16 * 1024:])

        t = threading.Thread(target=_late_send, daemon=True)
        t.start()
        # the second call's EAGAIN comes after bytes were consumed
        monkeypatch.setattr(os, "splice", _fake_splice(["data", "eagain"]))
        fd = os.open(str(tmp_path / "out.bin"), os.O_RDWR | os.O_CREAT, 0o600)
        try:
            got = transport._recv_to_file(b, fd, 0, len(payload))
        finally:
            os.close(fd)
        t.join(timeout=5)
        assert got == len(payload)
        assert (tmp_path / "out.bin").read_bytes() == payload
    finally:
        a.close()
        b.close()


@pytest.mark.skipif(not hasattr(os, "splice"), reason="no os.splice on this platform")
def test_recv_to_file_truncation_still_fatal(tmp_path, monkeypatch):
    """The EAGAIN tolerance does not soften a truncation: a peer closing
    mid-stream raises ConnectionError (object lost -> reconstruction)."""
    import socket as socket_mod

    payload = os.urandom(32 * 1024)
    a, b = socket_mod.socketpair()
    b.settimeout(10.0)
    a.sendall(payload[: 8 * 1024])
    a.close()  # the peer dies mid-stream
    monkeypatch.setattr(os, "splice", _fake_splice([]))
    fd = os.open(str(tmp_path / "out.bin"), os.O_RDWR | os.O_CREAT, 0o600)
    try:
        with pytest.raises(ConnectionError):
            transport._recv_to_file(b, fd, 0, len(payload))
    finally:
        os.close(fd)
        b.close()


def test_transfer_server_serves_only_its_namespaces(tmp_path):
    """An authenticated peer cannot read another namespace's segment (or a
    path) through a transfer server; a wrong key is refused."""
    import _posixshmem

    key = os.urandom(16)
    srv = transport.ObjectTransferServer(key, allowed_prefixes=("ptxferA_",))
    try:
        for name, data in (("ptxferA_ok", b"a" * 1000), ("ptxferB_no", b"b" * 10)):
            fd = _posixshmem.shm_open("/" + name, os.O_CREAT | os.O_RDWR, 0o600)
            os.write(fd, data)
            os.close(fd)
        assert transport.pull_segment(srv.address, key, "ptxferA_ok", "ptxferA_copy") == 1000
        with open("/dev/shm/ptxferA_copy", "rb") as f:
            assert f.read() == b"a" * 1000
        with pytest.raises(FileNotFoundError):
            transport.pull_segment(srv.address, key, "ptxferB_no", "ptxferA_copy2", retries=0)
        with pytest.raises(FileNotFoundError):
            transport.pull_segment(srv.address, b"wrong-key-000000", "ptxferA_ok", "ptxferA_copy3", retries=0)
    finally:
        srv.shutdown()
        transport._drop_pool()
        for n in ("ptxferA_ok", "ptxferB_no", "ptxferA_copy", "ptxferA_copy2", "ptxferA_copy3"):
            try:
                os.unlink("/dev/shm/" + n)
            except OSError:
                pass
