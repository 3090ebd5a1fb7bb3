"""Channel-compiled DAGs on the port's runtime (``ray_tpu_torch.dag``,
``experimental/channels.py``, ``experimental/compiled_dag.py``) on the CPU.

One twin for each of the 13 cases of ``tests/test_compiled_dag.py``, run
on the port with ray_tpu's inputs and assertions (the hop-latency gate
included: a hop under a quarter of the direct round trip). Then the
port's own rules: a tensor off the host in a channel raises TypeError
naming ``.cpu()`` and ``device_put_object``; the rings a killed actor
leaves are unlinked by the head's ``shutdown()``; a reader blocked on a
writer whose process dies ends in ``ChannelClosedError`` within its
timeout; a bounded recv on a live but silent writer ends in
``ChannelTimeoutError``; ``.bind()`` graphs run without channels too. Every
get carries a timeout. No jax here: the actors live in
``tests/torch_dag_defs.py``."""

import os
import subprocess
import sys
import time

import pytest
import torch
import torch_dag_defs as defs

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode, compile_dag
from ray_tpu_torch.experimental.channels import (
    ChannelClosedError,
    ChannelError,
    ChannelFullError,
    ChannelReader,
    ChannelTimeoutError,
)
from ray_tpu_torch.experimental.compiled_dag import compile_channel_dag

T = 30
Adder = ray_tpu_torch.remote(defs.Adder)


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6)
    yield
    ray_tpu_torch.shutdown()


def test_linear_chain(rt):
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    c = dag.experimental_compile(channels=True)
    try:
        for i in range(20):
            assert c.execute(i).get(timeout=T) == i + 11
    finally:
        c.teardown(kill_actors=True)


def test_diamond_fan_out_fan_in(rt):
    a, b, c, d = Adder.remote(1), Adder.remote(10), Adder.remote(100), Adder.remote()
    with InputNode() as inp:
        mid = a.add.bind(inp)
        dag = d.add2.bind(b.add.bind(mid), c.add.bind(mid))
    comp = compile_channel_dag(dag)
    try:
        assert comp.execute(5).get(timeout=T) == 16 + 106
        assert comp.execute(0).get(timeout=T) == 11 + 101
    finally:
        comp.teardown(kill_actors=True)


def test_multi_output_and_consts(rt):
    a, b = Adder.remote(1), Adder.remote()
    with InputNode() as inp:
        x = a.add.bind(inp)
        dag = MultiOutputNode([x, b.add2.bind(x, 1000)])
    comp = compile_channel_dag(dag)
    try:
        assert comp.execute(5).get(timeout=T) == [6, 1006]
    finally:
        comp.teardown(kill_actors=True)


def test_same_actor_two_steps(rt):
    a = Adder.remote(3)
    with InputNode() as inp:
        dag = a.add.bind(a.add.bind(inp))  # self-edge: local queue, no socket
    comp = compile_channel_dag(dag)
    try:
        assert comp.execute(4).get(timeout=T) == 10
        assert comp.execute(0).get(timeout=T) == 6
    finally:
        comp.teardown(kill_actors=True)


def test_cyclic_actor_reuse(rt):
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = a.add.bind(b.add.bind(a.add.bind(inp)))
    comp = compile_channel_dag(dag)
    try:
        for i in range(10):
            assert comp.execute(i).get(timeout=T) == i + 12
    finally:
        comp.teardown(kill_actors=True)


def test_error_propagates_to_driver(rt):
    a, b = Adder.remote(1), Adder.remote(2)
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    comp = compile_channel_dag(dag)
    try:
        with pytest.raises(ValueError, match="boom on 7"):
            comp.execute(7).get(timeout=T)
        with pytest.raises(ValueError, match="boom on 8"):  # an application error does not break the DAG
            comp.execute(8).get(timeout=T)
    finally:
        comp.teardown(kill_actors=True)


def test_in_flight_cap(rt):
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    comp = compile_channel_dag(dag, nslots=4)
    try:
        refs = [comp.execute(i) for i in range(4)]
        with pytest.raises(ChannelError, match="in flight"):
            comp.execute(99)
        assert [r.get(timeout=T) for r in refs] == [1, 2, 3, 4]
        assert comp.execute(50).get(timeout=T) == 51  # cap freed by gets
    finally:
        comp.teardown(kill_actors=True)


def test_slot_overflow_raises(rt):
    a = Adder.remote()
    with InputNode() as inp:
        dag = a.big.bind(inp)
    comp = compile_channel_dag(dag, buffer_size_bytes=64 << 10)
    try:
        with pytest.raises(ChannelFullError, match="buffer_size_bytes"):
            comp.execute(b"x" * (256 << 10))
    finally:
        comp.teardown(kill_actors=True)


def test_execute_after_teardown_raises(rt):
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    comp = compile_channel_dag(dag)
    assert comp.execute(1).get(timeout=T) == 2
    comp.teardown(kill_actors=True)
    with pytest.raises(ChannelError, match="torn down"):
        comp.execute(2)


def test_actor_death_breaks_dag(rt):
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    comp = compile_channel_dag(dag)
    assert comp.execute(0).get(timeout=T) == 11
    ray_tpu_torch.kill(a)
    with pytest.raises(ChannelError):
        for i in range(50):  # the dead stage surfaces as a closed channel on execute or get
            comp.execute(i).get(timeout=10)
            time.sleep(0.05)
    comp.teardown(kill_actors=True)  # teardown after failure is safe


def test_no_input_edge_rejected(rt):
    a = Adder.remote(1)
    dag = a.add.bind(42)  # constant-clocked node: would free-run
    with pytest.raises(ValueError, match="in-edge"):
        compile_channel_dag(dag)


def test_plain_function_rejected(rt):
    f = ray_tpu_torch.remote(defs.ident)
    with InputNode() as inp:
        dag = f.bind(inp)
    with pytest.raises(ValueError, match="actor-method"):
        compile_channel_dag(dag)


def test_hop_latency_beats_task_roundtrip(rt):
    """The compiled hop is under a quarter of the direct task round trip
    (ray_tpu's gate)."""
    nop = ray_tpu_torch.remote(defs.nop)
    ray_tpu_torch.get([nop.remote() for _ in range(10)], timeout=T)
    t0 = time.perf_counter()
    for _ in range(30):
        ray_tpu_torch.get(nop.remote(), timeout=T)
    task_rt = (time.perf_counter() - t0) / 30

    a, b, c = Adder.remote(1), Adder.remote(1), Adder.remote(1)
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    comp = compile_channel_dag(dag)
    try:
        comp.execute(0).get(timeout=T)  # warm
        n = 300
        t0 = time.perf_counter()
        for i in range(n):
            comp.execute(i).get(timeout=T)
        per_hop = (time.perf_counter() - t0) / n / 4  # driver->a->b->c->driver
        assert per_hop < task_rt / 4, f"hop {per_hop*1e6:.0f}us vs task rt {task_rt*1e6:.0f}us"
    finally:
        comp.teardown(kill_actors=True)


# ------------------------------------------------------------- the port's rules
def test_bind_without_channels(rt):
    """``.bind()`` on a remote function, an actor class and an actor
    method; ``compile_dag`` creates the class node's actor once."""
    f = ray_tpu_torch.remote(defs.ident)
    a = Adder.remote(2)
    cls_node = Adder.bind(100)
    with InputNode() as inp:
        dag = MultiOutputNode([a.add.bind(f.bind(inp)), cls_node.add.bind(inp)])
    comp = compile_dag(dag)
    try:
        pids = set()
        for i in range(3):
            r1, r2 = comp.execute(i)
            assert ray_tpu_torch.get([r1, r2], timeout=T) == [i + 2, i + 100]
        pids = {ray_tpu_torch.get(cls_node._handle.pid.remote(0), timeout=T) for _ in range(2)}
        assert len(pids) == 1
        assert ray_tpu_torch.get(a.add.bind(5).execute(), timeout=T) == 7
    finally:
        comp.teardown()
        ray_tpu_torch.kill(a)


def test_tensor_off_the_host_raises_naming_cpu_and_device_put(rt):
    """A channel carries host bytes: a tensor off the host (a meta tensor
    here; a card tensor on the H100) raises TypeError before anything is
    sent, and the DAG goes on. A host tensor crosses with its dtype."""
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    comp = compile_channel_dag(dag)
    try:
        with pytest.raises(TypeError, match=r"\.cpu\(\).*device_put_object"):
            comp.execute(torch.empty(4, device="meta"))
        out = comp.execute(torch.arange(4, dtype=torch.bfloat16)).get(timeout=T)
        assert out.dtype == torch.bfloat16 and out.tolist() == [1.0, 2.0, 3.0, 4.0]
    finally:
        comp.teardown(kill_actors=True)


@pytest.mark.cuda
def test_card_tensor_raises(rt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    comp = compile_channel_dag(dag)
    try:
        with pytest.raises(TypeError, match=r"cuda.*\.cpu\(\).*device_put_object"):
            comp.execute(torch.ones(2, device="cuda"))
    finally:
        comp.teardown(kill_actors=True)


def _rings(dag):
    return sorted(n for n in os.listdir("/dev/shm") if f"_ch{dag._dag_id}_" in n)


def test_teardown_leaves_no_ring(rt):
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    comp = compile_channel_dag(dag)
    assert len(_rings(comp)) == 3
    assert all(n.startswith(f"rt{os.getpid()}w_") for n in _rings(comp))  # the workers' tag of this head
    assert comp.execute(1).get(timeout=T) == 12
    comp.teardown(kill_actors=True)
    assert _rings(comp) == []


def test_killed_actor_ring_unlinked_at_shutdown(rt):
    """A killed stage never closes its reader, so its input ring stays
    mapped by nobody; the head's shutdown() unlinks it (the ring is named
    under the workers' tag)."""
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    comp = compile_channel_dag(dag)
    assert comp.execute(0).get(timeout=T) == 11
    ray_tpu_torch.kill(a)
    ray_tpu_torch.kill(b)
    deadline = time.monotonic() + T
    while ray_tpu_torch.available_resources().get("CPU", 0) < 6 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _rings(comp), "the killed stages left their rings"
    ray_tpu_torch.shutdown()
    try:
        assert _rings(comp) == []
    finally:
        ray_tpu_torch.init(num_cpus=6)


_WRITER = """
import sys, time
from ray_tpu_torch.experimental.channels import ChannelWriter
w = ChannelWriter(sys.argv[1], 4, 4096)
print("connected", flush=True)
time.sleep(120)
"""


def _reader_with_writer_process(name):
    r = ChannelReader(name, 4, 4096, eager=False)
    proc = subprocess.Popen([sys.executable, "-c", _WRITER, name], stdout=subprocess.PIPE, text=True)
    try:
        r.finish(timeout=60)
        assert proc.stdout.readline().strip() == "connected"
    except BaseException:
        proc.kill()
        proc.wait(timeout=T)
        r.close()
        raise
    return r, proc


def test_blocked_reader_ends_when_writer_process_dies():
    name = f"rt{os.getpid()}w_chtest_{os.urandom(4).hex()}"
    r, proc = _reader_with_writer_process(name)
    try:
        with pytest.raises(ChannelTimeoutError):  # a live, silent writer: the bound ends the wait
            r.recv(timeout=0.3)
        proc.kill()
        t0 = time.monotonic()
        with pytest.raises(ChannelClosedError):
            r.recv(timeout=10)
        assert time.monotonic() - t0 < 10
    finally:
        proc.kill()
        proc.wait(timeout=T)
        r.close()
    assert not os.path.exists("/dev/shm/" + name)


def test_unbounded_recv_ends_on_close():
    """A recv with no timeout ends with ChannelClosedError once another
    thread closes the endpoint (the loop thread's teardown)."""
    import threading

    name = f"rt{os.getpid()}w_chtest_{os.urandom(4).hex()}"
    r, proc = _reader_with_writer_process(name)
    err = []

    def wait():
        try:
            r.recv()
        except ChannelError as e:
            err.append(e)

    t = threading.Thread(target=wait, daemon=True)
    try:
        t.start()
        time.sleep(0.2)
        r.close()
        t.join(timeout=5)
        assert not t.is_alive() and isinstance(err[0], ChannelClosedError)
    finally:
        proc.kill()
        proc.wait(timeout=T)
        r.close()


def test_reader_modes_lists_live_readers():
    """reader_modes() lists each live reader of this process with how it
    waits now, its measuring phase and its messages received; a closed and
    collected reader drops out."""
    import gc

    from ray_tpu_torch.experimental import channels

    r = ChannelReader(f"rt{os.getpid()}w_chtest_{os.urandom(4).hex()}", 4, 4096, eager=False)
    name = r.name
    try:
        modes = {m["name"]: m for m in channels.reader_modes()}
        assert modes[name] == {"name": name, "mode": "block", "phase": 0, "received": 0}
        r._phase, r._spin = 1, True
        assert {m["name"]: m for m in channels.reader_modes()}[name]["mode"] == "poll"
    finally:
        r.close()
    del r
    gc.collect()
    assert name not in {m["name"] for m in channels.reader_modes()}
