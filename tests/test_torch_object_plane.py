"""The owned-object plane in the port (``ray_tpu_torch/core/``) against
ray_tpu's (``ray_tpu/core/``), on the CPU.

- ``ObjectID``'s byte layout, ``is_put`` and ``for_task_return`` equal
  ray_tpu's on the same bytes; the flags of ``_config.py`` keep ray_tpu's
  defaults and ``RT_*`` overrides; the runtime errors keep its names,
  bases and serving codes.
- ``serialize``/``deserialize`` of dicts of bf16, f32, int8 and int32 host
  tensors: every tensor out of band (its bytes not in the header), equal
  after the round trip; a tensor off the host is refused; a fresh process
  that round-trips a payload through ``core.direct`` has no cloudpickle
  (and no jax) in ``sys.modules``.
- ``encode_serialized``'s inline/shm split at
  ``max_direct_call_object_size``, as ray_tpu's on the same sizes.
- ``OwnedStore``: test_direct.py's four grace/backstop scenarios as one
  parametrised test over both packages' stores, the same call sequence,
  the same entries alive after each ``gc_pass``.
- Owner-local ``put_owned``/``get_owned_view``/``free_owned``: the fetched
  tensor's storage lies in a private mapping of the segment, a write into
  it leaves the owner's bytes unchanged, a free unlinks the segment.
- Across processes, in ``spawn`` children joined with a bound: a borrow
  (equal bytes, the borrow registered, the owner frees after the
  release), the owner's death (ObjectLostError), the leak backstop.
- The chaos sites ``direct.put_owned`` and ``direct.get_owned_view``; an id
  this process neither owns nor has a hint for goes to the head: with no
  runtime that raises RuntimeError naming ``init()``, with one the head
  answers.

Every test that attaches a plane detaches it in a ``finally``, which frees
its objects and unlinks their segments; no ``/dev/shm/rt*`` is left.
This file imports no jax: a spawn child re-imports it quickly."""

import multiprocessing as mp
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu import _config as jconfig
from ray_tpu import exceptions as jexc
from ray_tpu.core import direct as jdirect
from ray_tpu.core import ids as jids
from ray_tpu.core import payloads as jpayloads
from ray_tpu.core import serialization as jser
from ray_tpu_torch import _config as tconfig
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch.core import direct, ids, payloads
from ray_tpu_torch.core.object_ref import local_ref_count
from ray_tpu_torch.core.serialization import deserialize, serialize

REPO = pathlib.Path(__file__).resolve().parents[1]
SHM = pathlib.Path("/dev/shm")
JOIN_S = 120  # every spawn child is joined within this, then killed


def _segments(pid=None) -> set:
    """This process's (or ``pid``'s) rt segments in /dev/shm."""
    return {n for n in os.listdir(SHM) if n.startswith(f"rt{pid or os.getpid()}_")}


@pytest.fixture(autouse=True)
def _clean():
    """A cleared, seeded port chaos plane and fresh config per test; no
    plane left attached and no segment of this process left behind (one
    that existed before the test, such as a ray_tpu session's in this
    worker, is not the test's)."""
    tchaos.clear()
    tchaos.seed(0)
    tconfig.reset_config()
    before = _segments()
    yield
    tchaos.clear()
    direct.detach()
    tconfig.reset_config()
    assert _segments() <= before


@pytest.fixture
def plane(monkeypatch):
    """An attached plane with short windows (grace 0.05 s, backstop 1 s)."""
    monkeypatch.setenv("RT_OWNED_OBJECT_GRACE_S", "0.05")
    monkeypatch.setenv("RT_OWNED_OBJECT_LEAK_BACKSTOP_S", "1.0")
    monkeypatch.setenv("RT_REF_COUNTING_INTERVAL_S", "0.02")
    tconfig.reset_config()
    st = direct.attach(b"object-plane-test-key")
    try:
        yield st
    finally:
        direct.detach()


def _wait(cond, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _join(p):
    p.join(JOIN_S)
    if p.is_alive():
        p.kill()
        p.join(10)
        raise AssertionError(f"child {p.pid} did not finish within {JOIN_S} s")
    return p.exitcode


def _recv(conn, timeout=60.0):
    if not conn.poll(timeout):
        raise AssertionError(f"no message from the child within {timeout} s")
    return conn.recv()


# ----------------------------------------------------------------- ids, config, errors
def test_object_id_layout_matches_ray_tpu():
    for _ in range(4):
        t = ids.ObjectID.from_put()
        j = jids.ObjectID(t.binary())
        assert t.SIZE == j.SIZE == 20 and t.binary()[16:] == b"\xff" * 4
        assert t.is_put() and j.is_put() and t.hex() == j.hex() and t.return_index() == j.return_index()
        assert t.task_id().binary() == j.task_id().binary()
    task = os.urandom(16)
    for index in (0, 1, 7, 2**31):
        t = ids.ObjectID.for_task_return(ids.TaskID(task), index)
        j = jids.ObjectID.for_task_return(jids.TaskID(task), index)
        assert t.binary() == j.binary() and not t.is_put() and t.return_index() == index
    assert ids.ObjectID.from_put() != ids.ObjectID.from_put()
    assert pickle.loads(pickle.dumps(t)) == t and hash(pickle.loads(pickle.dumps(t))) == hash(t)
    with pytest.raises(ValueError):
        ids.ObjectID(b"short")


def test_config_defaults_and_env_overrides_match_ray_tpu(monkeypatch):
    """Every flag keeps ray_tpu's name, default and RT_* override."""
    names = [f.name for f in tconfig.Config.__dataclass_fields__.values() if f.name != "extra"]
    jnames = set(jconfig.Config.__dataclass_fields__)
    assert {"max_direct_call_object_size", "object_ref_counting", "ref_counting_interval_s", "direct_calls",
            "owned_object_grace_s", "owned_object_leak_backstop_s", "scheduler_spread_threshold",
            "worker_start_method", "prestart_workers", "default_max_retries"} <= set(names)
    assert set(names) <= jnames
    for env in ({}, {"RT_MAX_DIRECT_CALL_OBJECT_SIZE": "4096", "RT_OWNED_OBJECT_GRACE_S": "2.5",
                     "RT_DIRECT_CALLS": "0", "RT_OBJECT_REF_COUNTING": "off", "RT_DEFAULT_MAX_RETRIES": "7",
                     "RT_WORKER_START_METHOD": "spawn"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        tconfig.reset_config()
        jconfig.reset_config()
        try:
            t, j = tconfig.get_config(), jconfig.get_config()
            assert {n: getattr(t, n) for n in names} == {n: getattr(j, n) for n in names}
        finally:
            jconfig.reset_config()
    assert tconfig.get_config().max_direct_call_object_size == 4096


def test_runtime_errors_match_ray_tpu():
    for name in ("RayTpuError", "TaskError", "WorkerCrashedError", "ActorDiedError", "ActorUnavailableError",
                 "ObjectLostError", "ObjectReconstructionError", "GetTimeoutError", "NodeDiedError",
                 "RuntimeEnvSetupError", "PlacementGroupUnschedulableError", "PendingCallsLimitExceeded",
                 "OutOfMemoryError"):
        t, j = getattr(texc, name), getattr(jexc, name)
        assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__], name
        ts, js = texc.serving_error_spec(t), jexc.serving_error_spec(j)
        assert (ts is None) == (js is None) and (ts is None or (ts.status_code, ts.retryable) == (js.status_code,
                                                                                               js.retryable)), name
    cause = ValueError("boom")
    err = pickle.loads(pickle.dumps(texc.TaskError.from_exception(cause, "f")))
    assert isinstance(err.cause, ValueError) and "boom" in err.tb_str and err.task_desc == "f"
    assert isinstance(texc.GetTimeoutError("t"), TimeoutError)


# ----------------------------------------------------------------- serialization
def _tensors(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((3, 700, 2, 16)).astype(np.float32))  # 268 KB: above the threshold
    return {
        "bf16": f32.bfloat16(),
        "f32": f32,
        "int8": torch.from_numpy(rng.integers(-127, 128, size=(4, 33), dtype=np.int8)),
        "int32": torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(5, 7), dtype=np.int32)),
        "strided": f32[:, ::3],
        "empty": torch.zeros((0, 4)),
        "meta": {"n": 7, "tokens": [1, 2, 3], "name": "block"},
    }


def test_serialize_carries_host_tensors_out_of_band():
    value = _tensors(0)
    s = serialize(value)
    tensors = [v for v in value.values() if isinstance(v, torch.Tensor)]
    assert [memoryview(b).nbytes for b in s.buffers] == [t.numel() * t.element_size() for t in tensors]
    # the header holds names, dtypes and shapes only: no tensor bytes
    assert len(s.header) < 1024 and s.total_size() == len(s.header) + sum(t.nbytes for t in tensors)
    assert s.contained_refs == []
    for bufs in (s.buffers, [bytes(b) for b in s.buffers]):  # views, then read-only copies
        out = deserialize(s.header, bufs)
        for name, t in value.items():
            if isinstance(t, torch.Tensor):
                assert out[name].dtype == t.dtype and torch.equal(out[name], t), name
            else:
                assert out[name] == t
    # over read-only bytes (an inline payload's) the tensors are copies, writable
    copies = [bytes(b) for b in s.buffers]
    out = deserialize(s.header, copies)
    out["f32"].add_(1.0)
    assert torch.equal(deserialize(s.header, copies)["f32"], value["f32"])
    with pytest.raises(TypeError, match=r"\.cpu\(\)"):
        serialize({"k": torch.empty(4, device="meta")})


def test_a_fresh_process_round_trips_without_cloudpickle():
    code = (
        "import sys, torch\n"
        "from ray_tpu_torch.core import direct, payloads\n"
        "x = {'k': torch.arange(80000, dtype=torch.float32).bfloat16(), 'n': 3}\n"
        "from ray_tpu_torch.core.object_store import unlink_shm\n"
        "p = payloads.encode_value(x)\n"
        "try:\n"
        "    v, seg = payloads.decode_payload(p)\n"
        "    ok = p.shm is not None and torch.equal(v['k'], x['k']) and v['n'] == 3\n"
        "finally:\n"
        "    unlink_shm(p.shm.shm_name)\n"
        "print(ok, 'cloudpickle' in sys.modules, 'jax' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=JOIN_S)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "False"]


@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_encode_serialized_splits_at_the_threshold_like_ray_tpu(extra):
    """A value whose serialized size is exactly at the threshold stays
    inline, one byte over goes to shared memory, in both packages."""
    threshold = tconfig.get_config().max_direct_call_object_size
    assert threshold == jconfig.get_config().max_direct_call_object_size == 100 * 1024
    half = threshold - 4096  # the header's shape field as wide as the final one's (both > 65535)
    base = serialize({"k": torch.zeros(half, dtype=torch.uint8)}).total_size() - half
    n = threshold - base + extra
    t = torch.arange(n, dtype=torch.int32).to(torch.uint8)
    s = serialize({"k": t})
    assert s.total_size() == threshold + extra
    p = payloads.encode_serialized(s)
    js = jser.Serialized(header=b"x" * (threshold + extra))
    jp = jpayloads.encode_serialized(js)
    try:
        assert (p.shm is not None) == (jp.shm is not None) == (extra > 0)
        v, _ = payloads.decode_payload(p)
        assert torch.equal(v["k"], t)
        if p.shm is not None:
            assert p.shm.total_size == threshold + extra and p.shm.ns == ""
    finally:
        for pay in (p, jp):
            if pay.shm is not None:
                os.unlink(SHM / pay.shm.shm_name)


# ----------------------------------------------------------------- OwnedStore against ray_tpu's
def _scenario(mod, name: str) -> list:
    """test_direct.py:543's scenarios on ``mod``'s OwnedStore (grace 0.05
    s, backstop 0.5 s): after each gc_pass, whether the entry is alive."""
    store = mod.OwnedStore(grace_s=0.05, backstop_s=0.5)
    pay = mod.Payload(shm=None, inline=b"x")
    k = name[0].encode() * 20
    alive = []

    def gc(age=None):
        if age is not None:
            store._objects[k].zero_since = time.monotonic() - age
        store.gc_pass()
        alive.append(store.entry(k) is not None)

    store.put_ready(k, pay)
    if name == "never serialized":
        gc(0.1)
    elif name == "serialized out":
        store.mark_serialized(k)
        gc(0.1)  # a borrower may still be registering: the grace does not free it
        gc(1.0)  # the leak backstop does
    elif name == "borrowed then released":
        store.mark_serialized(k)
        store.on_borrow(k, True)
        gc()
        store.on_borrow(k, False)  # the explicit release starts the clock
        alive.append(store._objects[k].zero_since is not None)
        gc(0.1)
    else:  # serialized again after a completed borrow cycle
        store.mark_serialized(k)
        store.on_borrow(k, True)
        store.on_borrow(k, False)
        store.mark_serialized(k)
        gc(0.1)
        gc(1.0)
    return alive


@pytest.mark.parametrize("name", ["never serialized", "serialized out", "borrowed then released",
                                  "serialized again"])
def test_owned_store_gc_matches_ray_tpu(name):
    import types

    tmod = types.SimpleNamespace(OwnedStore=direct.OwnedStore, Payload=payloads.Payload)
    jmod = types.SimpleNamespace(OwnedStore=jdirect.OwnedStore, Payload=jpayloads.Payload)
    want = {"never serialized": [False], "serialized out": [True, False],
            "borrowed then released": [True, True, False], "serialized again": [True, False]}[name]
    assert _scenario(tmod, name) == _scenario(jmod, name) == want


# ----------------------------------------------------------------- owner-local
def _mapping_of(ptr: int) -> str:
    with open("/proc/self/maps") as f:
        for line in f:
            lo, hi = (int(x, 16) for x in line.split()[0].split("-"))
            if lo <= ptr < hi:
                return line.strip()
    return ""


def test_put_get_free_owner_local(plane):
    value = _tensors(1)
    ref = direct.put_owned(value)
    e = plane.owned.entry(ref.id.binary())
    seg = e.payload.shm.shm_name
    assert ref.id.is_put() and plane.owned.size() == 1 and seg in _segments()
    assert direct.owned_ready(ref.id.binary()) is True and direct.owned_ready(ids.ObjectID.from_put().binary()) is None
    got = direct.get_owned_view(ref.id)
    for name, t in value.items():
        if isinstance(t, torch.Tensor) and t.numel():
            assert torch.equal(got[name], t)
            # the storage lies in a private, writable mapping of the segment
            line = _mapping_of(got[name].data_ptr())
            assert line.endswith(str(SHM / seg)) and " rw-p " in line, line
    before = (SHM / seg).read_bytes()
    got["f32"].mul_(0.0)  # copy-on-write: only this process's pages change
    assert (SHM / seg).read_bytes() == before
    again = direct.get_owned_view(ref.id)
    assert torch.equal(again["f32"], value["f32"]) and not torch.equal(got["f32"], value["f32"])
    assert direct.free_owned([ref.id]) == [] and plane.owned.size() == 0 and seg not in _segments()
    # the views stay valid past the unlink (POSIX shm semantics)
    assert torch.equal(again["bf16"], value["bf16"])
    with pytest.raises(texc.ObjectLostError):
        direct.get_owned_view(ref.id)
    small = direct.put_owned({"n": 1})  # under the threshold: inline, no segment
    assert plane.owned.entry(small.id.binary()).payload.shm is None and direct.get_owned_view(small.id) == {"n": 1}


def test_owner_frees_after_the_last_local_ref(plane):
    ref = direct.put_owned({"k": torch.ones(50000)})
    seg = plane.owned.entry(ref.id.binary()).payload.shm.shm_name
    assert local_ref_count(ref.id) == 1
    del ref
    assert _wait(lambda: plane.owned.size() == 0) and seg not in _segments()


def test_a_release_inside_the_count_lock_does_not_deadlock():
    """A ref that dies while its own thread holds the count lock (a garbage
    collection pass triggered by an allocation inside ``_incref``) queues
    its release instead of blocking on the lock; the next reader applies
    it. ray_tpu's ``_decref`` takes the lock there and hangs the process."""
    import threading

    from ray_tpu_torch.core import object_ref as oref

    oid = ids.ObjectID.from_put()
    box = [oref.ObjectRef(oid)]

    def release_under_the_lock():
        with oref._rc_lock:
            box.clear()  # the ref's __del__ runs here, on the lock's holder

    t = threading.Thread(target=release_under_the_lock, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), "a release under the count lock deadlocked"
    assert local_ref_count(oid) == 0
    assert (oid.binary(), False) in oref.drain_ref_events()


# ----------------------------------------------------------------- across processes
def _borrower(conn, authkey):
    """Spawn child: attach, borrow each ref sent, report, release."""
    from ray_tpu_torch.core import direct as d

    d.attach(authkey)
    try:
        while True:
            ref = conn.recv()
            if ref is None:
                break
            v = d.get_owned_view(ref.id, timeout=30)
            # readiness of a borrowed id is the owner's answer to a poll
            ready = d.owned_ready(ref.id.binary(), poll_timeout=10)
            conn.send(("got", {k: t.clone() for k, t in v.items() if isinstance(t, torch.Tensor)}, ready))
            if conn.recv() == "release":
                del v, ref
                d.state().pump()  # the release reaches the owner now
                conn.send(("released", None))
    finally:
        d.detach()


def _owner(conn, authkey, mode):
    """Spawn child: own one object, send its ref, then die or wait."""
    from ray_tpu_torch.core import direct as d

    st = d.attach(authkey)
    ref = d.put_owned({"k": torch.arange(60000, dtype=torch.int32)})
    conn.send((ref, st.owned.entry(ref.id.binary()).payload.shm.shm_name))
    conn.recv()  # the parent has it
    if mode == "die":
        os._exit(0)  # no detach: the segment is an orphan for the next attach
    d.detach()


def test_borrow_across_processes(plane):
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_borrower, args=(child, b"object-plane-test-key"), daemon=True)
    p.start()
    try:
        value = {"bf16": _tensors(2)["bf16"], "int8": _tensors(2)["int8"]}
        ref = direct.put_owned(value)
        k = ref.id.binary()
        parent.send(ref)  # pickled out: the owner now waits for the borrow-release
        kind, got, ready = _recv(parent)
        assert kind == "got" and ready is True and all(torch.equal(got[n], value[n]) for n in value)
        assert _wait(lambda: plane.owned.entry(k).borrows == 1), "the borrow never registered"
        del ref  # the owner's last local ref: the borrow alone keeps the object
        time.sleep(0.2)
        assert plane.owned.size() == 1
        parent.send("release")
        assert _recv(parent)[0] == "released"
        assert _wait(lambda: plane.owned.size() == 0), "the owner never freed after the release"
        assert _segments() == set()
        parent.send(None)
        assert _join(p) == 0
    finally:
        if p.is_alive():
            p.kill()


def test_owner_death_is_object_lost_and_orphans_are_reclaimed(plane):
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_owner, args=(child, b"object-plane-test-key", "die"), daemon=True)
    p.start()
    try:
        ref, seg = _recv(parent)
        assert seg.startswith(f"rt{p.pid}_") and (SHM / seg).exists()
        assert torch.equal(direct.get_owned_view(ref.id, timeout=30)["k"], torch.arange(60000, dtype=torch.int32))
        parent.send("ok")
        assert _join(p) == 0  # died without detaching: its segment is an orphan
        with pytest.raises(texc.ObjectLostError, match="is gone"):
            direct.get_owned_view(ref.id, timeout=5)
        # an attach reclaims a dead pid's segments (this one, or another
        # process's attach on this host got there first)
        direct.attach(b"object-plane-test-key")
        assert not (SHM / seg).exists()
    finally:
        if p.is_alive():
            p.kill()


def test_leak_backstop_reclaims_an_unregistered_copy(plane):
    ref = direct.put_owned({"k": torch.ones(40000)})
    k = ref.id.binary()
    blob = pickle.dumps(ref)  # serialized out; nobody ever registers the borrow
    del ref
    time.sleep(0.3)  # well past the 0.05 s grace: the backstop holds it
    assert plane.owned.size() == 1 and plane.owned.entry(k).pending_serialized == 1
    assert _wait(lambda: plane.owned.size() == 0, timeout=5.0), "the 1 s leak backstop never freed it"
    assert len(blob) > 0


# ----------------------------------------------------------------- chaos, refusals
def test_chaos_sites_put_owned_and_get_owned_view(plane):
    tchaos.inject("direct.put_owned", drop_prob=1.0, max_hits=1)
    with pytest.raises(RuntimeError, match="chaos: put_owned dropped"):
        direct.put_owned({"n": 1})
    ref = direct.put_owned({"k": torch.ones(30000)})
    tchaos.inject("direct.get_owned_view", drop_prob=1.0, max_hits=2)
    for _ in range(2):
        with pytest.raises(texc.ObjectLostError, match="chaos"):
            direct.get_owned_view(ref.id)
    assert torch.equal(direct.get_owned_view(ref.id)["k"], torch.ones(30000))
    assert plane.owned.size() == 1  # a dropped get loses nothing at the owner


def test_head_paths_raise_naming_the_runtime(plane, monkeypatch):
    """With no runtime in the process, each path to the head raises
    RuntimeError saying that ``ray_tpu_torch.init()`` was not called; with
    a runtime up, the head answers those same calls."""
    stranger = ids.ObjectID.from_put()
    with pytest.raises(RuntimeError, match=r"call ray_tpu_torch.init\(\) first"):
        direct.get_owned_view(stranger)
    ref, _ = direct.try_put({"n": 5})
    with pytest.raises(RuntimeError, match=r"call ray_tpu_torch.init\(\) first"):
        direct.promote(None, ref.id.binary())
    with pytest.raises(RuntimeError, match=r"call ray_tpu_torch.init\(\) first"):
        direct.try_put({"k": torch.ones(50000)})
    assert direct.get_owned_view(ref.id) == {"n": 5}
    # a ``call`` frame is answered with ray_tpu's TaskError: this process executes no calls
    import socket
    import threading

    with socket.create_connection(plane.server.address, timeout=10) as sock:
        rf = direct._auth_client(sock, b"object-plane-test-key")
        direct._send_frame(sock, direct._dumps({"op": "call", "cid": 7, "method": "f"}), threading.Lock())
        reply = direct._recv_frame(rf)
    assert reply["op"] == "result" and reply["cid"] == 7 and isinstance(reply["error"], texc.TaskError)
    with pytest.raises(ValueError):
        direct.attach(b"")
    monkeypatch.setenv("RT_DIRECT_CALLS", "0")
    tconfig.reset_config()
    with pytest.raises(RuntimeError, match="switched off"):
        direct.attach(b"k")
    direct.detach()
    with pytest.raises(RuntimeError, match="direct plane"):
        direct.put_owned({"n": 1})
    # an unhinted id with no plane attached at all: the head's, as well
    with pytest.raises(RuntimeError, match=r"call ray_tpu_torch.init\(\) first"):
        direct.get_owned_view(stranger)
    # the same calls with a runtime up (no workers: these need none)
    monkeypatch.delenv("RT_DIRECT_CALLS")
    import ray_tpu_torch as rtt

    rt = rtt.init(num_cpus=1, _system_config={"prestart_workers": False})
    try:
        with pytest.raises(texc.GetTimeoutError):  # nothing sealed under that id at the head
            direct.get_owned_view(stranger, timeout=0.3)
        ref, _ = direct.try_put({"n": 6})
        assert direct.promote(rt, ref.id.binary()) and rt.store.contains(ref.id)
        assert direct.get_owned_view(ref.id) == {"n": 6}  # now the head's copy
        none, s = direct.try_put({"k": torch.ones(50000)})
        assert none is None and s.total_size() > tconfig.get_config().max_direct_call_object_size
        big = rtt.put({"k": torch.ones(50000)})
        assert rt.store.contains(big.id) and torch.equal(direct.get_owned_view(big.id)["k"], torch.ones(50000))
        gone = big.id
        del big  # the last reference: the head's ref GC frees it
        assert _wait(lambda: gone in rt._freed_set)
        with pytest.raises(texc.ObjectLostError, match="freed"):
            direct.get_owned_view(gone, timeout=5)
    finally:
        rtt.shutdown()