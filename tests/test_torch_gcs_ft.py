"""The persistent GCS in the port (``core/table_store.py``'s
``FileTableStore``, ``gcs_persist_path``, detached actors across heads):
the cases of ``tests/test_gcs_ft.py`` on ray_tpu_torch, and the log held
byte for byte against ray_tpu's.

- ``FileTableStore``'s replay, torn tail and compaction, on both packages.
- A log written by either package replays in the other's to the same
  tables, with a torn tail and after compactions; both write the same
  bytes for the same operations.
- A head killed with SIGKILL: the next head on its log has the KV key, the
  job (the ``_jobs`` mirror) and the detached named actor, re-created from
  a class of the first head's script (code by reference names the script).
- A standalone ``rt agent`` redials a restarted head on a fixed port.

Drivers are script files (a worker imports its driver's script); every
wait has its own bound."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu.core.table_store as jts
import ray_tpu_torch.core.table_store as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = {"ray_tpu": jts.FileTableStore, "ray_tpu_torch": tts.FileTableStore}


# ----------------------------------------------------------------------
# FileTableStore, on both packages
# ----------------------------------------------------------------------
@pytest.fixture(params=sorted(STORES))
def fts(request):
    return STORES[request.param]


def test_file_table_store_roundtrip_and_replay(tmp_path, fts):
    path = str(tmp_path / "gcs.log")
    s = fts(path)
    s.put("t", "a", b"1")
    s.put("t", "b", b"2")
    s.put("t", "a", b"3")  # overwrite
    s.delete("t", "b")
    s.close()
    s2 = fts(path)
    assert s2.all("t") == {"a": b"3"}
    s2.close()
    assert os.stat(path).st_mode & 0o777 == 0o600


def test_file_table_store_ignores_torn_tail(tmp_path, fts):
    path = str(tmp_path / "gcs.log")
    s = fts(path)
    s.put("t", "a", b"ok")
    s.close()
    with open(path, "ab") as f:
        f.write(b'{"op":"put","t":"t","k":"b","v":"troncat')  # a crash mid-append
    s2 = fts(path)
    assert s2.all("t") == {"a": b"ok"}
    s2.put("t", "c", b"after")  # the log takes appends after the torn record
    s2.close()
    s3 = fts(path)
    assert s3.all("t") == {"a": b"ok", "c": b"after"}
    s3.close()


def test_file_table_store_compaction(tmp_path, fts):
    path = str(tmp_path / "gcs.log")
    s = fts(path)
    s.COMPACT_EVERY = 50
    for i in range(120):
        s.put("t", "hot", str(i).encode())
    # 120 appends of one key compacted down to about one live record
    assert os.path.getsize(path) < 120 * 30
    assert s.all("t") == {"hot": b"119"}
    s.close()
    s2 = fts(path)
    assert s2.all("t") == {"hot": b"119"}
    s2.close()


# ----------------------------------------------------------------------
# the log across the packages
# ----------------------------------------------------------------------
def _ops(s):
    """A seeded mix of puts, overwrites and deletes over three tables."""
    import random

    r = random.Random(0)
    for i in range(300):
        t, k = f"t{r.randrange(3)}", f"k{r.randrange(40)}"
        if r.random() < 0.2:
            s.delete(t, k)
        else:
            s.put(t, k, bytes(r.randrange(256) for _ in range(r.randrange(0, 24))))


@pytest.mark.parametrize("writer,reader", [("ray_tpu", "ray_tpu_torch"), ("ray_tpu_torch", "ray_tpu")])
def test_log_replays_across_packages(tmp_path, writer, reader):
    """A log one package wrote (with compactions, then a torn tail)
    replays in the other's to the same tables, and takes its appends."""
    path = str(tmp_path / "gcs.log")
    w = STORES[writer](path)
    w.COMPACT_EVERY = 70
    _ops(w)
    want = {t: w.all(t) for t in ("t0", "t1", "t2")}
    w.close()
    with open(path, "ab") as f:
        f.write(b'{"op":"put","t":"t0","k":"torn","v":"AAA')
    r = STORES[reader](path)
    assert {t: r.all(t) for t in ("t0", "t1", "t2")} == want
    r.put("t0", "after", b"x")
    r.close()
    back = STORES[writer](path)
    assert back.all("t0") == {**want["t0"], "after": b"x"}
    back.close()


def test_both_packages_write_the_same_bytes(tmp_path):
    logs = {}
    for name, cls in STORES.items():
        path = str(tmp_path / f"{name}.log")
        s = cls(path)
        s.COMPACT_EVERY = 70
        _ops(s)
        s.close()
        with open(path, "rb") as f:
            logs[name] = f.read()
    assert logs["ray_tpu"] == logs["ray_tpu_torch"]


# ----------------------------------------------------------------------
# kill -9 the head; restart; the state survives
# ----------------------------------------------------------------------
PHASE1 = """
import os, signal, time
import ray_tpu_torch
from ray_tpu_torch.core import context


@ray_tpu_torch.remote(lifetime="detached", name="ft_counter", max_restarts=-1)
class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=2, _system_config={"gcs_persist_path": os.environ["GCS_LOG"]})
    client = context.get_client()
    client.gcs.kv.put(b"survivor", b"it lives")  # the KV
    from ray_tpu_torch.job import JobManager

    jm = JobManager(client)
    jid = jm.submit_job(entrypoint="echo hello", submission_id="raysubmit_ft")
    print("JOB", jm.wait_until_finished(jid, timeout=60), flush=True)
    c = Counter.remote()  # a detached named actor
    assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
    print("PHASE1_READY", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)  # a head crash: no cleanup
"""

PHASE2 = """
import os
import ray_tpu_torch
from ray_tpu_torch.core import context

if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=2, _system_config={"gcs_persist_path": os.environ["GCS_LOG"]})
    client = context.get_client()
    assert client.gcs.kv.get(b"survivor") == b"it lives", client.gcs.kv.get(b"survivor")
    jobs = client.gcs.kv.keys(namespace="_jobs")  # the job table, through the JobManager's KV mirror
    assert any("raysubmit_ft" in str(k) for k in jobs), jobs
    # the detached actor is re-created: its name resolves and its methods run
    c = ray_tpu_torch.get_actor("ft_counter")
    n = ray_tpu_torch.get(c.incr.remote(), timeout=120)
    assert n == 1, n  # a fresh instance (its state is the app's to checkpoint), the same identity
    print("PHASE2_OK", flush=True)
    ray_tpu_torch.shutdown()
"""


def _script(tmp_path, name: str, code: str) -> str:
    path = tmp_path / name
    path.write_text(textwrap.dedent(code))
    return str(path)


def _run_phase(script: str, env_extra: dict, expect: str, timeout: float = 180.0, expect_kill: bool = False):
    env = {**os.environ, **env_extra, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, "-u", script], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            cwd=REPO)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        status = proc.poll()
        proc.kill()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            out = b"<the pipe is held open by a child process>"
        raise AssertionError(f"the phase timed out (status {status}); its output:\n"
                             f"{out.decode(errors='replace')[-4000:]}") from None
    text = out.decode(errors="replace")
    assert expect in text, f"the phase's output lacks {expect!r}:\n{text[-4000:]}"
    if expect_kill:
        assert proc.returncode == -signal.SIGKILL
    return text


def test_head_kill9_state_survives(tmp_path):
    log = str(tmp_path / "gcs.log")
    p1 = _script(tmp_path, "phase1.py", PHASE1)
    p2 = _script(tmp_path, "phase2.py", PHASE2)
    assert "JOB SUCCEEDED" in _run_phase(p1, {"GCS_LOG": log}, "PHASE1_READY", expect_kill=True)
    assert os.path.exists(log) and os.stat(log).st_mode & 0o777 == 0o600
    _run_phase(p2, {"GCS_LOG": log}, "PHASE2_OK")


BAD_RECORD = """
import os
import ray_tpu_torch
from ray_tpu_torch.core import context

if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=1, _system_config={"gcs_persist_path": os.environ["GCS_LOG"]})
    try:
        ray_tpu_torch.get_actor("ft_counter")
        print("FOUND")
    except ValueError as e:
        print("GONE", e)
    dead = [a for a in context.get_client().actors.values() if a.info.name == "ft_counter"]
    print("CAUSE", dead[0].info.death_cause if dead else None, flush=True)
    ray_tpu_torch.shutdown()
"""


def test_rehydration_fails_loudly_when_the_class_is_gone(tmp_path):
    """A detached actor whose class no longer resolves is marked dead with
    that error by the next head: never skipped silently."""
    log = str(tmp_path / "gcs.log")
    p1 = _script(tmp_path, "phase1.py", PHASE1)
    _run_phase(p1, {"GCS_LOG": log}, "PHASE1_READY", expect_kill=True)
    os.unlink(p1)  # the script that defined the class is gone
    out = _run_phase(_script(tmp_path, "bad.py", BAD_RECORD), {"GCS_LOG": log}, "CAUSE")
    assert "GONE" in out and "re-creating detached actor ft_counter" in out, out[-3000:]


# ----------------------------------------------------------------------
# an agent redials a restarted head on a fixed port
# ----------------------------------------------------------------------
HEAD1 = """
import os, signal, time
import ray_tpu_torch
from ray_tpu_torch.core import context

if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=1, _system_config={"gcs_persist_path": os.environ["GCS_LOG"],
                                                   "node_manager_port": int(os.environ["NM_PORT"])})
    client = context.get_client()
    deadline = time.monotonic() + 120
    while not any(n.labels.get("ray_tpu.io/node-type") == "joined" for n in client.node_list()):
        assert time.monotonic() < deadline, "the agent never joined head1"
        time.sleep(0.2)
    print("HEAD1_SAW_AGENT", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
"""

HEAD2 = """
import os, time
import ray_tpu_torch
from ray_tpu_torch.core import context
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


@ray_tpu_torch.remote
def ping():
    return os.getpid()


if __name__ == "__main__":
    ray_tpu_torch.init(num_cpus=1, _system_config={"gcs_persist_path": os.environ["GCS_LOG"],
                                                   "node_manager_port": int(os.environ["NM_PORT"])})
    client = context.get_client()
    deadline = time.monotonic() + 120
    joined = None
    while joined is None:
        assert time.monotonic() < deadline, "the agent never re-joined head2"
        time.sleep(0.2)
        joined = next((n for n in client.node_list() if n.labels.get("ray_tpu.io/node-type") == "joined"), None)
    strategy = NodeAffinitySchedulingStrategy(node_id=joined.node_id.hex(), soft=False)
    pid = ray_tpu_torch.get(ping.options(scheduling_strategy=strategy).remote(), timeout=90)
    assert pid != os.getpid()
    print("HEAD2_AGENT_WORKS", flush=True)
    ray_tpu_torch.shutdown()
"""


def test_agent_reconnects_to_restarted_head(tmp_path):
    import socket

    from ray_tpu_torch.util.tracing import session_dir

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    log = str(tmp_path / "gcs.log")
    env = {"GCS_LOG": log, "NM_PORT": str(port)}
    head1 = subprocess.Popen([sys.executable, "-u", _script(tmp_path, "head1.py", HEAD1)],
                             env={**os.environ, **env, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, cwd=REPO)
    agent = None
    try:
        # head1's cluster_info.json (its listener is up), then a standalone
        # agent pointed at head1 explicitly, with a reconnect window
        info_path = os.path.join(session_dir(head1.pid), "cluster_info.json")
        deadline = time.monotonic() + 60
        while not os.path.exists(info_path):
            assert time.monotonic() < deadline, "head1 never wrote cluster_info.json"
            assert head1.poll() is None, head1.stdout.read()
            time.sleep(0.2)
        with open(info_path) as f:
            info = json.load(f)
        agent_env = {**os.environ, "PYTHONPATH": REPO}
        agent_env.pop("RT_SHM_NS", None)
        agent = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "agent",
             "--address", f"{info['agent_address'][0]}:{info['agent_address'][1]}",
             "--authkey", info["authkey"], "--transfer-authkey", info["transfer_authkey"],
             "--num-cpus", "2", "--reconnect", "240"],
            env=agent_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out, _ = head1.communicate(timeout=240)
        assert b"HEAD1_SAW_AGENT" in out, out[-4000:]
        assert head1.returncode == -signal.SIGKILL
        # head1 is gone; the agent redials the fixed port
        _run_phase(_script(tmp_path, "head2.py", HEAD2), env, "HEAD2_AGENT_WORKS", timeout=180)
    finally:
        if agent is not None:
            agent.terminate()
            try:
                agent.wait(timeout=10)
            except subprocess.TimeoutExpired:
                agent.kill()
                agent.wait(timeout=10)
        if head1.poll() is None:
            head1.kill()
            head1.wait(timeout=10)
