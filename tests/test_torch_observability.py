"""State and monitors in the port (``util/metrics.py``'s fold,
``util/timeline.py``, ``core/log_monitor.py``, ``core/memory_monitor.py``,
``Runtime.dump_worker_stacks``, ``util/tracing.py``), against ray_tpu on
the CPU.

Twins of ``tests/test_observability.py``, each run on both packages:
metrics flowing from workers, the timeline export, worker logs streamed
to the driver, the memory monitor killing the largest retriable worker,
stale gauges expiring while counters fold, the live stack dump, and
spans stitched across nested remote calls. ray_tpu's cases hold a worker
busy with an 8 s sleep; here a worker waits on a release file instead.
Then the port's own: a worker's last flush as it exits, actor calls in
the timeline, the runtime's core series and the log monitor's partial
lines. One runtime of each package for the module (the tracing case
starts its own); remote code lives in ``tests/torch_env_defs.py``."""

import io
import json
import os
import time

import pytest
import torch_env_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu_torch.core import context as tcontext

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
ids = {"ids": lambda p: p.__name__}


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    yield
    for pkg in PKGS:
        pkg.shutdown()


def _metrics(pkg):
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.util import metrics
    else:
        from ray_tpu.util import metrics
    return metrics


def _wait(cond, timeout=15.0, period=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(period)
    return cond()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_metrics_flow_from_workers(both, pkg):
    assert sorted(pkg.get([pkg.remote(defs.work).remote(i) for i in range(2)], timeout=T)) == [0, 1]
    metrics = _metrics(pkg)

    def total():
        snap = metrics.get_metrics_snapshot()
        return snap.get("worker_ops_total", {}).get("series", {}).get("", 0.0) >= 2.0

    assert _wait(total, 10.0), f"worker metrics never aggregated: {metrics.get_metrics_snapshot()}"


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_timeline_export(both, pkg, tmp_path):
    pkg.get([pkg.remote(defs.step).remote(i) for i in range(4)], timeout=T)
    path = str(tmp_path / "trace.json")
    state = {}

    def enough():
        # direct-plane executions reach the head in batches: poll
        state["events"] = pkg.timeline(path)
        state["mine"] = [e for e in state["events"] if e["name"].startswith("step")]
        return len(state["mine"]) >= 4

    _wait(enough, 10.0, 0.2)
    with open(path) as f:
        on_disk = json.load(f)
    assert len(on_disk) == len(state["events"])
    assert len(state["mine"]) >= 4
    for e in state["mine"]:
        assert e["ph"] == "X" and e["dur"] >= 0.05 * 1e6 * 0.5
        assert e["tid"] != "?"


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_worker_logs_streamed_to_driver(both, pkg):
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.core.log_monitor import LogMonitor
        from ray_tpu_torch.util.state import session_dir
    else:
        from ray_tpu.core.log_monitor import LogMonitor
        from ray_tpu.util.state import session_dir
    assert pkg.get(pkg.remote(defs.chatty).remote(), timeout=T) == 1
    logs_dir = os.path.join(session_dir(), "logs")

    def found():
        for name in os.listdir(logs_dir) if os.path.isdir(logs_dir) else []:
            try:
                with open(os.path.join(logs_dir, name)) as f:
                    body = f.read()
            except OSError:
                continue
            if "hello-from-worker-stdout-xyzzy" in body and "hello-from-worker-stderr-xyzzy" in body:
                return True
        return False

    assert _wait(found, 15.0), "worker prints never reached the session log files"
    # and the monitor streams them to the driver's stderr
    buf = io.StringIO()
    LogMonitor(logs_dir, out=buf).poll_once()
    assert "hello-from-worker-stdout-xyzzy" in buf.getvalue()
    assert "(worker=" in buf.getvalue()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_memory_monitor_kills_largest_retriable_worker(both, pkg, tmp_path):
    """With the threshold forced to 0, the monitor kills the busy retriable
    worker and spares the non-retriable one."""
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor, proc_rss, system_memory
    else:
        from ray_tpu.core.memory_monitor import MemoryMonitor, proc_rss, system_memory
    avail, total = system_memory()
    assert 0 < avail <= total
    assert proc_rss(os.getpid()) > 0
    client = CTX[pkg].get_client()
    release = str(tmp_path / "release")
    r1 = pkg.remote(max_retries=0)(defs.hold).remote(str(tmp_path / "m1"), release, "survived")
    r2 = pkg.remote(max_retries=2)(defs.hold_retry).remote(str(tmp_path / "m2"), release, "done")

    def both_busy():
        # the retriable task rides a lease ("leased"), the other the head ("busy")
        return sum(1 for n in client.node_list() for w in list(n.workers.values())
                   if w.state in ("busy", "leased")) >= 2 and os.path.exists(tmp_path / "m2")

    assert _wait(both_busy, 30.0)
    mon = MemoryMonitor(client)
    mon.cfg = type("Cfg", (), {"memory_usage_threshold": 0.0, "memory_monitor_refresh_ms": 0})()
    mon.check_once()
    assert mon.kills == 1  # exactly one victim, and only the retriable one
    open(release, "w").close()
    assert pkg.get(r1, timeout=T) == "survived"
    assert pkg.get(r2, timeout=T) == "done"  # killed, then retried


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_stale_worker_gauges_expire_counters_fold(both, pkg):
    metrics = _metrics(pkg)
    client = CTX[pkg].get_client()

    def snap_of(gauge_v, counter_v, hist):
        return {
            "stale_t_gauge": {"kind": "gauge", "description": "", "tag_keys": (), "series": {"": gauge_v}},
            "stale_t_counter": {"kind": "counter", "description": "", "tag_keys": (), "series": {"": counter_v}},
            "stale_t_hist": {"kind": "histogram", "description": "", "tag_keys": (), "boundaries": [1.0],
                             "series": {"": list(hist)}},
        }

    now = time.time()
    client.kv("put", key="proc::t-live", namespace="_metrics",
              value={"ts": now, "metrics": snap_of(5.0, 3.0, [1.0, 0.5, 1.0, 0.0])})
    client.kv("put", key="proc::t-dead", namespace="_metrics",
              value={"ts": now - 10 * metrics.STALE_SNAPSHOT_S, "metrics": snap_of(7.0, 4.0, [2.0, 9.0, 0.0, 2.0])})
    try:
        merged = metrics.get_metrics_snapshot(client)
        # counters and histograms fold from both (the dead worker's work happened)
        assert merged["stale_t_counter"]["series"][""] == 7.0
        assert merged["stale_t_hist"]["series"][""] == [3.0, 9.5, 1.0, 2.0]
        # the dead worker's gauge expired: only the live writer's value shows
        assert merged["stale_t_gauge"]["series"][""] == 5.0
        # snapshots without a timestamp still fold whole
        client.kv("put", key="proc::t-legacy", namespace="_metrics", value=snap_of(9.0, 1.0, [0.0, 0.0, 0.0, 0.0]))
        merged = metrics.get_metrics_snapshot(client)
        assert merged["stale_t_counter"]["series"][""] == 8.0
        assert merged["stale_t_gauge"]["series"][""] in (5.0, 9.0)
    finally:
        for k in ("proc::t-live", "proc::t-dead", "proc::t-legacy"):
            client.kv("delete", key=k, namespace="_metrics")


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_live_worker_stack_dump(both, pkg, tmp_path):
    """A worker busy in user code still reports every thread's stack,
    the executing frame among them."""
    client = CTX[pkg].get_client()
    release = str(tmp_path / "release")
    ref = pkg.remote(defs.busy).remote("done", release)
    state = {}

    def busy_seen():
        state["dumps"] = client.dump_worker_stacks()
        state["busy"] = {w: d for w, d in state["dumps"].items()
                         if any("deep_in_user_code" in s for s in d.get("stacks", {}).values())}
        return state["busy"]

    try:
        assert _wait(busy_seen, 60.0, 0.2), f"never saw the executing frame in {list(state['dumps'])}"
        (wid, dump), = state["busy"].items()
        assert dump["current_task"] is not None
        assert not dump.get("unresponsive")
        # the receive loop itself is visible too (proof it stayed free)
        assert any("MainThread" in name for name in dump["stacks"])
    finally:
        open(release, "w").close()
    assert pkg.get(ref, timeout=T) == "done"


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_tracing_spans_propagate_across_nested_remote_calls(pkg):
    """One trace id stitches driver -> task -> nested task."""
    if pkg is ray_tpu_torch:
        from ray_tpu_torch.util import tracing
    else:
        from ray_tpu.util import tracing
    pkg.shutdown()
    os.environ["RT_TRACING"] = "1"
    tracing.configure(True)
    try:
        pkg.init(num_cpus=4)
        assert pkg.get(pkg.remote(defs.parent).remote(1), timeout=T) == 12
        state = {}

        def two_tasks():
            state["spans"] = tracing.load_spans()
            tasks = [s for s in state["spans"] if s["kind"] == "server" and s["name"].startswith("task::")]
            return len(tasks) >= 2

        _wait(two_tasks, 20.0, 0.2)
        spans = state["spans"]
        names = {s["name"] for s in spans}
        assert "submit::parent" in names and "task::parent" in names
        assert "submit::child" in names and "task::child" in names
        p_task = next(s for s in spans if s["name"] == "task::parent")
        c_task = next(s for s in spans if s["name"] == "task::child")
        c_submit = next(s for s in spans if s["name"] == "submit::child")
        # one trace end to end; the child's submit span opened inside the
        # parent task's span (propagation across processes)
        assert p_task["trace_id"] == c_task["trace_id"] == c_submit["trace_id"]
        assert c_submit["parent_id"] == p_task["span_id"]
        assert c_task["parent_id"] == c_submit["span_id"]
    finally:
        os.environ.pop("RT_TRACING", None)
        tracing.configure(False)
        pkg.shutdown()
        pkg.init(num_cpus=4)  # the module's runtime again


# ---------------------------------------------------------------- the port's own
def test_exiting_worker_flushes_its_metrics_once_more():
    """A card-bound worker retires right after its task (a host with one
    counted card that no worker touches): the counter its task bumped
    reaches the fold through the worker's last flush as it exits, well
    before its flusher's first 1 s tick."""
    from ray_tpu_torch.util import metrics

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(defs.bump_once).remote("exit_flush_total"),
                                timeout=T)

        def folded():
            return metrics.get_metrics_snapshot().get("exit_flush_total", {}).get("series", {}).get("") == 1.0

        assert _wait(folded, 5.0, 0.05)
        assert _wait(lambda: not os.path.exists(f"/proc/{pid}") or _zombie(pid), 5.0)
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=4)  # the module's runtime again


def _zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_timeline_has_actor_calls_with_their_worker(both, tmp_path):
    A = ray_tpu_torch.remote(defs.Counting)
    a = A.remote()
    for _ in range(3):
        ray_tpu_torch.get(a.bump.remote("timeline_actor_total"), timeout=T)
    client = tcontext.get_client()
    (w,) = [w for n in client.node_list() for w in n.workers.values() if w.actor_id == a._actor_id]

    def calls():
        return [e for e in ray_tpu_torch.timeline() if e["name"].endswith("bump") and e["cat"] == "actor_task"]

    got = _wait(lambda: len(calls()) >= 3 and calls(), 10.0, 0.2)
    assert got and all(e["tid"] == w.worker_id.hex()[:8] for e in got)
    ray_tpu_torch.kill(a)


def test_core_series_in_the_prometheus_text(both):
    from ray_tpu_torch.util import metrics

    ray_tpu_torch.get([ray_tpu_torch.remote(defs.one).remote() for _ in range(3)], timeout=T)
    client = tcontext.get_client()
    text = metrics.export_prometheus(client)
    for name in ("rt_tasks_running", "rt_tasks_finished_total", "rt_tasks_submitted_total", "rt_object_store_bytes",
                 "rt_transfer_pull_bytes_total"):
        assert f"# TYPE {name}" in text, name
    life = client.task_manager.lifetime_counts()
    assert life["submitted"] >= life["finished"] >= 3


def test_log_monitor_holds_a_partial_line_until_its_newline(tmp_path):
    from ray_tpu_torch.core.log_monitor import LogMonitor

    path = tmp_path / "worker-abc.log"
    path.write_bytes(b"first\nsec")
    buf = io.StringIO()
    mon = LogMonitor(str(tmp_path), out=buf)
    mon.poll_once()
    assert buf.getvalue() == "(worker=abc) first\n"
    with open(path, "ab") as f:
        f.write(b"ond\n")
    mon.poll_once()
    assert buf.getvalue() == "(worker=abc) first\n(worker=abc) second\n"


def test_unresponsive_worker_is_reported_not_waited_for(both, tmp_path):
    """Of two busy workers, one stopped (SIGSTOP) cannot answer on its
    receive loop: the dump marks it unresponsive within its timeout and
    still returns the other's stacks, its executing frame among them."""
    import signal

    client = tcontext.get_client()
    release = str(tmp_path / "release")
    # max_retries=0: the head dispatches each to a worker of its own (a lease would queue them on one)
    refs = [ray_tpu_torch.remote(max_retries=0)(defs.busy).remote(i, release) for i in range(2)]

    def running():
        ws = [w for n in client.node_list() for w in list(n.workers.values())
              if w.state in ("busy", "leased") and w.proc.pid]
        return ws if len(ws) == 2 else None

    stopped, other = _wait(running, 30.0)
    os.kill(stopped.proc.pid, signal.SIGSTOP)
    try:
        t0 = time.monotonic()
        dumps = client.dump_worker_stacks(timeout=1.0)
        took = time.monotonic() - t0
    finally:
        os.kill(stopped.proc.pid, signal.SIGCONT)
        open(release, "w").close()
    assert dumps[stopped.worker_id.hex()] == {"unresponsive": True, "stacks": {}}
    assert took < 5.0
    assert any("deep_in_user_code" in st for st in dumps[other.worker_id.hex()]["stacks"].values()), dumps
    assert sorted(ray_tpu_torch.get(refs, timeout=T)) == [0, 1]


def test_metrics_namespace_stays_out_of_the_persistent_log(tmp_path):
    """Workers rewrite their snapshots every second: the ``_metrics``
    namespace lives in memory only, every other namespace reaches the
    GCS's log (``gcs_persist_path``)."""
    from ray_tpu_torch.core.gcs import Gcs
    from ray_tpu_torch.core.table_store import FileTableStore

    path = str(tmp_path / "gcs.log")
    g = Gcs(FileTableStore(path))
    g.kv.put("proc::w1", {"ts": 1.0, "metrics": {}}, namespace="_metrics")
    g.kv.put("k", "v", namespace="default")
    assert g.kv.get("proc::w1", namespace="_metrics") == {"ts": 1.0, "metrics": {}}
    assert g.kv.delete("proc::w1", namespace="_metrics")
    g.store.close()
    again = Gcs(FileTableStore(path))
    assert again.kv.get("k", namespace="default") == "v"
    assert again.kv.keys(namespace="_metrics") == []
    again.store.close()
