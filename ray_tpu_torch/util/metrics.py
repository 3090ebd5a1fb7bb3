"""Metrics API: Counter / Gauge / Histogram with the cluster's fold (port
of ray_tpu/util/metrics.py).

    from ray_tpu_torch.util import metrics
    c = metrics.Counter("requests_total", description="...", tag_keys=("route",))
    c.inc(1.0, tags={"route": "/api"})

Every process keeps a registry (a name registered twice shares its
series; a second registration under another kind or other histogram
boundaries raises). A worker (``RT_WORKER_ID`` set) flushes its registry
into the head's GCS KV (namespace ``_metrics``, stamped with the time)
every second on a thread of its own, and once more when it exits.
``get_metrics_snapshot(client)`` folds this process's registry with every
flushed one: counters and histograms add up, gauges take the last
writer's value, and a snapshot older than ``STALE_SNAPSHOT_S`` (a dead
worker's) keeps its counters and histograms but not its gauges.
``update_core_metrics`` drives the runtime's own series from the head's
tables; ``export_prometheus`` writes the fold as Prometheus text.
"""

from __future__ import annotations

import bisect
import os
import threading
import time

_DEFAULT_HIST_BOUNDARIES = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: dict[str, "Metric"] = {}
        self._flusher: threading.Thread | None = None

    def register(self, m: "Metric"):
        with self.lock:
            existing = self.metrics.get(m.name)
            if existing is not None:
                if existing.kind != m.kind or getattr(existing, "boundaries", None) != getattr(m, "boundaries", None):
                    raise ValueError(
                        f"metric {m.name!r} already registered as {existing.kind}"
                        f"{' with different boundaries' if existing.kind == m.kind else ''}"
                    )
                return existing
            self.metrics[m.name] = m
            self._ensure_flusher()
            return m

    def snapshot(self) -> dict:
        with self.lock:
            return {name: m._dump() for name, m in self.metrics.items()}

    def _ensure_flusher(self):
        # only a worker pushes; a driver's registry is read in place
        if self._flusher is not None or os.environ.get("RT_WORKER_ID") is None:
            return
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True, name="rt-metrics-flush")
        self._flusher.start()

    def flush_once(self):
        """Put this process's registry into the head's GCS KV, stamped with
        the wall clock, so the fold can expire a dead worker's gauges."""
        from ray_tpu_torch.core import context

        client = context.maybe_client()
        if client is None:
            return
        key = f"proc::{os.environ.get('RT_WORKER_ID', str(os.getpid()))}"
        value = {"ts": time.time(), "metrics": self.snapshot()}
        try:
            if hasattr(client, "push_metrics"):
                client.push_metrics(key, value)  # a worker: one way, on its pipe
            else:
                client.kv("put", key=key, value=value, namespace="_metrics")
        except (OSError, ValueError, EOFError, TimeoutError):
            pass  # the head is gone: nothing reads the fold any more

    def _flush_loop(self):
        while True:
            time.sleep(1.0)
            self.flush_once()


_registry = _Registry()


class _BoundSeries:
    """Pre-resolved (metric, series-key) handle for hot paths (the
    prometheus-client ``.labels(...)`` pattern): skips the per-call tag
    merge and validation of inc/set/observe. The serving telemetry plane
    (``llm/telemetry.py``) calls these on every step."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Metric", key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, value: float = 1.0):
        m = self._metric
        with m._lock:
            m._series[self._key] = float(m._series.get(self._key, 0.0)) + value

    def set(self, value: float):
        m = self._metric
        with m._lock:
            m._series[self._key] = float(value)

    def observe(self, value: float):
        m = self._metric
        with m._lock:
            buckets = m._series.get(self._key)
            if not isinstance(buckets, list):
                buckets = [0.0, 0.0] + [0.0] * (len(m.boundaries) + 1)
                m._series[self._key] = buckets
            buckets[0] += 1
            buckets[1] += value
            buckets[2 + bisect.bisect_left(m.boundaries, value)] += 1


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "", tag_keys: tuple = ()):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._series: dict[tuple, float | list] = {}
        self._lock = threading.Lock()
        shared = _registry.register(self)
        if shared is not self:
            # same name registered twice in one process: share the series
            self._series = shared._series
            self._lock = shared._lock

    def bind(self, tags: dict | None = None) -> _BoundSeries:
        """Resolve ``tags`` once and return a hot-path handle whose
        inc/set/observe skip the per-call merge and validation."""
        return _BoundSeries(self, self._key(tags))

    def _key(self, tags: dict | None) -> tuple:
        merged = tags or {}
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"tags {extra} not in tag_keys {self.tag_keys}")
        return tuple(str(merged.get(k, "")) for k in self.tag_keys)

    def _dump(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind,
                "description": self.description,
                "tag_keys": self.tag_keys,
                "series": {",".join(k): v if not isinstance(v, list) else list(v) for k, v in self._series.items()},
            }


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._series[k] = float(self._series.get(k, 0.0)) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None):
        with self._lock:
            self._series[self._key(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description: str = "", boundaries=None, tag_keys: tuple = ()):
        self.boundaries = list(boundaries or _DEFAULT_HIST_BOUNDARIES)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: dict | None = None):
        k = self._key(tags)
        with self._lock:
            buckets = self._series.get(k)
            if not isinstance(buckets, list):
                # [count, sum, bucket_counts...]
                buckets = [0.0, 0.0] + [0.0] * (len(self.boundaries) + 1)
                self._series[k] = buckets
            buckets[0] += 1
            buckets[1] += value
            buckets[2 + bisect.bisect_left(self.boundaries, value)] += 1

    def _dump(self) -> dict:
        d = super()._dump()
        d["boundaries"] = self.boundaries
        return d


# a worker's flushed snapshot outlives the worker in the GCS KV: older
# than this, its gauges drop out of the fold (a live worker flushes every
# second), its counters and histograms, lifetime totals, stay
STALE_SNAPSHOT_S = float(os.environ.get("RT_METRICS_STALE_S", "15"))


def get_metrics_snapshot(client=None) -> dict:
    """name -> {kind, description, tag_keys, series[, boundaries]}: this
    process's registry folded with every worker's flushed one (when a
    runtime is up, or ``client`` is given)."""
    from ray_tpu_torch.core import context

    merged: dict = {}

    def fold(proc_snap: dict, stale: bool = False):
        for name, m in proc_snap.items():
            agg = merged.setdefault(name, {"kind": m["kind"], "description": m["description"],
                                           "tag_keys": tuple(m["tag_keys"]), "series": {}})
            if "boundaries" in m:
                agg["boundaries"] = m["boundaries"]
            if m["kind"] == "gauge" and stale:
                continue  # a dead writer's point-in-time values expired
            for key, val in m["series"].items():
                cur = agg["series"].get(key)
                if isinstance(val, list):
                    agg["series"][key] = [a + b for a, b in zip(cur, val)] if cur else list(val)
                elif m["kind"] == "gauge":
                    agg["series"][key] = val  # the last writer wins
                else:
                    agg["series"][key] = (cur or 0.0) + val

    fold(_registry.snapshot())
    c = client or context.maybe_client()
    if c is None:
        return merged
    try:
        keys = c.kv("keys", prefix="proc::", namespace="_metrics")
    except Exception:  # noqa: BLE001 — no head to ask (it shut down): this process's series only
        return merged
    for key in keys:
        snap = c.kv("get", key=key, namespace="_metrics")
        if not snap:
            continue
        stale = False
        if isinstance(snap, dict) and "metrics" in snap and "ts" in snap:
            stale = (time.time() - float(snap["ts"])) > STALE_SNAPSHOT_S
            snap = snap["metrics"]
        fold(snap, stale=stale)
    return merged


_core_counter_last: dict = {}
_core_counter_lock = threading.Lock()  # concurrent scrapes must not add a delta twice


def update_core_metrics(client) -> None:
    """Refresh the runtime's own series (rt_tasks_*, rt_object_store_*,
    rt_transfer_*) from the head's tables; called on each scrape
    (``export_prometheus(client)``)."""
    from ray_tpu_torch.core import transport

    counts: dict[str, int] = {}
    for t in client.cluster_info("tasks"):
        counts[t["status"]] = counts.get(t["status"], 0) + 1
    Gauge("rt_tasks_running", description="tasks currently executing").set(float(counts.get("RUNNING", 0)))
    Gauge("rt_tasks_pending", description="tasks queued or waiting").set(
        float(counts.get("PENDING", 0) + counts.get("QUEUED", 0) + counts.get("WAITING", 0)))
    # lifetime totals, not the pruned window of states()
    life = client.task_manager.lifetime_counts()
    _bump_counter("rt_tasks_finished_total", "tasks finished", float(life["finished"]))
    _bump_counter("rt_tasks_submitted_total", "tasks submitted", float(life["submitted"]))
    obj = client.cluster_info("objects")
    Gauge("rt_object_store_bytes", description="sealed shm bytes").set(float(obj.get("shm_bytes", 0)))
    Gauge("rt_object_store_spilled_bytes", description="spilled bytes").set(float(obj.get("spilled_bytes", 0)))
    _bump_counter("rt_transfer_pull_bytes_total", "bytes pulled", float(transport.STATS.get("pull_bytes", 0)))
    _bump_counter("rt_transfer_serve_bytes_total", "bytes served", float(transport.STATS.get("serve_bytes", 0)))


def _bump_counter(name: str, desc: str, absolute: float) -> None:
    """Drive a Counter from an absolute total kept elsewhere (add the delta)."""
    c = Counter(name, description=desc)
    c.inc(0.0)  # the series exists even at 0
    with _core_counter_lock:
        last = _core_counter_last.get(name, 0.0)
        delta = absolute - last
        _core_counter_last[name] = max(last, absolute)
    if delta > 0:
        c.inc(delta)


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline
    (exposition format spec). Without it a tag like model="a\"b" corrupts
    the whole scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: backslash and newline only (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def export_prometheus(client=None) -> str:
    """Prometheus text exposition of the fold: cumulative ``le`` buckets
    with ``+Inf``, ``_count`` and ``_sum`` for histograms. With ``client``
    (a head) the runtime's own series are refreshed first."""
    if client is not None:
        update_core_metrics(client)
    lines = []
    for name, m in sorted(get_metrics_snapshot(client).items()):
        lines.append(f"# HELP {name} {_escape_help(m['description'])}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for key, val in m["series"].items():
            tags = ""
            if m["tag_keys"]:
                vals = key.split(",")
                tags = "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in zip(m["tag_keys"], vals)) + "}"
            if isinstance(val, list):
                count, total, *buckets = val
                bounds = m.get("boundaries", _DEFAULT_HIST_BOUNDARIES)
                cum = 0.0
                for b, n in zip(list(bounds) + ["+Inf"], buckets):
                    cum += n
                    lb = tags[:-1] + "," if tags else "{"
                    lines.append(f'{name}_bucket{lb}le="{b}"}} {cum:g}')
                lines.append(f"{name}_count{tags} {count:g}")
                lines.append(f"{name}_sum{tags} {total:g}")
            else:
                lines.append(f"{name}{tags} {val:g}")
    return "\n".join(lines) + "\n"
