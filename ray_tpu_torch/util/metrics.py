"""Metrics API: Counter / Gauge / Histogram over this process's registry
(port of ray_tpu/util/metrics.py).

    from ray_tpu_torch.util import metrics
    c = metrics.Counter("requests_total", description="...", tag_keys=("route",))
    c.inc(1.0, tags={"route": "/api"})

Ported: the registry (one per process, a name registered twice shares its
series; a second registration under another kind or other histogram
boundaries raises), hot-path bound series, the three instruments and the
Prometheus text exposition of this process's registry.

Not ported: the worker-to-GCS flusher (``_ensure_flusher``,
``flush_once``), the cluster fold of ``get_metrics_snapshot`` and
``update_core_metrics``: they fold every worker's series through the
GCS, with the state and monitors item (ROADMAP.md, queue 1, state and
monitors); ``export_prometheus`` here exposes this process's series only.
"""

from __future__ import annotations

import bisect
import threading

_DEFAULT_HIST_BOUNDARIES = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: dict[str, "Metric"] = {}

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
            return m

    def snapshot(self) -> dict:
        with self.lock:
            return {name: m._dump() for name, m in self.metrics.items()}


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


def get_metrics_snapshot() -> dict:
    """This process's registry: name -> {kind, description, tag_keys,
    series[, boundaries]}."""
    return _registry.snapshot()


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline
    (exposition format spec). Without it a tag like model="a\"b" corrupts
    the whole scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: backslash and newline only (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def export_prometheus() -> str:
    """Prometheus text exposition of this process's registry: cumulative
    ``le`` buckets with ``+Inf``, ``_count`` and ``_sum`` for histograms."""
    lines = []
    for name, m in sorted(get_metrics_snapshot().items()):
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
