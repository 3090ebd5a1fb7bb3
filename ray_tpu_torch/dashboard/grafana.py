"""Grafana provisioning from the live metrics registry (port of
ray_tpu/dashboard/grafana.py).

ray_tpu's panels and queries: the runtime's core series, the serving row
over the engine's telemetry catalog (``llm/telemetry.py``, the same
names as ray_tpu's), and one panel per registered application metric.

    from ray_tpu_torch.dashboard.grafana import grafana_dashboard_json
    open("ray_tpu_torch_dashboard.json", "w").write(grafana_dashboard_json())

Point Grafana's provisioning at the file; the panels query the
Prometheus datasource ``datasource`` scraping the head's ``/metrics``
(``dashboard/dashboard.py``).
"""

from __future__ import annotations

import json

# the hand-built core panels' series (refreshed on each scrape by
# util/metrics.update_core_metrics)
CORE_SERIES = (
    "rt_tasks_finished_total",
    "rt_tasks_submitted_total",
    "rt_tasks_running",
    "rt_tasks_pending",
    "rt_object_store_bytes",
    "rt_object_store_spilled_bytes",
    "rt_transfer_pull_bytes_total",
    "rt_transfer_serve_bytes_total",
)


def _panel(pid: int, title: str, exprs: list[tuple[str, str]], *, y: int, x: int = 0, w: int = 12, h: int = 8, unit: str = "short", datasource: str = "Prometheus") -> dict:
    return {
        "id": pid,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": datasource},
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [
            {"expr": expr, "legendFormat": legend, "refId": chr(ord("A") + i)}
            for i, (expr, legend) in enumerate(exprs)
        ],
    }


def grafana_dashboard_json(client=None, *, datasource: str = "Prometheus", title: str = "ray_tpu") -> str:
    """Build the dashboard JSON: core panels (tasks, objects, transfers)
    plus one panel per registered application metric."""
    from ray_tpu_torch.util.metrics import get_metrics_snapshot

    panels = []
    pid = 1
    y = 0

    def add(title, exprs, **kw):
        nonlocal pid, y
        panels.append(_panel(pid, title, exprs, y=y, datasource=datasource, **kw))
        pid += 1
        if kw.get("x", 0) + kw.get("w", 12) >= 24:
            y += kw.get("h", 8)

    # -- core panels (series from the head's /metrics exposition) --
    add("Task throughput", [("rate(rt_tasks_finished_total[1m])", "finished/s"), ("rate(rt_tasks_submitted_total[1m])", "submitted/s")], w=12, x=0)
    add("Tasks in flight", [("rt_tasks_running", "running"), ("rt_tasks_pending", "pending")], w=12, x=12)
    add("Object store", [("rt_object_store_bytes", "shm bytes"), ("rt_object_store_spilled_bytes", "spilled")], unit="bytes", w=12, x=0)
    add("Object transfers", [("rate(rt_transfer_pull_bytes_total[1m])", "pull B/s"), ("rate(rt_transfer_serve_bytes_total[1m])", "serve B/s")], unit="Bps", w=12, x=12)

    # -- Serving row: the LLM hot path's SLOs (llm/telemetry.py catalog;
    # series tagged by model/replica/stage, so legends stay per-replica) --
    add("Serving: time to first token", [
        ("histogram_quantile(0.5, rate(rt_llm_ttft_s_bucket[5m]))", "p50"),
        ("histogram_quantile(0.99, rate(rt_llm_ttft_s_bucket[5m]))", "p99"),
    ], unit="s", w=12, x=0)
    add("Serving: inter-token latency", [
        ("histogram_quantile(0.5, rate(rt_llm_itl_s_bucket[5m]))", "p50"),
        ("histogram_quantile(0.99, rate(rt_llm_itl_s_bucket[5m]))", "p99"),
    ], unit="s", w=12, x=12)
    add("Serving: admission queue", [
        ("histogram_quantile(0.99, rate(rt_llm_queue_wait_s_bucket[5m]))", "queue wait p99"),
        ("rt_llm_queue_depth", "depth"),
    ], w=12, x=0)
    add("Serving: token throughput", [
        ("rate(rt_llm_tokens_total[1m])", "decode tok/s"),
        ("rate(rt_llm_prefill_tokens_total[1m])", "prefill tok/s"),
    ], w=12, x=12)
    add("Serving: KV occupancy", [
        ("rt_llm_kv_occupancy", "occupied fraction"),
        ("rt_llm_slots_in_use", "slots in use"),
    ], w=12, x=0)
    add("Serving: KV HBM bytes", [("rt_llm_kv_hbm_bytes", "occupied bytes")], unit="bytes", w=12, x=12)
    add("Serving: speculation & preemption", [
        ("rt_llm_spec_acceptance", "spec acceptance"),
        ("rate(rt_llm_preemptions_total[5m])", "preemptions/s"),
    ], w=12, x=0)
    add("Serving: recompile sentinel", [
        ("increase(rt_llm_recompiles_total[5m])", "recompiles (5m)"),
    ], w=12, x=12)
    add("Serving: collective wire", [
        ("rate(rt_llm_collective_wire_bytes_total[1m])", "wire B/s"),
    ], unit="Bps", w=12, x=0)
    add("Serving: disagg handoffs", [
        ("rate(rt_llm_handoff_bytes_total[1m])", "handoff B/s"),
        ("rate(rt_llm_handoffs_total[1m])", "events/s"),
    ], w=12, x=12)
    add("Serving: cluster prefix reuse", [
        # cluster hit-rate: hits (both tiers, all replicas) per admitted
        # request — shared-prefix traffic converging on warm replicas
        ("sum by (tier) (rate(rt_llm_prefix_hits_total[5m]))", "hits/s {{tier}}"),
        ("sum(rate(rt_llm_prefix_hits_total[5m])) / sum(rate(rt_llm_requests_finished_total[5m]))", "cluster hit-rate"),
        ("rate(rt_llm_prefix_fetch_bytes_total[1m])", "remote fetch B/s"),
    ], w=12, x=0)
    add("Serving: overload & drain", [
        # the degradation-order dashboard: under pressure the shed rate
        # (lowest class first) and queue-wait estimate move while decode
        # ITL (panel above) must not. `stage` stays in the sum because a
        # router's per-request sheds and the replica ingresses'
        # per-attempt sheds are different rates — folding them together
        # would overcount one client request by its failover fan-out
        ("sum by (class, stage) (rate(rt_llm_requests_shed_total[1m]))", "shed/s {{stage}} c{{class}}"),
        ("rt_llm_admission_queue_wait_est_ms", "est queue wait (ms)"),
        ("rt_llm_drain_state", "drain state"),
        ("rate(rt_llm_retry_budget_exhausted_total[5m])", "retry budget exhausted/s"),
    ], w=12, x=12)
    add("Serving: preemption & migration", [
        # the evacuation dashboard (llm/migrate.py): checkpoint/restore
        # rates by outcome (source and peer replicas count their own
        # halves; routers count resumed/lost once per client request —
        # stage separates them), splice latency p99, and the checkpoint
        # bytes crossing the object plane
        ("sum by (outcome, stage) (rate(rt_llm_migrations_total[5m]))", "migrations/s {{stage}} {{outcome}}"),
        ("histogram_quantile(0.99, sum by (le) (rate(rt_llm_migration_splice_s_bucket[5m])))", "splice p99 (s)"),
        ("rate(rt_llm_migration_bytes_total[1m])", "checkpoint B/s"),
    ], w=12, x=0)
    add("Serving: KV tiering", [
        # the latency-hiding KV plane: the async fetch
        # span p99 (transfers overlapping serving steps — compare against
        # the ITL panel: a healthy fleet's fetch p99 exceeding ITL is
        # FINE, that's the latency being hidden), the predictive
        # prefetcher's remote->local conversion rate, and the
        # conversation-KV spill volume leaving HBM for the DRAM tier
        ("histogram_quantile(0.99, sum by (le) (rate(rt_llm_prefix_fetch_overlap_s_bucket[5m])))", "async fetch p99 (s)"),
        ("rate(rt_llm_prefix_prefetch_hits_total[5m])", "prefetch-converted hits/s"),
        ("rate(rt_llm_kv_spilled_bytes_total[1m])", "KV spill B/s"),
    ], w=12, x=12)

    # -- one panel per registered metric (user Counters/Gauges/Histograms) --
    snapshot = get_metrics_snapshot(client)
    for name, m in sorted(snapshot.items()):
        if name.startswith("rt_"):
            continue  # core series already have hand-built panels above
        kind = m.get("kind", "gauge")
        if kind == "counter":
            exprs = [(f"rate({name}[1m])", f"{name}/s")]
        elif kind == "histogram":
            exprs = [
                (f"histogram_quantile(0.5, rate({name}_bucket[5m]))", "p50"),
                (f"histogram_quantile(0.99, rate({name}_bucket[5m]))", "p99"),
            ]
        else:
            exprs = [(name, name)]
        add(m.get("description") or name, exprs, w=12, x=(len(panels) % 2) * 12)

    dashboard = {
        "uid": "ray-tpu-default",
        "title": title,
        "tags": ["ray_tpu"],
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "panels": panels,
    }
    return json.dumps(dashboard, indent=1)
