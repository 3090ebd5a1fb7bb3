"""The dashboard and Grafana provisioning in the port (``dashboard/``),
against ray_tpu on the CPU.

Twins, each run on both packages: ``tests/test_dashboard_dag.py``'s
endpoints case, ``tests/test_observability.py``'s stacks endpoint, its
Grafana factory and its core series behind the panels, and
``tests/test_llm_telemetry.py``'s serving row over the telemetry catalog.
Then the comparisons: every route's JSON keys and every panel's queries
equal ray_tpu's; the differences kept on purpose (the page's title and
its card column, one legend) are asserted here and listed in
ROADMAP.md. One runtime of each package for the module; remote code in
``tests/torch_tooling_defs.py``."""

import json
import time
import urllib.error
import urllib.request

import pytest
import torch_tooling_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import context as jcontext
from ray_tpu_torch.core import context as tcontext

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
CTX = {ray_tpu: jcontext, ray_tpu_torch: tcontext}
ids = {"ids": lambda p: p.__name__}


def _mods(pkg):
    """(dashboard, grafana, metrics, llm telemetry) of ``pkg``."""
    if pkg is ray_tpu_torch:
        from ray_tpu_torch import dashboard
        from ray_tpu_torch.dashboard import grafana
        from ray_tpu_torch.llm import telemetry
        from ray_tpu_torch.util import metrics
    else:
        from ray_tpu import dashboard
        from ray_tpu.dashboard import grafana
        from ray_tpu.llm import telemetry
        from ray_tpu.util import metrics
    return dashboard, grafana, metrics, telemetry


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        pkg.shutdown()
        pkg.init(num_cpus=4)
    actors = {pkg: pkg.remote(defs.Pinger).options(name="dash_actor").remote() for pkg in PKGS}
    for pkg, a in actors.items():
        assert pkg.get(a.ping.remote(), timeout=T) == "pong"
    yield
    for pkg in PKGS:
        pkg.shutdown()


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_dashboard_endpoints(both, pkg):
    dashboard, _, metrics, _ = _mods(pkg)
    metrics.Counter("dash_hits_total").inc(3.0)
    dash = dashboard.start_dashboard(port=0)
    try:
        cluster = json.loads(_get(f"{dash.url}/api/cluster"))
        assert cluster["cluster_resources"].get("CPU", 0) > 0
        nodes = json.loads(_get(f"{dash.url}/api/nodes"))
        assert nodes and nodes[0]["alive"]
        actors = json.loads(_get(f"{dash.url}/api/actors"))
        assert any(x["name"] == "dash_actor" for x in actors)
        page = _get(f"{dash.url}/").decode()
        assert f"{pkg.__name__} dashboard" in page
        prom = _get(f"{dash.url}/metrics").decode()
        assert "dash_hits_total 3" in prom
        assert isinstance(json.loads(_get(f"{dash.url}/api/jobs")), list)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{dash.url}/api/nope")
        assert exc.value.code == 404
    finally:
        dash.stop()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_dashboard_stacks_endpoint(both, pkg):
    dashboard, _, _, _ = _mods(pkg)
    assert pkg.get(pkg.remote(defs.nop).remote(), timeout=T) == 1  # a worker exists
    db = dashboard.Dashboard(CTX[pkg].get_client(), port=0)
    db.start()
    try:
        data = json.loads(_get(f"http://127.0.0.1:{db.port}/api/stacks"))
        assert isinstance(data, dict) and data  # one entry per live worker
        for dump in data.values():
            assert "stacks" in dump
        # a prefix picks that worker alone
        wid = sorted(data)[0]
        one = json.loads(_get(f"http://127.0.0.1:{db.port}/api/stacks/{wid[:12]}"))
        assert list(one) == [wid] and "stacks" in one[wid]
    finally:
        db.stop()


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_grafana_dashboard_factory(both, pkg):
    _, grafana, metrics, _ = _mods(pkg)
    metrics.Counter("app_requests_total", description="app requests").inc(3)
    metrics.Histogram("app_latency_s", description="app latency").observe(0.01)
    dash = json.loads(grafana.grafana_dashboard_json())
    assert dash["uid"] == "ray-tpu-default"
    titles = [p["title"] for p in dash["panels"]]
    assert "Task throughput" in titles and "Object store" in titles
    exprs = [t["expr"] for p in dash["panels"] for t in p["targets"]]
    assert any("rate(app_requests_total[1m])" in e for e in exprs)
    assert any("histogram_quantile(0.99, rate(app_latency_s_bucket[5m]))" in e for e in exprs)
    for p in dash["panels"]:
        assert p["type"] == "timeseries" and p["targets"], p["title"]


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_core_metrics_back_grafana_panels(both, pkg):
    """The core rt_* series the factory queries exist in the exposition."""
    _, grafana, metrics, _ = _mods(pkg)
    client = CTX[pkg].get_client()
    before = client.task_manager.lifetime_counts()["finished"]
    pkg.get([pkg.remote(defs.nop).remote() for _ in range(3)], timeout=T)
    deadline = time.time() + 10.0
    while True:
        text = metrics.export_prometheus(client)
        lines = [ln for ln in text.splitlines() if ln.startswith("rt_tasks_finished_total")]
        if (lines and float(lines[-1].split()[-1]) >= before + 3) or time.time() > deadline:
            break
        time.sleep(0.2)
    for series in grafana.CORE_SERIES:
        assert series in text, f"{series} missing from exposition"
    line = [ln for ln in text.splitlines() if ln.startswith("rt_tasks_finished_total")][-1]
    assert float(line.split()[-1]) >= before + 3


@pytest.mark.parametrize("pkg", PKGS, **ids)
def test_grafana_serving_row_queries_catalog_metrics(pkg):
    """Every serving panel queries a cataloged rt_llm_* metric."""
    _, grafana, _, telemetry = _mods(pkg)
    dash = json.loads(grafana.grafana_dashboard_json())
    serving = [p for p in dash["panels"] if p["title"].startswith("Serving:")]
    assert len(serving) >= 8
    for p in serving:
        assert p["type"] == "timeseries" and p["targets"]
        for t in p["targets"]:
            assert any(name in t["expr"] for name in telemetry.METRICS), (p["title"], t["expr"])
    titles = [p["title"] for p in serving]
    assert any("first token" in t for t in titles) and any("inter-token" in t for t in titles)


# ---------------------------------------------------------------- the comparisons
def _keys(obj):
    """The shape of a JSON value: a dict's sorted keys, a list's first item's."""
    if isinstance(obj, dict):
        return sorted(obj)
    if isinstance(obj, list):
        return ["list", _keys(obj[0]) if obj else None]
    return type(obj).__name__


def test_routes_json_keys_match(both):
    """Each route's JSON has ray_tpu's keys, on the same workload."""
    shapes = {}
    for pkg in PKGS:
        dashboard, _, _, _ = _mods(pkg)
        pkg.get(pkg.remote(defs.nop).remote(), timeout=T)
        dash = dashboard.start_dashboard(port=0)
        try:
            shapes[pkg] = {r: _keys(json.loads(_get(f"{dash.url}{r}")))
                           for r in ("/api/cluster", "/api/nodes", "/api/actors", "/api/tasks", "/api/pgs",
                                     "/api/objects", "/api/jobs")}
            shapes[pkg]["/api/stacks"] = {tuple(sorted(v)) for v in json.loads(_get(f"{dash.url}/api/stacks")).values()}
            page = _get(f"{dash.url}/").decode()
            shapes[pkg]["routes in the page"] = sorted({x.split('")')[0] for x in page.split('j("')[1:]})
        finally:
            dash.stop()
    j, t = shapes[ray_tpu], shapes[ray_tpu_torch]
    assert j == t, {k: (j[k], t[k]) for k in j if j[k] != t[k]}


def test_grafana_queries_match(both):
    """Every panel of ray_tpu's dashboard, with its queries, is the port's;
    one legend differs on purpose (the collective's wire is no ICI)."""
    panels = {}
    for pkg in PKGS:
        _, grafana, _, _ = _mods(pkg)
        dash = json.loads(grafana.grafana_dashboard_json())
        # the hand-built panels: the registered metrics' own panels query no rt_ series
        panels[pkg] = [(p["title"], p["gridPos"], [(t["expr"], t["legendFormat"]) for t in p["targets"]])
                       for p in dash["panels"] if all("rt_" in t["expr"] for t in p["targets"])]
    j, t = panels[ray_tpu], panels[ray_tpu_torch]
    assert [p[0] for p in j] == [p[0] for p in t] and len(j) >= 18
    for (title, pos, tj), (_, pos_t, tt) in zip(j, t):
        assert pos == pos_t and [e for e, _ in tj] == [e for e, _ in tt], title
        legends = [(a, b) for (_, a), (_, b) in zip(tj, tt) if a != b]
        assert legends == ([("ICI B/s", "wire B/s")] if title == "Serving: collective wire" else []), title


def test_the_page_counts_the_card_as_gpu(both):
    """The port's overview page reads the card as ``"GPU"``; ray_tpu's
    reads ``"TPU"`` chips."""
    from ray_tpu.dashboard.dashboard import _PAGE as jpage
    from ray_tpu_torch.dashboard.dashboard import _PAGE as tpage

    assert "res.GPU" in tpage and "res.TPU" not in tpage and "GPUs in use" in tpage
    assert "res.TPU" in jpage
    norm = (tpage.replace("ray_tpu_torch dashboard", "ray_tpu dashboard").replace("gpu", "tpu").replace("GPUs in use",
                                                                                                      "TPU chips in use")
            .replace("GPU", "TPU"))
    assert norm == jpage
