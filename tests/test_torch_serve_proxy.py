"""Serve's HTTP ingress on the port's runtime against ray_tpu's, on the
CPU: every case of ``tests/test_async_proxy.py`` (keep-alive with
lowercase framing headers, 100 concurrent streaming connections, 504 on
timeout, 404 for an unknown route) and the HTTP cases of
``tests/test_serve.py`` and ``tests/test_serve_v2.py`` (a JSON body and
query parameters end to end, a stream through the proxy), each through
both proxies (the asyncio one, ``HTTPOptions.async_proxy=True``, and the
stdlib thread-per-connection one) and on both runtimes, with the same
statuses and bodies. Then the route table's refresh, where the port
differs from ray_tpu on purpose: a burst of requests for a route being
added, and a controller that does not answer.

One runtime of each package for the module; each test starts its proxy on
a free port (``HTTPOptions(port=0)``) and stops it, and deletes its apps.
The deployments live in ``tests/torch_serve_defs.py``."""

import asyncio
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch_serve_defs as defs

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu.serve._proxy as jproxy
import ray_tpu_torch
import ray_tpu_torch.serve as tserve
import ray_tpu_torch.serve._proxy as tproxy

T = 60
PKGS = (ray_tpu, ray_tpu_torch)
SERVE = {ray_tpu: jserve, ray_tpu_torch: tserve}
KINDS = ("async", "sync")


def wait_until(cond, timeout_s: float = 20.0, every_s: float = 0.1) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(every_s)
    return cond()


@pytest.fixture(scope="module")
def both():
    for pkg in PKGS:
        SERVE[pkg].shutdown()
        pkg.shutdown()
    for pkg in PKGS:
        pkg.init(num_cpus=8)
    yield
    for pkg in PKGS:
        SERVE[pkg].shutdown()
        pkg.shutdown()


def stop_proxy(pkg):
    api = SERVE[pkg].api
    if api._http_proxy is not None:
        api._http_proxy.stop()
        api._http_proxy = None


@pytest.fixture
def proxies(both):
    """-> start(pkg, kind): that package's proxy of that kind on a free
    port; stopped, and every app deleted, after the test."""

    def start(pkg, kind):
        stop_proxy(pkg)
        SERVE[pkg].start(SERVE[pkg].HTTPOptions(port=0, async_proxy=kind == "async"), proxy=True)
        return SERVE[pkg].api._http_proxy.port

    yield start
    for pkg in PKGS:
        stop_proxy(pkg)
        serve = SERVE[pkg]
        for name in list(serve.status()["applications"]):
            serve.delete(name)
        assert wait_until(lambda: pkg.available_resources().get("CPU", 0) == 8, timeout_s=30)


def same(fn):
    """``fn`` on each runtime, the two at once: their results must be equal."""
    with ThreadPoolExecutor(2) as pool:
        a, b = (f.result(timeout=300) for f in [pool.submit(fn, pkg) for pkg in PKGS])
    assert a == b, (a, b)
    return a


async def _raw_request(port, payload: bytes, path="/", lowercase=False, reuse=None):
    if reuse is None:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    else:
        reader, writer = reuse
    cl = b"content-length" if lowercase else b"Content-Length"
    writer.write(b"POST " + path.encode() + b" HTTP/1.1\r\nHost: x\r\n" + cl + b": " + str(len(payload)).encode()
                 + b"\r\n\r\n" + payload)
    await writer.drain()
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=T)
    status = int(head.split(b" ", 2)[1])
    n = 0
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"content-length:"):
            n = int(ln.split(b":")[1])
    body = await asyncio.wait_for(reader.readexactly(n), timeout=T)
    return status, body, (reader, writer)


# ---------------------------------------------------------------- test_async_proxy.py
@pytest.mark.parametrize("kind", KINDS)
def test_keepalive_and_lowercase_headers(proxies, kind):
    def case(pkg):
        port = proxies(pkg, kind)
        SERVE[pkg].run(SERVE[pkg].deployment(defs.EchoJson).bind(), name="echo_app", route_prefix="/echo")

        async def drive():
            first = await _raw_request(port, json.dumps({"a": 1}).encode(), "/echo")
            # the SAME connection, lowercase framing headers
            second = await _raw_request(port, json.dumps({"b": 2}).encode(), "/echo", lowercase=True, reuse=first[2])
            second[2][1].close()
            return [(s, json.loads(b)) for s, b, _ in (first, second)]

        return asyncio.run(drive())

    assert same(case) == [(200, {"got": {"a": 1}}), (200, {"got": {"b": 2}})]


@pytest.mark.parametrize("kind", KINDS)
def test_concurrent_streaming_connections(proxies, kind):
    def case(pkg):
        port = proxies(pkg, kind)
        if pkg is ray_tpu and kind == "sync":
            # ray_tpu's stdlib proxy listens with socketserver's backlog of 5, the port's with 128: give
            # ray_tpu's socket the same backlog, so that 100 simultaneous connects compare the proxies and
            # not the kernel's SYN retransmits
            SERVE[pkg].api._http_proxy._server.socket.listen(128)
        SERVE[pkg].run(SERVE[pkg].deployment(defs.StreamFive).options(max_ongoing_requests=300).bind(),
                       name="stream_load", route_prefix="/gen")
        # one request first: the proxy's route table learns /gen before the burst
        with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/gen",
                                                           headers={"X-Serve-Stream": "1"}), timeout=30) as resp:
            resp.read()

        async def one(latencies):
            t0 = time.perf_counter()
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /gen HTTP/1.1\r\nHost: x\r\nAccept: text/event-stream\r\n\r\n")
            await writer.drain()
            await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=T)
            body = b""
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=T)
                n = int(line.strip() or b"0", 16)
                if n == 0:
                    break
                body += await reader.readexactly(n)
                await reader.readexactly(2)
            writer.close()
            latencies.append(time.perf_counter() - t0)
            return body

        async def drive():
            lat: list = []
            bodies = await asyncio.gather(*[one(lat) for _ in range(100)])
            lat.sort()
            return len(lat), set(bodies), lat[99] < 30.0

        return asyncio.run(drive())

    assert same(case) == (100, {b"t0 t1 t2 t3 t4 "}, True)


@pytest.mark.parametrize("kind", KINDS)
def test_timeout_responds_504(proxies, kind):
    def case(pkg):
        port = proxies(pkg, kind)
        proxy = SERVE[pkg].api._http_proxy
        # a short graceful stop: the replica sleeps 30 s in its thread
        d = SERVE[pkg].deployment(defs.SleepsThirty).options(graceful_shutdown_timeout_s=0.5)
        SERVE[pkg].run(d.bind(), name="slow_http", route_prefix="/slow")
        proxy._opts.request_timeout_s = 1.0

        async def drive():
            status, body, conn = await _raw_request(port, b"{}", "/slow")
            conn[1].close()
            return status

        return asyncio.run(drive())

    assert same(case) == 504


@pytest.mark.parametrize("kind", KINDS)
def test_unknown_route_404(proxies, kind):
    def case(pkg):
        port = proxies(pkg, kind)

        async def drive():
            status, body, conn = await _raw_request(port, b"{}", "/nothing-here")
            conn[1].close()
            return status, json.loads(body)

        return asyncio.run(drive())

    assert same(case) == (404, {"error": "no route for /nothing-here"})


# ---------------------------------------------------------------- the route table: a difference kept on purpose
def burst_lookups(table, path: str, n: int = 16) -> int:
    """``n`` requests' route lookups at once, as both proxies make them (a
    periodic refresh, a match, and on a miss one forced refresh and a match
    again); -> how many found no route, which the proxy answers with 404."""
    barrier = threading.Barrier(n)

    def lookup(_):
        barrier.wait(timeout=T)
        table._refresh_routes()
        handle, _prefix = table._match(path)
        if handle is None:
            table._refresh_routes(force=True)
            handle, _prefix = table._match(path)
        return handle is None

    with ThreadPoolExecutor(n) as pool:
        return sum(pool.map(lookup, range(n)))


@pytest.mark.parametrize("pkg", PKGS, ids=("ray_tpu", "ray_tpu_torch"))
def test_route_refresh_race_in_a_burst(both, pkg):
    """16 requests at once for a route the table does not know yet, while
    the controller takes 0.3 s to list the applications. ray_tpu stamps the
    refresh before it fetches, so the requests that arrive meanwhile skip
    it, and their forced refresh is inside its 0.25 s limit: they answer
    404. The port's requests wait for the refresh in flight and find the
    route."""
    controller = pkg.remote(defs.SlowRoutes).remote(0.3)
    table = {ray_tpu: jproxy, ray_tpu_torch: tproxy}[pkg].RouteTableMixin()
    table._init_routes(controller)
    try:
        misses = burst_lookups(table, "/new/x")
    finally:
        pkg.kill(controller)
    if pkg is ray_tpu:
        assert misses > 0
    else:
        assert misses == 0


def test_route_refresh_gives_up_on_a_stalled_controller(both, monkeypatch):
    """The port's refresh waits ``ROUTES_TIMEOUT_S`` for the controller at
    most and keeps the table it had, so a controller that does not answer
    holds a request that long and no longer."""
    monkeypatch.setattr(tproxy, "ROUTES_TIMEOUT_S", 0.3)
    controller = ray_tpu_torch.remote(defs.SlowRoutes).remote(5.0)
    table = tproxy.RouteTableMixin()
    table._init_routes(controller)
    try:
        t0 = time.perf_counter()
        misses = burst_lookups(table, "/new/x", n=4)
        took = time.perf_counter() - t0
    finally:
        ray_tpu_torch.kill(controller)
    assert misses == 4 and table._routes == {} and took < 3.0


@pytest.mark.parametrize("kind", KINDS)
def test_new_route_burst_without_warmup(proxies, kind):
    """A route deployed just now, then 32 requests to it at once with none
    before them: the port's proxy answers every one with 200 (ray_tpu's
    refresh race answers some with 404: the test above)."""
    port = proxies(ray_tpu_torch, kind)
    tserve.run(tserve.deployment(defs.EchoJson).bind(), name="echo_app", route_prefix="/echo")

    async def drive():
        got = await asyncio.gather(*[_raw_request(port, json.dumps({"i": i}).encode(), "/echo") for i in range(32)])
        for _status, _body, conn in got:
            conn[1].close()
        return [(s, json.loads(b)) for s, b, _ in got]

    assert asyncio.run(drive()) == [(200, {"got": {"i": i}}) for i in range(32)]


# ---------------------------------------------------------------- test_serve.py and test_serve_v2.py
@pytest.mark.parametrize("kind", KINDS)
def test_http_proxy_end_to_end(proxies, kind):
    def case(pkg):
        port = proxies(pkg, kind)
        SERVE[pkg].run(SERVE[pkg].deployment(defs.Api).bind(), name="api", route_prefix="/api")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/sum", data=json.dumps({"xs": [1, 2, 3]}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            summed = json.loads(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/echo?a=1", timeout=30) as resp:
            echoed = json.loads(resp.read())
        return summed, echoed

    assert same(case) == ({"sum": 6}, {"path": "/echo", "q": {"a": "1"}})


@pytest.mark.parametrize("kind", KINDS)
def test_streaming_through_http_proxy(proxies, kind):
    def case(pkg):
        SERVE[pkg].run(SERVE[pkg].deployment(defs.SSE).bind(), name="sse", route_prefix="/sse")
        port = proxies(pkg, kind)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/sse", headers={"X-Serve-Stream": "1"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read().decode()

    assert same(case) == "tok0tok1tok2tok3"
