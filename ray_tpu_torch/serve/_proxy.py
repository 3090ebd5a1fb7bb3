"""HTTP proxy: routes HTTP requests to application ingress deployments
(port of ray_tpu/serve/_proxy.py).

A threaded stdlib HTTP server (one thread per connection) living in the
driver (or any) process: routes
refresh from the controller's application table; each request becomes a
handle call with a Request object, longest-prefix route match.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle


@dataclass
class Request:
    """Minimal HTTP request surface passed to ingress __call__ (the part
    of a web framework's request that user code needs)."""

    method: str
    path: str
    query_params: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body or b"null")

    @property
    def text(self) -> str:
        return self.body.decode()


ROUTES_TIMEOUT_S = 5.0  # a route refresh's wait for the controller; past it the table stays as it was


class RouteTableMixin:
    """Controller route table shared by the sync and async proxies: cached
    refresh (one controller round-trip per interval; forced refreshes on
    route miss are rate-limited too, or a 404 scanner would reintroduce a
    controller RTT per request) + longest-prefix match.

    One refresh runs at a time. A periodic refresh that finds one in
    flight skips it; a forced one (a route miss) waits for it, since it
    may add the missing route (ray_tpu's stamp-then-fetch skips it and
    answers 404 for a route being added). The fetch waits at most
    ``ROUTES_TIMEOUT_S``: a slow controller keeps the old table until the
    next interval instead of holding every request."""

    def _init_routes(self, controller):
        self._controller = controller
        self._routes: dict[str, DeploymentHandle] = {}
        self._routes_lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._routes_at = 0.0

    def _refresh_routes(self, force: bool = False):
        interval = 0.25 if force else 1.0
        if time.time() - self._routes_at < interval:
            return
        if not self._refresh_lock.acquire(blocking=force, timeout=ROUTES_TIMEOUT_S if force else -1):
            return
        try:
            if time.time() - self._routes_at < interval:
                return  # the refresh this one waited for
            try:
                apps = ray_tpu_torch.get(self._controller.list_applications.remote(), timeout=ROUTES_TIMEOUT_S)
            except ray_tpu_torch.exceptions.GetTimeoutError:
                self._routes_at = time.time()
                return
            with self._routes_lock:
                known = set(self._routes)
                for app_name, info in apps.items():
                    prefix = info.get("route_prefix") or "/"
                    if prefix not in known:
                        self._routes[prefix] = DeploymentHandle(self._controller, app_name, info["ingress"])
                for prefix in known - {info.get("route_prefix") or "/" for info in apps.values()}:
                    del self._routes[prefix]
            self._routes_at = time.time()
        finally:
            self._refresh_lock.release()

    def _match(self, path: str) -> tuple[DeploymentHandle | None, str]:
        with self._routes_lock:
            best = None
            best_prefix = ""
            for prefix, handle in self._routes.items():
                p = prefix.rstrip("/")
                if (path == p or path.startswith(p + "/") or prefix == "/") and len(prefix) > len(best_prefix):
                    best, best_prefix = handle, prefix
            return best, best_prefix


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 (ray_tpu's) overflows
    # under a burst of connects, and the overflow waits on SYN retransmits
    request_queue_size = 128


class HTTPProxy(RouteTableMixin):
    def __init__(self, controller, http_options):
        self._init_routes(controller)
        self._opts = http_options
        self._server: ThreadingHTTPServer | None = None
        self._stop = threading.Event()

    # -- server --

    def start(self):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _handle(self):
                try:
                    proxy._refresh_routes()
                    parsed = urlparse(self.path)
                    handle, prefix = proxy._match(parsed.path)
                    if handle is None:
                        # route may be new: force one refresh before 404ing
                        proxy._refresh_routes(force=True)
                        handle, prefix = proxy._match(parsed.path)
                    if handle is None:
                        self._respond(404, {"error": f"no route for {parsed.path}"})
                        return
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    body = self.rfile.read(n) if n else b""
                    sub_path = parsed.path[len(prefix.rstrip("/")):] or "/"
                    req = Request(
                        method=self.command,
                        path=sub_path,
                        query_params={k: v[0] for k, v in parse_qs(parsed.query).items()},
                        headers=dict(self.headers.items()),
                        body=body,
                    )
                    timeout = proxy._opts.request_timeout_s
                    if self._wants_stream(req):
                        self._stream(handle.options(stream=True).remote(req), timeout)
                        return
                    resp = handle.remote(req)
                    try:
                        result = resp.result(timeout_s=timeout)
                    except ray_tpu_torch.exceptions.GetTimeoutError:
                        resp.cancel()  # deadline is final at the proxy
                        self._respond(504, {"error": f"request exceeded {timeout}s"})
                        return
                    self._respond(200, result)
                except Exception as e:  # noqa: BLE001
                    from ray_tpu_torch.serve.overload import http_error_of

                    mapped = http_error_of(e)
                    if mapped is not None:
                        # typed serving errors carry their own status:
                        # OverloadedError/ReplicaDrainingError -> 429 with
                        # a retry-after hint instead of a generic 500
                        self._respond(mapped[0], mapped[1])
                        return
                    import traceback as _tb

                    self._respond(500, {"error": repr(e), "trace": _tb.format_exc()})

            def _wants_stream(self, req: Request) -> bool:
                accept = req.headers.get("Accept", "") or req.headers.get("accept", "")
                if "text/event-stream" in accept or req.headers.get("X-Serve-Stream") == "1":
                    return True
                # OpenAI-style bodies signal streaming in JSON, not
                # headers — but only sniff on the OpenAI endpoints, so an
                # unrelated deployment whose schema has a top-level
                # "stream" field keeps its unary framing
                if req.path.endswith(("/completions", "/chat/completions")) and req.body[:1] == b"{" and b'"stream"' in req.body:
                    try:
                        return req.json().get("stream") is True
                    except ValueError:
                        return False
                return False

            def _stream(self, gen, timeout):
                """Chunked transfer: one chunk per yielded item. The FIRST
                item is fetched before the 200 header commits, so an
                ingress that sheds (OverloadedError) or errors at
                admission still gets its typed status (429 + retry-after)
                instead of a fake 200. Errors and timeouts AFTER the 200
                header abort the connection WITHOUT the chunked
                terminator — a truncated stream is the only honest error
                signal once streaming began; a clean terminator would
                make partial output look complete (and a second response
                would desync HTTP/1.1 keep-alive)."""
                import itertools

                def cancel():
                    # every failure path must abort the admitted
                    # generation (the unary path's resp.cancel()), or the
                    # abandoned request holds a batch slot generating
                    # tokens nobody consumes — inflating host_load()
                    # occupancy and shedding real traffic
                    try:
                        gen.cancel()
                    except Exception:  # noqa: BLE001
                        pass

                deadline = time.time() + timeout if timeout else None
                it = iter(gen)
                exhausted = False
                try:
                    if deadline is not None:
                        gen.item_timeout_s = max(deadline - time.time(), 0.01)
                    first = next(it)
                    it = itertools.chain([first], it)
                except StopIteration:
                    exhausted = True
                except ray_tpu_torch.exceptions.GetTimeoutError:
                    # same deadline classification as the unary path: a
                    # first-token timeout is a 504, not a server fault
                    cancel()
                    self._respond(504, {"error": f"request exceeded {timeout}s"})
                    return
                except Exception as e:  # noqa: BLE001
                    from ray_tpu_torch.serve.overload import http_error_of

                    cancel()
                    mapped = http_error_of(e)
                    if mapped is not None:
                        self._respond(mapped[0], mapped[1])
                        return
                    import traceback as _tb

                    self._respond(500, {"error": repr(e), "trace": _tb.format_exc()})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                clean = exhausted  # an empty stream terminates cleanly
                try:
                    while not exhausted:
                        if deadline is not None:
                            remaining = deadline - time.time()
                            if remaining <= 0:
                                break  # unclean abort below
                            gen.item_timeout_s = remaining
                        try:
                            item = next(it)
                        except StopIteration:
                            clean = True
                            break
                        if isinstance(item, (bytes, bytearray)):
                            data = bytes(item)
                        elif isinstance(item, str):
                            data = item.encode()
                        else:
                            data = (json.dumps(item) + "\n").encode()
                        chunk(data)
                except Exception:  # noqa: BLE001  (incl. GetTimeoutError)
                    clean = False
                finally:
                    if clean:
                        try:
                            self.wfile.write(b"0\r\n\r\n")
                            self.wfile.flush()
                        except OSError:
                            pass
                    else:
                        cancel()  # post-header abort: same slot-leak rule
                        self.close_connection = True

            def _respond(self, code: int, payload):
                if isinstance(payload, (bytes, bytearray)):
                    data, ctype = bytes(payload), "application/octet-stream"
                elif isinstance(payload, str):
                    data, ctype = payload.encode(), "text/plain"
                else:
                    data, ctype = json.dumps(payload).encode(), "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                if code == 429 and isinstance(payload, dict) and payload.get("retry_after_s"):
                    # the STANDARD backoff header: off-the-shelf clients /
                    # load balancers honor Retry-After, not our body field
                    import math

                    self.send_header("Retry-After", str(max(1, math.ceil(float(payload["retry_after_s"])))))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        self._server = _Server((self._opts.host, self._opts.port), Handler)
        if self._opts.port == 0:
            self._opts.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, name="serve-http-proxy", daemon=True)
        t.start()
        return self._opts.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def port(self) -> int:
        return self._opts.port
