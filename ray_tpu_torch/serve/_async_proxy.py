"""Asyncio HTTP ingress: keep-alive, streaming backpressure, O(1) threads
(port of ray_tpu/serve/_async_proxy.py).

A raw asyncio.start_server loop (no third-party server): an HTTP/1.1
parser, longest-prefix route match against the controller's application
table, unary requests awaited via seal callbacks (zero blocked threads),
and streaming responses chunk-written with `await drain()` so a slow
client backpressures its own stream instead of buffering unboundedly.
The event loop runs on one daemon thread; handle SUBMISSION (router
locks, admission) runs in a small executor; WAITING costs no threads
(serve/_async_bridge.py).

The stdlib ThreadingHTTPServer proxy (_proxy.py) remains available via
HTTPOptions(async_proxy=False).
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from urllib.parse import parse_qs, urlparse

import ray_tpu_torch
from ray_tpu_torch.serve._async_bridge import aiter_stream, result_async
from ray_tpu_torch.serve._proxy import Request, RouteTableMixin

_MAX_HEADER = 64 << 10
_MAX_BODY = 512 << 20


class _HTTPError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class AsyncHTTPProxy(RouteTableMixin):
    def __init__(self, controller, http_options):
        self._init_routes(controller)
        self._opts = http_options
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()

    # -- lifecycle --
    def start(self) -> int:
        self._thread = threading.Thread(target=self._run_loop, name="serve-async-proxy", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30.0):
            raise RuntimeError("async proxy failed to start")
        return self._opts.port

    def _run_loop(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._serve())

    async def _serve(self):
        self._server = await asyncio.start_server(self._handle_conn, self._opts.host, self._opts.port)
        if self._opts.port == 0:
            self._opts.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

    def stop(self):
        if self._loop is not None:

            def _shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            self._loop = None
            self._server = None

    @property
    def port(self) -> int:
        return self._opts.port

    # -- connection handling --
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:  # HTTP/1.1 keep-alive: many requests per connection
                try:
                    req, keep_alive = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                except _HTTPError as e:
                    await self._respond(writer, e.code, {"error": str(e)}, close=True)
                    return
                if req is None:
                    return
                try:
                    close = await self._dispatch(req, writer) or not keep_alive
                except (ConnectionError, asyncio.CancelledError):
                    return
                except Exception as e:  # noqa: BLE001
                    from ray_tpu_torch.serve.overload import http_error_of

                    mapped = http_error_of(e)  # typed 429s keep their status
                    try:
                        if mapped is not None:
                            await self._respond(writer, mapped[0], mapped[1])
                        else:
                            await self._respond(writer, 500, {"error": repr(e)})
                    except ConnectionError:
                        return
                    close = not keep_alive
                if close:
                    return
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader) -> tuple[Request | None, bool]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise _HTTPError(431, "headers too large") from None
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None, False  # clean keep-alive close
            raise
        if len(head) > _MAX_HEADER:
            raise _HTTPError(431, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            raise _HTTPError(400, "bad request line") from None
        headers = {}
        lower = {}  # case-insensitive view for request framing
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers[k.strip()] = v.strip()
            lower[k.strip().lower()] = v.strip()
        n = int(lower.get("content-length", 0) or 0)
        if n > _MAX_BODY:
            raise _HTTPError(413, "body too large")
        body = await reader.readexactly(n) if n else b""
        keep_alive = lower.get("connection", "").lower() != "close" and version != "HTTP/1.0"
        parsed = urlparse(target)
        req = Request(
            method=method,
            path=parsed.path,
            query_params={k: v[0] for k, v in parse_qs(parsed.query).items()},
            headers=headers,
            body=body,
        )
        return req, keep_alive

    def _wants_stream(self, req: Request) -> bool:
        # header NAMES are case-insensitive (RFC 9110); Request preserves
        # wire case for user code, so scan case-insensitively here
        lower = {k.lower(): v for k, v in req.headers.items()}
        if "text/event-stream" in lower.get("accept", "") or lower.get("x-serve-stream") == "1":
            return True
        if req.path.endswith(("/completions", "/chat/completions")) and req.body[:1] == b"{" and b'"stream"' in req.body:
            try:
                return req.json().get("stream") is True
            except ValueError:
                return False
        return False

    async def _dispatch(self, req: Request, writer) -> bool:
        """Returns True if the connection must close (aborted stream)."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._refresh_routes)
        handle, prefix = self._match(req.path)
        if handle is None:
            await loop.run_in_executor(None, self._refresh_routes, True)
            handle, prefix = self._match(req.path)
        if handle is None:
            await self._respond(writer, 404, {"error": f"no route for {req.path}"})
            return False
        req.path = req.path[len(prefix.rstrip("/")):] or "/"
        timeout = self._opts.request_timeout_s
        if self._wants_stream(req):
            gen = await loop.run_in_executor(None, handle.options(stream=True).remote, req)
            return await self._stream(writer, gen, timeout)
        resp = await loop.run_in_executor(None, handle.remote, req)
        try:
            result = await result_async(resp, timeout_s=timeout)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            resp.cancel()
            await self._respond(writer, 504, {"error": f"request exceeded {timeout}s"})
            return False
        await self._respond(writer, 200, result)
        return False

    async def _stream(self, writer, gen, timeout) -> bool:
        """Chunked streaming with drain() backpressure. The FIRST item is
        fetched before the 200 header commits, so a shed (OverloadedError
        -> 429 + retry-after) or admission error keeps its typed status.
        As in the sync proxy, an error AFTER the 200 header aborts
        WITHOUT the chunked terminator — truncation is the only honest
        mid-stream error."""
        # the whole-request deadline starts at stream OPEN (matching the
        # sync proxy): TTFT spends from the same budget as the body
        deadline = time.time() + timeout if timeout else None
        ait = aiter_stream(gen, item_timeout_s=timeout).__aiter__()
        exhausted = False
        first = None
        have_first = False
        try:
            first = await ait.__anext__()
            have_first = True
        except StopAsyncIteration:
            exhausted = True
        except asyncio.CancelledError:
            raise
        except ray_tpu_torch.exceptions.GetTimeoutError:
            # same deadline classification as the unary path: a
            # first-token timeout is a 504, not a server fault. The
            # remote generation was already admitted — cancel it, as the
            # mid-stream abort path does, or the abandoned request holds
            # a slot generating tokens nobody consumes.
            self._cancel_stream(gen)
            try:
                await self._respond(writer, 504, {"error": f"request exceeded {timeout}s"})
            except ConnectionError:
                return True
            return False
        except Exception as e:  # noqa: BLE001
            from ray_tpu_torch.serve.overload import http_error_of

            self._cancel_stream(gen)
            mapped = http_error_of(e)
            try:
                if mapped is not None:
                    await self._respond(writer, mapped[0], mapped[1])
                else:
                    await self._respond(writer, 500, {"error": repr(e)})
            except ConnectionError:
                return True
            return False
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/octet-stream\r\nTransfer-Encoding: chunked\r\n\r\n"
        )
        clean = exhausted  # an empty stream terminates cleanly

        def _encode(item) -> bytes:
            if isinstance(item, (bytes, bytearray)):
                return bytes(item)
            if isinstance(item, str):
                return item.encode()
            return (json.dumps(item) + "\n").encode()

        try:
            while not exhausted:
                if deadline is not None and time.time() > deadline:
                    break  # unclean abort below
                if have_first:
                    item, have_first = first, False
                else:
                    try:
                        item = await ait.__anext__()
                    except StopAsyncIteration:
                        clean = True
                        break
                data = _encode(item)
                writer.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                await writer.drain()  # slow client backpressures HERE
        except (Exception, asyncio.CancelledError):  # noqa: BLE001
            clean = False
        if clean:
            try:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            except ConnectionError:
                return True
            return False
        self._cancel_stream(gen)
        return True  # aborted: close so the client sees truncation

    @staticmethod
    def _cancel_stream(gen) -> None:
        """Abort the remote generation behind an abandoned stream (every
        failure path — pre- and post-header — must cancel, or the request
        keeps its slot generating tokens nobody consumes)."""
        try:
            gen.cancel()
        except Exception:  # noqa: BLE001
            pass

    async def _respond(self, writer, code: int, payload, close: bool = False):
        if isinstance(payload, (bytes, bytearray)):
            data, ctype = bytes(payload), "application/octet-stream"
        elif isinstance(payload, str):
            data, ctype = payload.encode(), "text/plain"
        else:
            data, ctype = json.dumps(payload).encode(), "application/json"
        reason = {200: "OK", 404: "Not Found", 413: "Payload Too Large", 429: "Too Many Requests", 431: "Headers Too Large", 500: "Internal Server Error", 504: "Gateway Timeout"}.get(code, "")
        extra = b""
        if code == 429 and isinstance(payload, dict) and payload.get("retry_after_s"):
            # the STANDARD backoff header: off-the-shelf clients / load
            # balancers honor Retry-After, not our body field
            import math

            extra = f"Retry-After: {max(1, math.ceil(float(payload['retry_after_s'])))}\r\n".encode()
        conn = b"Connection: close\r\n" if close else b""
        writer.write(
            f"HTTP/1.1 {code} {reason}\r\nContent-Type: {ctype}\r\nContent-Length: {len(data)}\r\n".encode()
            + extra
            + conn
            + b"\r\n"
            + data
        )
        await writer.drain()
