"""The node agent (port of ray_tpu/core/node_agent.py): one node's
manager as a process of its own.

The agent dials the head's ``AgentListener`` over authenticated TCP (the
same path for an agent the head started on its host and for ``rt agent``
on another host) and then:

- forks and kills the node's workers when the head asks, from a zygote of
  its own (``core/node.py``), a card-bound one with the
  ``CUDA_VISIBLE_DEVICES`` the head chose set before it starts; the agent
  never initialises CUDA and imports neither jax, nor ray_tpu, nor the
  driver's script;
- relays frames between the head's socket and its workers' pipes as
  pickled bytes it does not read (a value of a class only the driver
  knows cannot break the agent), tagged with the worker's id;
- reports a worker's death once its process has exited;
- answers the head's pings (its health loop declares the node dead after
  ``health_check_failure_threshold`` missed periods);
- serves the segments of its shm namespace to other nodes
  (``ObjectTransferServer``) and pulls foreign segments into it for its
  workers (``fetch_object``), asking the head which node serves a
  namespace (``_NsResolver``) and keeping the pulled copies within the
  store's budget (``_FetchCache``).

Head -> agent: ``start_worker`` {wid, env}, ``to_worker`` {wid, data},
``kill_worker`` {wid, report}, ``ping`` {seq}, ``ns_addr`` {ns, addr},
``free_shm`` {name}, ``shutdown``. Agent -> head: ``agent_ready``
{node_id, pid, transfer_addr, ns, resources, labels}, ``from_worker``
{wid, data}, ``worker_started`` {wid, pid}, ``worker_death`` {wid,
reason}, ``resolve_ns`` {ns}, ``pong`` {seq}. A worker's requests to the
agent (``fetch_object``) start with ``AGENT_FRAME``, a byte no pickle
starts with, and are answered here on its pipe; every other frame is the
head's and is relayed unread.

Run by the head as ``python -m ray_tpu_torch.core.node_agent`` with its
arguments pickled on standard input; ``standalone_agent_main`` is the
entry of ``rt agent`` (``scripts/cli.py``).
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from multiprocessing import connection as mp_connection

# seconds the agent gives a worker to exit after it was asked to, before SIGKILL
_REAP_S = 5.0
# the first byte of a worker's request to its agent; a pickle starts with 0x80
AGENT_FRAME = b"\x01"
# set in the agent's workers: their agent requests carry AGENT_FRAME
AGENT_ENV = "RT_NODE_AGENT"


class _NsResolver:
    """shm namespace -> the transfer address that serves it, asked of the
    head (the directory) once per namespace."""

    def __init__(self, send_head):
        self._send_head = send_head
        self._lock = threading.Lock()
        self._cache: dict[str, tuple | None] = {}
        self._events: dict[str, threading.Event] = {}

    def deliver(self, ns: str, addr):
        with self._lock:
            self._cache[ns] = tuple(addr) if addr else None
            ev = self._events.pop(ns, None)
        if ev:
            ev.set()

    def resolve(self, ns: str, timeout: float = 30.0):
        with self._lock:
            if ns in self._cache:
                return self._cache[ns]
            ev = self._events.get(ns)
            ask = ev is None
            if ask:
                ev = self._events[ns] = threading.Event()
        if ask:
            self._send_head({"type": "resolve_ns", "ns": ns})
        ok = ev.wait(timeout)
        with self._lock:
            if not ok and self._events.get(ns) is ev:
                # the reply was lost: the next resolve asks again
                del self._events[ns]
            return self._cache.get(ns)

    def invalidate(self, ns: str):
        with self._lock:
            self._cache.pop(ns, None)


class _FetchCache:
    """The foreign segments pulled into this node's namespace, oldest
    evicted first past the budget (a copy is a cache: a lost one is pulled
    again, or its object rebuilt)."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._entries: dict[str, int] = {}  # name -> size, in insertion order

    def add(self, name: str, size: int):
        with self._lock:
            self._entries.pop(name, None)  # a re-add is the most recent
            self._entries[name] = size
            total = sum(self._entries.values())
            victims = []
            for n, s in list(self._entries.items()):
                if total <= self.budget:
                    break
                if n == name:
                    continue  # never the entry just installed
                victims.append(n)
                total -= s
                del self._entries[n]
        for n in victims:
            _unlink(n)

    def drop(self, name: str):
        with self._lock:
            self._entries.pop(name, None)


def _unlink(name: str):
    try:
        os.unlink("/dev/shm/" + name)
    except OSError:
        pass


def agent_entry(address, authkey: bytes, node_id_hex: str, env: dict, transfer_authkey: bytes = b"",
                resources: dict | None = None, reconnect_s: float = 0.0, labels: dict | None = None, main=None,
                worker_tag: str | None = None):
    """The agent's main loop. ``resources`` and ``labels`` ride every hello,
    so a restarted head on the same port adopts a re-joining agent with
    its capacity. ``reconnect_s`` > 0: on losing the head the agent kills
    its workers (the head lost their tasks) and redials the address for
    that long. ``main``: how its workers import the driver's __main__;
    ``worker_tag``: the tag of their segments (None: this namespace's)."""
    from ray_tpu_torch._config import get_config
    from ray_tpu_torch.core import transport
    from ray_tpu_torch.core.node import fork_worker, stop_zygote
    from ray_tpu_torch.core.object_store import _namespace, _session_tag, local_shm_name

    os.environ.update({k: str(v) for k, v in (env or {}).items()})
    env = dict(env or {})
    my_ns = _namespace()
    address = tuple(address)
    conn = mp_connection.Client(address, authkey=authkey)
    # advertise the interface this agent reaches the head on: other nodes
    # dial it for pulls, and callers its workers' direct servers
    import socket

    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
        my_ip = s.getsockname()[0]
        s.close()
    except OSError:
        my_ip = "127.0.0.1"
    transfer_srv = transport.ObjectTransferServer(transfer_authkey, advertise_host=my_ip,
                                                  allowed_prefixes=(f"rt{_session_tag()}_",))
    env.setdefault("RT_DIRECT_HOST", my_ip)
    env[AGENT_ENV] = "1"

    def send_hello(c):
        c.send({"type": "agent_ready", "node_id": node_id_hex, "pid": os.getpid(), "ns": my_ns,
                "transfer_addr": transfer_srv.address, "resources": resources,
                "labels": labels})

    send_hello(conn)

    workers: dict[str, tuple] = {}  # wid hex -> (process, the agent's end of its pipe)
    lock = threading.Lock()
    send_lock = threading.Lock()
    shutdown = threading.Event()  # for good (no reconnect)
    conn_lost = threading.Event()
    draining = threading.Event()  # a drain of the workers is under way: a racing start reaps itself
    spawn_threads: list = []

    def send_head(msg):
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, EOFError, ValueError):
                conn_lost.set()

    resolver = _NsResolver(send_head)
    fetch_cache = _FetchCache(get_config().object_store_memory)

    def reap(proc):
        proc.join(timeout=_REAP_S)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=_REAP_S)

    def start_worker(wid_hex: str, binding: dict):
        proc, wconn = fork_worker(wid_hex, node_id_hex, {**env, **binding}, main, worker_tag)
        with lock:
            if shutdown.is_set() or draining.is_set():
                # the start raced a drain: the (restarted) head knows nothing of this worker
                proc.terminate()
                reap(proc)
                wconn.close()
                return
            workers[wid_hex] = (proc, wconn)
        send_head({"type": "worker_started", "wid": wid_hex, "pid": proc.pid})

    def reap_worker(wid_hex: str, reason: str, report: bool = True, kill: bool = True):
        with lock:
            entry = workers.pop(wid_hex, None)
        if entry is None:
            return
        proc, wconn = entry
        wconn.close()
        if kill and proc.is_alive():
            proc.terminate()
        # reported once the process is gone: its card's memory is free then
        threading.Thread(target=_reap_and_report, args=(proc, wid_hex, reason, report), daemon=True).start()

    def _reap_and_report(proc, wid_hex, reason, report):
        reap(proc)
        if report:
            send_head({"type": "worker_death", "wid": wid_hex, "reason": reason})

    def fetch_object(wid_hex: str, req_id, desc):
        """Pull a foreign segment into this namespace for a worker; the
        reply goes on the worker's pipe."""
        resp = {"type": "resp", "req_id": req_id, "ok": True, "payload": None, "error": None}
        try:
            if desc.ns == my_ns:
                resp["payload"] = desc.shm_name
            else:
                addr = resolver.resolve(desc.ns)
                if addr is None:
                    raise FileNotFoundError(f"no transfer address for shm namespace {desc.ns!r} (its node is gone)")
                local = local_shm_name(desc)
                try:
                    n = transport.pull_segment(addr, transfer_authkey, desc.shm_name, local)
                except FileNotFoundError:
                    # a stale address after the node restarted: ask once more
                    resolver.invalidate(desc.ns)
                    addr2 = resolver.resolve(desc.ns)
                    if not addr2 or addr2 == addr:
                        raise
                    n = transport.pull_segment(addr2, transfer_authkey, desc.shm_name, local)
                fetch_cache.add(local, n)
                resp["payload"] = local
        except Exception as e:  # noqa: BLE001 — the error goes back to the asking worker
            resp["ok"], resp["error"] = False, e
        with lock:
            entry = workers.get(wid_hex)
        if entry is not None:
            try:
                entry[1].send(resp)
            except (OSError, ValueError, EOFError):
                pass  # the worker is gone: its death is reported by the loop

    def handle_worker_frame(wid: str, data: bytes):
        if data[:1] != AGENT_FRAME:
            send_head({"type": "from_worker", "wid": wid, "data": data})
            return
        try:
            msg = pickle.loads(data[1:])
            method, req_id = msg["method"], msg["req_id"]
        except Exception as e:  # noqa: BLE001 — the worker's request times out; the agent serves on
            print(f"node agent: an unreadable request from worker {wid[:8]}: {e!r}", file=sys.stderr, flush=True)
            return
        if method == "fetch_object":
            threading.Thread(target=fetch_object, args=(wid, req_id, msg["params"]["desc"]), daemon=True,
                             name="rt-agent-fetch").start()
            return
        with lock:
            entry = workers.get(wid)
        if entry is not None:
            entry[1].send({"type": "resp", "req_id": req_id, "ok": False,
                           "error": ValueError(f"unknown agent method {method!r}")})

    def kill_all_workers():
        with lock:
            all_w = list(workers.values())
            workers.clear()
        for proc, wconn in all_w:
            try:
                wconn.send({"type": "shutdown"})
            except (OSError, ValueError):
                pass  # it is exiting already
        for proc, wconn in all_w:
            reap(proc)
            wconn.close()

    while not shutdown.is_set():
        if conn_lost.is_set():
            if reconnect_s <= 0:
                break
            # drain: racing starts reap themselves, in-flight ones are
            # waited out, then every worker goes (the head lost their state)
            draining.set()
            for t in list(spawn_threads):
                t.join(timeout=30.0)
            kill_all_workers()
            resolver = _NsResolver(send_head)  # the old addresses are stale
            new_conn, deadline = None, time.monotonic() + reconnect_s
            while new_conn is None and time.monotonic() < deadline:
                try:
                    new_conn = mp_connection.Client(address, authkey=authkey)
                except OSError:
                    time.sleep(0.5)
            if new_conn is None:
                break
            conn.close()
            conn = new_conn
            conn_lost.clear()
            draining.clear()
            try:
                send_hello(conn)
            except (OSError, EOFError):
                conn_lost.set()
                continue
        with lock:
            by_conn = {wc: wid for wid, (_, wc) in workers.items()}
        try:
            ready = mp_connection.wait([conn, *by_conn], timeout=0.05)
        except OSError:
            ready = []
        for c in ready:
            if c is conn:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    conn_lost.set()
                    break
                t = msg.get("type")
                if t == "start_worker":
                    # off the loop: the first start boots the zygote (seconds)
                    # and the loop must keep answering pings meanwhile
                    def _spawn(wid=msg["wid"], binding=msg.get("env") or {}):
                        try:
                            start_worker(wid, binding)
                        except Exception as e:  # noqa: BLE001 — the head learns it as the worker's death
                            send_head({"type": "worker_death", "wid": wid, "reason": f"spawn failed: {e!r}"})

                    th = threading.Thread(target=_spawn, daemon=True, name="rt-agent-spawn")
                    th.start()
                    spawn_threads[:] = [x for x in spawn_threads if x.is_alive()] + [th]
                elif t == "to_worker":
                    with lock:
                        entry = workers.get(msg["wid"])
                    if entry is not None:
                        try:
                            entry[1].send_bytes(msg["data"])
                        except (OSError, ValueError, EOFError):
                            reap_worker(msg["wid"], "pipe closed on send")
                elif t == "kill_worker":
                    reap_worker(msg["wid"], "killed by head", report=msg.get("report", True))
                elif t == "ping":
                    send_head({"type": "pong", "seq": msg.get("seq", 0), "pid": os.getpid()})
                elif t == "ns_addr":
                    resolver.deliver(msg["ns"], msg.get("addr"))
                elif t == "free_shm":
                    name = msg.get("name", "")
                    if name.startswith("rt") and "/" not in name:
                        fetch_cache.drop(name)
                        _unlink(name)
                elif t == "shutdown":
                    shutdown.set()
            else:
                wid = by_conn.get(c)
                if wid is None:
                    continue
                try:
                    data = c.recv_bytes()
                except (EOFError, OSError):
                    reap_worker(wid, "worker process exited", kill=False)
                    continue
                handle_worker_frame(wid, data)

    # drain for good: racing starts reap themselves, in-flight ones finish
    # before the zygote stops (a start after it would boot another)
    shutdown.set()
    for t in list(spawn_threads):
        t.join(timeout=30.0)
    kill_all_workers()
    stop_zygote()
    transfer_srv.shutdown()
    if my_ns:
        # a namespace of its own dies with the node: its objects are rebuilt
        # by lineage, its cached copies pulled again
        try:
            names = os.listdir("/dev/shm")
        except OSError:
            names = []
        for name in names:
            if name.startswith(f"rt{my_ns}_"):
                _unlink(name)
    conn.close()


def standalone_agent_main(head_host: str, head_port: int, authkey: bytes, transfer_authkey: bytes, resources: dict,
                          env: dict | None = None, reconnect_s: float = 60.0, labels: dict | None = None):
    """``rt agent --address head:port``: join a running cluster as a node
    (another host's, with a namespace of its own) and serve until the head
    is gone and the reconnect window has run out."""
    from ray_tpu_torch.core.ids import NodeID

    agent_entry((head_host, head_port), authkey, NodeID.from_random().hex(), dict(env or {}),
                transfer_authkey=transfer_authkey, resources=resources, reconnect_s=reconnect_s, labels=labels)


def main():
    """The entry of an agent the head started: its arguments come pickled
    on standard input."""
    args = pickle.loads(sys.stdin.buffer.read())
    sys.path[:] = [*args.pop("sys_path"), *[p for p in sys.path if p]]
    agent_entry(**args)


if __name__ == "__main__":
    main()
