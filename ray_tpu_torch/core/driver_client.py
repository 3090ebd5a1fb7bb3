"""An attached driver (port of ray_tpu/core/driver_client.py): a process
that joins a running cluster with ``init(address="auto" | "host:port")``
and submits its work to that cluster.

The driver dials the head's ``AgentListener`` (the authkey-gated TCP
rendezvous ``rt agent`` uses too), says ``driver_ready``, and from then
on speaks a worker's client protocol (``WorkerClient``): puts, gets,
tasks, actors and placement groups are the worker's code, only the
receive pump differs (a driver runs no tasks). It attaches the head's
segments on this host directly (the head's namespace is the host's) and
asks the head, as its node's agent, for a foreign namespace's.

A submitted job attaches the same way: ``job/`` exports
``RT_HEAD_ADDRESS`` and ``RT_HEAD_AUTHKEY`` to its entrypoint, so a plain
``init()`` there joins the cluster instead of starting its own.

Refused, as ray_tpu refuses them: ``address`` together with sizing
arguments (``api.init``); a head on another host (an attached driver's
objects live in the head host's shared memory: submit a job, or join
the host as a node with ``rt agent``); a wrong authkey (the listener's
handshake fails).
"""

from __future__ import annotations

import os
import threading

from ray_tpu_torch.core.worker_main import WorkerClient


class DriverClient(WorkerClient):
    """A ``WorkerClient`` over an attached socket, with a pump of the
    head's replies."""

    is_driver_attach = True

    def __init__(self, conn, welcome: dict):
        super().__init__(conn, welcome["worker_id"], welcome["node_id"])
        # session addressing (the session's directory, segment tags) keys off
        # the head's pid
        os.environ["RT_SESSION_PID"] = str(welcome["session_pid"])
        self.namespace = welcome.get("namespace", "default")
        self._head_down = threading.Event()
        from ray_tpu_torch._config import get_config
        from ray_tpu_torch.core import direct as _direct
        from ray_tpu_torch.core.object_ref import set_ref_counting
        from ray_tpu_torch.core.object_store import set_fetch_hook, set_session_tag

        set_fetch_hook(self._fetch_remote_segment)
        # the objects it puts through the head are the head's, as a worker's
        # are: named under the head's worker tag, they outlive this process
        set_session_tag(f"{welcome['session_pid']}w")
        self._pump = threading.Thread(target=self._recv_loop, daemon=True, name="rt-driver-pump")
        self._pump.start()
        if get_config().object_ref_counting:
            threading.Thread(target=self._ref_pump_loop, daemon=True, name="rt-ref-pump").start()
        else:
            set_ref_counting(False)
        # the direct plane: an attached driver owns its small objects and
        # calls actors and leased workers without the head in the way
        dk = welcome.get("direct_authkey")
        if dk:
            _direct.attach(bytes.fromhex(dk), node_hex=welcome["node_id"], client=self)

    def _check_alive_locked(self):
        # under the lock the pump's fail-fast flush takes: a call registers
        # only while the pump is alive to answer or fail it
        if self._shutdown or self._head_down.is_set() or self.conn.closed:
            raise ConnectionError("the driver's connection to its head is lost")

    def get_object(self, obj_id, timeout: float | None = None):
        # a get after the head is gone fails at once, also for an object this
        # driver owns (its direct call's reply may never come back)
        with self._req_lock:
            self._check_alive_locked()
        return super().get_object(obj_id, timeout)

    def _recv_loop(self):
        while not self._shutdown:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                break
            t = msg.get("type")
            if t == "resp":
                self._handle_resp(msg)
            elif t == "head_shutdown":
                break
        # down under the request lock, then the flush: no call registers
        # after it and waits for a reply that never comes
        with self._req_lock:
            self._head_down.set()
            self._shutdown = True
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[1] = False
            slot[2] = ConnectionError("the driver's connection to its head is lost")
            slot[0].set()

    def shutdown(self):
        if self._shutdown and self._head_down.is_set():
            self.conn.close()
            return
        from ray_tpu_torch.core import direct as _direct
        from ray_tpu_torch.core.object_store import set_fetch_hook, set_session_tag

        _direct.detach(self)  # gives its leases back through the head: before the link closes
        self._shutdown = True
        set_fetch_hook(None)
        set_session_tag(None)
        try:
            self._send({"type": "driver_bye"})
        except (OSError, ValueError):
            pass  # the head is gone already
        self.conn.close()


def resolve_address(address: str) -> tuple[tuple[str, int], bytes]:
    """((host, port), authkey) of an ``init(address=...)`` string:
    ``"auto"``, the newest live session's ``cluster_info.json`` on this
    host; ``"host:port"``, with the authkey from ``RT_HEAD_AUTHKEY`` (hex)
    or, on the head's host, from that file when the address matches."""
    from ray_tpu_torch.util.state import load_latest_cluster_info

    env_key = os.environ.get("RT_HEAD_AUTHKEY", "")
    if address == "auto":
        info = load_latest_cluster_info()
        if info is None:
            raise ConnectionError("init(address='auto'): no running session found on this host")
        return tuple(info["agent_address"]), bytes.fromhex(info["authkey"])
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"init address must be 'auto' or 'host:port', got {address!r}")
    addr = (host, int(port))
    if env_key:
        return addr, bytes.fromhex(env_key)
    info = load_latest_cluster_info()
    if info is not None and tuple(info["agent_address"]) == addr:
        return addr, bytes.fromhex(info["authkey"])
    raise ConnectionError(f"init(address={address!r}): no authkey; set RT_HEAD_AUTHKEY (hex, from the head's "
                          "cluster_info.json) or run on the head's host")


def connect_driver(address: str, timeout: float = 30.0) -> DriverClient:
    """Attach this process to the head at ``address`` as a driver."""
    import socket
    from multiprocessing import connection as mp_connection

    addr, authkey = resolve_address(address)
    conn = mp_connection.Client(tuple(addr), "AF_INET", authkey=authkey)
    conn.send({"type": "driver_ready", "pid": os.getpid()})
    if not conn.poll(timeout):
        conn.close()
        raise ConnectionError(f"driver attach to {addr} timed out waiting for the head's welcome")
    welcome = conn.recv()
    if welcome.get("type") != "driver_welcome":
        conn.close()
        raise ConnectionError(f"driver attach to {addr}: unexpected reply {welcome.get('type')!r}")
    head_host = welcome.get("hostname")
    if head_host and head_host != socket.gethostname():
        conn.close()
        raise ConnectionError(
            f"driver attach from {socket.gethostname()!r} to a head on {head_host!r}: an attached driver's objects "
            "live in the head host's shared memory, so a driver on another host cannot attach; submit a job "
            "(JobSubmissionClient: entrypoints run on the head's host) or join this host as a node with `rt agent "
            "--address`")
    return DriverClient(conn, welcome)
