"""Replica-side client of the cluster KV plane (port of
ray_tpu/llm/kvplane/client.py).

One ``KVPlaneClient`` per engine glues three planes together:

- **data plane**: published prefix blocks are OWNED objects in THIS
  process (``core/direct.put_owned``: the bytes in a shared-memory segment,
  the descriptor in the replica's OwnedStore; the replica owns each block
  for its whole life, as it owns a disagg handoff). Remote hits borrow-get
  them zero-copy (``get_owned_view``) with a bounded retry budget.
- **control plane**: the cluster ``PrefixIndex`` (index.py), an
  in-process object or a handle to one (duck-typed on ``.remote``: the
  same client code drives both).
- **wire format**: the disagg handoff codec with ``kind=PREFIX_KIND``
  (llm/disagg/handoff.py): shape, dtype and scale validation, an int8 wire
  for int8-cache engines (``kvplane/quant.py``, so a remote scatter-in is
  byte-identical to a local prefill's).

Failure policy: the plane is an ACCELERATOR, never a dependency. Every
index call and every fetch is bounded and caught: a dead index, a dead
holder or an evicted block degrades to "local prefill", counted in
``stats()``, and never wedges or crashes the serving engine. Local
eviction of a published block first unregisters its keys (the route dies
before the bytes) and then frees the owned object; the leak backstop
(RT_OWNED_OBJECT_LEAK_BACKSTOP_S) covers borrowers that died mid-fetch.

Threads: the eviction worker and the predictive prefetcher touch only
host memory and the plane; a fetched block reaches the card at admission,
on the engine's stepping thread under its lock (``LLMEngine``).
"""

from __future__ import annotations

import queue
import threading
import time
import weakref

import torch

from ray_tpu_torch import chaos
from ray_tpu_torch.llm.kvplane.index import boundary_keys


def index_call(index, name: str, *args, timeout_s: float = 10.0):
    """Dispatch one index method against either transport: a deployment
    handle (``.remote(...).result(timeout_s)``) or an in-process
    PrefixIndex (direct call). The ONE copy of this duck-type: the client
    and the cache-aware router both route through it. Raises on transport
    failure; callers own their degrade policy.

    Chaos plane (``ray_tpu_torch/chaos.py``, site ``kvplane.index``):
    tests inject per-method delays and failures HERE, the one seam every
    index call crosses, so the client's circuit breaker and the router's
    index-down degrade are exercised over the real call path. A single
    flag check when unarmed."""
    if not chaos.apply("kvplane.index", method=name):
        raise ConnectionError(f"chaos: dropped index rpc {name}")
    method = getattr(index, name)
    remote = getattr(method, "remote", None)
    if remote is not None:
        return remote(*args).result(timeout_s=timeout_s)
    return method(*args)


def _evict_worker(client_ref, jobs: queue.SimpleQueue):
    """A client's eviction worker. It holds the client only while a job
    runs and ends once the client is gone (the client holds its engine)."""
    while True:
        try:
            keys, dead_refs = jobs.get(timeout=1.0)
        except queue.Empty:
            if client_ref() is None:
                return
            continue
        client = client_ref()
        if client is None:
            return
        client._evict(keys, dead_refs)
        del client


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of a block (no copy for a contiguous host tensor)."""
    return t.detach().contiguous().cpu()


class KVPlaneClient:
    """Publish / lookup / fetch / evict against a cluster prefix index.

    ``index``: a PrefixIndex or a handle exposing the same methods.
    ``replica_id`` defaults to ``RT_WORKER_ID``, else the pid, so index
    entries, metrics and flight records all name the replica alike."""

    def __init__(
        self,
        index,
        replica_id: str | None = None,
        *,
        fetch_timeout_s: float = 5.0,
        fetch_retries: int = 1,
        retry_wait_s: float = 0.1,
        heartbeat_every_s: float = 5.0,
        index_timeout_s: float = 10.0,
        index_down_cooldown_s: float = 30.0,
        publish: bool = True,
        publish_min_hits: int = 2,
        prefetch_k: int = 0,
    ):
        """``publish_min_hits``: a boundary key is offered to ``publish()``
        once per local-cache event (the store that minted it, then every
        local hit's re-offer) and publishes once seen this many times. The
        default (2) keeps cold, never-reused prefixes off the object plane;
        1 publishes on store. Skips are counted in
        ``stats()['published_skipped']``.

        ``prefetch_k``: predictive prefetch. Every heartbeat tick also asks
        the index for the fleet's ``k`` hottest prefix blocks
        (``PrefixIndex.top_hot``) and pulls those this replica does not
        hold into its local PrefixCache on a worker thread, so the next
        shared-prefix request is a LOCAL-tier hit. 0 (the default) turns
        it off."""
        import os

        self._index = index
        self.replica_id = str(replica_id or os.environ.get("RT_WORKER_ID", str(os.getpid())))
        self.fetch_timeout_s = float(fetch_timeout_s)
        self.fetch_retries = int(fetch_retries)
        self.retry_wait_s = float(retry_wait_s)
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.index_timeout_s = float(index_timeout_s)
        self.index_down_cooldown_s = float(index_down_cooldown_s)
        self._publish_enabled = bool(publish)
        self.publish_min_hits = max(1, int(publish_min_hits))
        # boundary key -> publish-offer count; bounded (see _note_seen)
        self._seen: dict[bytes, int] = {}  # guarded-by: _lock
        # circuit breaker: repeated index failures open it for a cooldown,
        # so a DEAD index costs one timeout, not one per admission
        self._consec_errors = 0
        self._down_until = 0.0
        self._shutdown = False
        self._lock = threading.Lock()
        self._published: dict[bytes, tuple] = {}  # boundary key -> (n, meta, ref); guarded-by: _lock
        self._ref_keys: dict[bytes, set] = {}  # ref id -> live boundary keys; guarded-by: _lock
        self._evict_q = None  # SimpleQueue + daemon worker, made on the first eviction
        self._last_heartbeat = 0.0
        # predictive prefetch: one round in flight at a time, on its own
        # daemon thread, never the stepper
        self.prefetch_k = max(0, int(prefetch_k))
        self._prefetch_thread = None
        # attach() fills these from the engine's config
        self._engine = None
        self._wire_int8 = False
        self._compute_dtype = "float32"
        self._block = 64
        self._quantize = self._dequantize = None
        self.counts = {
            "published_blocks": 0, "published_bytes": 0, "unpublished_blocks": 0,
            "published_skipped": 0,
            "fetches": 0, "fetched_bytes": 0, "fetch_lost": 0,
            "index_errors": 0, "publish_errors": 0, "free_errors": 0,
            "prefetch_rounds": 0, "prefetch_blocks": 0, "prefetch_bytes": 0,
            "prefetch_skipped": 0, "prefetch_errors": 0,
        }

    # -- engine wiring -----------------------------------------------------
    def attach(self, engine) -> None:
        """Bind the client to its engine's cache format: an int8-cache
        engine publishes int8 wire blocks (about half the bytes); an fp
        engine publishes at the block's own dtype. The engine handle also
        feeds the prefetcher (``adopt_prefetched``)."""
        from ray_tpu_torch.llm.kvplane.quant import make_wire_fns

        self._engine = engine
        self._wire_int8 = bool(engine.kv_quant)
        self._compute_dtype = str(engine.config.dtype)
        if engine._prefix_cache is not None:
            self._block = int(engine._prefix_cache.block)
        self._quantize, self._dequantize = make_wire_fns()

    # -- index transport ---------------------------------------------------
    def _safe_call(self, name: str, *args, default=None):
        try:
            out = index_call(self._index, name, *args, timeout_s=self.index_timeout_s)
        except BaseException:  # noqa: BLE001 — a dead index must degrade, never propagate
            self.counts["index_errors"] += 1
            self._consec_errors += 1
            if self._consec_errors >= 2:
                self._down_until = time.time() + self.index_down_cooldown_s
            return default
        self._consec_errors = 0
        self._down_until = 0.0
        return out

    def index_down(self) -> bool:
        """Circuit-breaker state: True while recent consecutive index
        failures hold the plane open (lookups and publishes short-circuit
        instead of paying a timeout per admission)."""
        return time.time() < self._down_until

    def maybe_heartbeat(self) -> None:
        """Refresh this replica's index lease, throttled (called from the
        engine's step tail). The reply carries the index's key count for
        this replica: fewer than we hold published means the index pruned
        us (a partition outliving the lease), so every live block is
        registered again. Each tick also starts one predictive prefetch
        round (prefetch_k > 0)."""
        now = time.time()
        if now - self._last_heartbeat < self.heartbeat_every_s:
            return
        self._last_heartbeat = now
        known = self._safe_call("heartbeat", self.replica_id)
        if known is None:
            return
        with self._lock:
            entries = (
                [(key, n, meta, ref) for key, (n, meta, ref) in self._published.items()]
                if int(known) < len(self._published) else None
            )
        if entries:
            self._safe_call("register", self.replica_id, entries)
        self._maybe_prefetch()

    # -- predictive prefetch -----------------------------------------------
    def _maybe_prefetch(self) -> None:
        """Start one prefetch round on a daemon worker (at most one in
        flight: a round still running means the last tick's transfers have
        not landed; skip, do not queue)."""
        if self.prefetch_k <= 0 or self._engine is None or self._shutdown or self.index_down():
            return
        t = self._prefetch_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._prefetch_round, daemon=True, name="kvplane-prefetch")
        self._prefetch_thread = t
        t.start()

    def _prefetch_round(self) -> None:
        """One predictive-prefetch round: ask the index for the fleet's
        hottest live blocks, fetch every one this replica does not hold and
        hand it to the engine's local PrefixCache. EVERY failure degrades
        to "no prefetch this round", counted, never raised.

        Chaos plane (site ``kvplane.prefetch``): drops, delays and faults
        land HERE; prefetch is background opportunism, so any injected
        failure leaves serving token-identical."""
        try:
            if not chaos.apply("kvplane.prefetch"):
                self.counts["prefetch_skipped"] += 1
                return
            self.counts["prefetch_rounds"] += 1
            hot = self._safe_call("top_hot", self.prefetch_k, self.replica_id, default=None)
            for hit in hot or ():
                if self._shutdown:
                    return
                with self._lock:
                    if bytes(hit["key"]) in self._published:
                        continue  # we hold and registered these bytes already
                payload = self.fetch(hit)
                if payload is None:
                    continue  # lost or evicted: fetch() reported the route
                self._adopt_payload(hit, payload)
        except BaseException:  # noqa: BLE001 — prefetch is opportunistic, never load-bearing
            self.counts["prefetch_errors"] += 1

    def _adopt_payload(self, hit: dict, payload: dict) -> int:
        """Hand one fetched hot block to the engine's PrefixCache. A wire
        of another dtype family than the cache is skipped: the bytes a later
        local hit serves must equal what a local prefill would have made."""
        wire_int8 = payload["k"].dtype == torch.int8
        if wire_int8 != self._wire_int8:
            return 0
        n = int(hit["n"])
        if int(payload["n"]) < n:
            return 0
        if wire_int8:
            k_fp, v_fp = self.dequantize_wire(payload["k"], payload["v"], payload["k_scale"], payload["v_scale"])
        else:
            k_fp, v_fp = payload["k"], payload["v"]
        nb = int(self._engine.adopt_prefetched(payload["prompt_token_ids"][:n], k_fp, v_fp))
        if nb:
            self.counts["prefetch_blocks"] += 1
            self.counts["prefetch_bytes"] += nb
        return nb

    # -- publish -----------------------------------------------------------
    def publish(self, prefix_ids, k_blk, v_blk, bounds: list | None = None, proven_reuse: bool = False) -> int:
        """Publish one prefix block (fp tensors [L, T_pad, kv, hd] on either
        device, T_pad >= len(prefix_ids)) as an owned object and register
        its block boundaries against the one ref. ``bounds`` ([(n, key)])
        restricts registration to the boundaries the local cache just
        minted; by default every boundary of ``prefix_ids``.
        ``proven_reuse`` bypasses the publish_min_hits policy (the engine's
        republish of a block it just fetched: somebody else demonstrably
        wants this prefix). Returns the published bytes (0 = skipped or
        failed; the plane degrades, it never raises into the prefill)."""
        if not self._publish_enabled or self.index_down():
            return 0
        from ray_tpu_torch.core import direct as _direct
        from ray_tpu_torch.llm.disagg import handoff

        if bounds is None:
            bounds = boundary_keys(prefix_ids, self._block, strict=False)
        with self._lock:
            # every offer of a still-unpublished key counts as one sighting;
            # the key ships once seen publish_min_hits times
            fresh = []
            for bn, key in bounds:
                kb = bytes(key)
                if kb in self._published:
                    continue
                if not proven_reuse and self._note_seen(kb) < self.publish_min_hits:
                    self.counts["published_skipped"] += 1
                    continue
                fresh.append((bn, key))
            bounds = fresh
        if not bounds:
            return 0
        n = len(prefix_ids)
        try:
            payload = {"n": n, "prompt_token_ids": [int(t) for t in prefix_ids]}
            if self._wire_int8:
                kq, vq, ks, vs = self._quantize(k_blk, v_blk)
                payload.update(k=_host(kq), v=_host(vq), k_scale=_host(ks), v_scale=_host(vs))
            else:
                payload.update(k=_host(k_blk), v=_host(v_blk))
            wire = handoff.encode(payload, kind=handoff.PREFIX_KIND)
            meta = handoff.meta_of(wire)
        except (handoff.HandoffError, RuntimeError, ValueError):
            self.counts["publish_errors"] += 1  # transient: the next store retries
            return 0
        try:
            ref = _direct.put_owned(wire)
        except RuntimeError as e:
            self.counts["publish_errors"] += 1
            if "direct plane" in str(e):
                # no plane attached in this process: publishing is
                # PERMANENTLY impossible, so stop serializing blocks; any
                # other RuntimeError is transient
                self._publish_enabled = False
            return 0
        except (MemoryError, OSError):
            self.counts["publish_errors"] += 1  # /dev/shm full: the block stays local
            return 0
        # every covered boundary aliases the ONE ref with its own valid
        # length: a shorter-prefix lookup slices the same block
        entries = [(key, bn, meta, ref) for bn, key in bounds]
        if self._safe_call("register", self.replica_id, entries) is None:
            # index unreachable: nobody can route to this block, so free it
            # now instead of stranding owner-side bytes
            try:
                _direct.free_owned([ref.id])
            except BaseException:  # noqa: BLE001 — counted: stranded bytes stay visible as free_errors
                self.counts["free_errors"] += 1
            return 0
        with self._lock:
            for bn, key in bounds:
                kb = bytes(key)
                self._published[kb] = (bn, meta, ref)
                self._seen.pop(kb, None)
            self._ref_keys[ref.id.binary()] = {bytes(key) for _, key in bounds}
        self.counts["published_blocks"] += 1
        self.counts["published_bytes"] += int(meta["nbytes"])
        return int(meta["nbytes"])

    def _note_seen(self, key: bytes) -> int:  # holds-lock: _lock
        """Bump and return a boundary key's sighting count. The map holds
        only keys the policy still needs and is bounded: past 64k keys the
        oldest-inserted half goes (a lost count only delays a cold prefix's
        publication by one more sighting)."""
        if len(self._seen) > 65536:
            for k in list(self._seen)[: len(self._seen) // 2]:
                del self._seen[k]
        n = self._seen.get(key, 0) + 1
        self._seen[key] = n
        return n

    # -- lookup / fetch ----------------------------------------------------
    def lookup(self, keys: list):
        """Longest live remote match for ``[(n, key)]`` boundary keys
        (excluding this replica's own entries: its local cache already
        missed). None on a miss, an index failure, or while the breaker is
        open."""
        if self.index_down():
            return None
        return self._safe_call("lookup", keys, self.replica_id, self.replica_id, default=None)

    def fetch(self, hit: dict):
        """Borrow-get a remote prefix block (bounded retry, zero-copy decode,
        full codec validation). Returns the decoded payload (host tensors
        over the owner's segment), or None when the block is gone or
        corrupt: the dead route is reported back to the index so nobody
        retries it."""
        from ray_tpu_torch.llm.disagg import handoff

        self.counts["fetches"] += 1
        try:
            payload = handoff.fetch(
                hit["ref"], hit.get("meta"), kind=handoff.PREFIX_KIND,
                timeout_s=self.fetch_timeout_s, retries=self.fetch_retries, retry_wait_s=self.retry_wait_s,
            )
        except (handoff.HandoffLostError, handoff.HandoffError):
            self.counts["fetch_lost"] += 1
            self._safe_call("report_lost", hit.get("replica"), hit.get("key"))
            return None
        nbytes = int(hit.get("meta", {}).get("nbytes") or (payload["k"].nbytes + payload["v"].nbytes))
        self.counts["fetched_bytes"] += nbytes
        return payload

    def dequantize_wire(self, k_blk, v_blk, k_scale, v_scale):
        """Int8 wire block -> fp twins at the engine's compute dtype, on the
        inputs' device (the local re-store of a fetched remote prefix)."""
        from ray_tpu_torch.llm.kvplane.quant import wire_dequantize

        return wire_dequantize(k_blk, v_blk, k_scale, v_scale, self._compute_dtype)

    # -- eviction ----------------------------------------------------------
    def on_evict(self, keys: list) -> None:
        """PrefixCache eviction hook: the local block is dying, so (1)
        unregister its boundary keys (the route dies first) and (2) free the
        owned object once no boundary references it. A fetch racing this
        sees ObjectLostError and falls back to a local prefill.

        Runs under the ENGINE lock (store -> LRU evict), so the index call
        and the free go to a worker thread in unregister-then-free order: a
        slow or dead index never stalls the serving loop."""
        dead_refs = []
        with self._lock:
            for key in keys:
                entry = self._published.pop(bytes(key), None)
                if entry is None:
                    continue
                ref = entry[2]
                rk = ref.id.binary()
                alive = self._ref_keys.get(rk)
                if alive is not None:
                    alive.discard(bytes(key))
                    if not alive:
                        del self._ref_keys[rk]
                        dead_refs.append(ref)
            if not keys:
                return
            if self._evict_q is None:
                self._evict_q = queue.SimpleQueue()
                threading.Thread(target=_evict_worker, args=(weakref.ref(self), self._evict_q), daemon=True,
                                 name="kvplane-evict").start()
        self._evict_q.put(([bytes(k) for k in keys], dead_refs))

    def _evict(self, keys: list, dead_refs: list):
        """One eviction, off the engine's path: unregister the route first,
        then free the bytes."""
        from ray_tpu_torch.core import direct as _direct

        if not self.index_down():
            # skipped while the breaker is open: a fetcher hitting the stale
            # route gets ObjectLostError and report_lost cleans it
            self._safe_call("unregister", self.replica_id, keys)
        for ref in dead_refs:
            try:
                _direct.free_owned([ref.id])
                self.counts["unpublished_blocks"] += 1
            except BaseException:  # noqa: BLE001 — the worker must live on; the leak backstop reclaims
                self.counts["free_errors"] += 1

    # -- drain / teardown --------------------------------------------------
    def shutdown(self) -> int:
        """Replica drain or teardown: drop every route this replica
        registered (one ``drop_replica`` call) and then free the owned
        blocks, route before bytes. Publishing stops for good. Returns how
        many published keys were released. A dead index degrades quietly:
        the lease expiry prunes our entries anyway, and the owned bytes die
        with this process. Idempotent."""
        with self._lock:
            if self._shutdown:
                return 0
            self._shutdown = True
            self._publish_enabled = False
            published = dict(self._published)
            self._published.clear()
            self._ref_keys.clear()
            self._seen.clear()
        self._safe_call("drop_replica", self.replica_id)
        refs = {ref.id.binary(): ref for _, _, ref in published.values()}
        if refs:
            from ray_tpu_torch.core import direct as _direct

            for ref in refs.values():
                try:
                    _direct.free_owned([ref.id])
                    self.counts["unpublished_blocks"] += 1
                except BaseException:  # noqa: BLE001 — the leak backstop reclaims what an errored free leaves
                    self.counts["free_errors"] += 1
        return len(published)

    def stats(self) -> dict:
        with self._lock:
            return {
                **self.counts,
                "replica_id": self.replica_id,
                "live_published_keys": len(self._published),
                "wire_dtype": "int8" if self._wire_int8 else self._compute_dtype,
                "index_down": self.index_down(),
            }
