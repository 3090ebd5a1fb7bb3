"""Cluster prefix index: content-stable token-hash keys and a
replica-entry map (port of ray_tpu/llm/kvplane/index.py).

``stable_hash`` is blake2b over a domain salt and the prefix's tokens as
little-endian int32 bytes, so every process derives the same key for the
same tokens (Python's builtin ``hash()`` is salted per process). The
bytes are identical to ray_tpu's, so the two packages share one key
space: a key minted by either names the same prefix in the other. Keys
exist only at prefix-block boundaries, as the local cache keys them
(``boundary_keys``).

``PrefixIndex`` is the cluster-side map: key -> {replica -> (n_valid,
meta, ref)}. Replicas register their published prefix blocks here; the
cache-aware router asks ``match_replicas`` to score candidates by longest
cached prefix, and an engine that misses locally asks ``lookup`` for the
longest live remote holder. Liveness is lease-based: every call a
replica makes refreshes its ``last_seen`` stamp, and entries of a replica
silent for ``ttl_s`` stop matching (and are pruned by ``expire``).
Demand is counted per key on every lookup and match, halving every
``demand_halflife_s`` (``top_hot``, the prefetch feed).

The class is lock-safe dict work and never touches KV bytes: the refs it
holds are opaque. Its publishing client (``KVPlaneClient``) waits for the
object plane (ROADMAP.md, queue 1, the object plane); tests and scripts
call it in process.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np

# domain salt: a kvplane key never collides with another use of blake2b
# over the same token bytes
_SALT = b"rt-kvplane-v1:"
_TOKEN_BYTES = 4  # tokens hash as little-endian int32


def token_bytes(token_ids) -> bytes:
    """Canonical byte encoding of a token sequence (int32 little-endian)."""
    return np.asarray(token_ids, dtype="<i4").tobytes()


def stable_hash(token_ids) -> bytes:
    """Content-stable 128-bit key (blake2b digest) of a token sequence or
    of ``token_bytes`` output. Consumers still verify a hit token for
    token before trusting it."""
    buf = token_ids if isinstance(token_ids, (bytes, bytearray, memoryview)) else token_bytes(token_ids)
    return hashlib.blake2b(_SALT + bytes(buf), digest_size=16).digest()


def prefix_key(buf: bytes, n: int) -> bytes:
    """Key of the first ``n`` tokens of a ``token_bytes`` buffer."""
    return stable_hash(buf[: _TOKEN_BYTES * n])


def boundary_keys(token_ids, block: int, *, strict: bool = True) -> list:
    """``[(n, key)]`` for every block boundary of the sequence (ascending
    n). ``strict`` (the LOOKUP side) keeps boundaries STRICTLY shorter
    than the prompt — at least one token must remain un-cached to produce
    first-token logits, matching PrefixCache.lookup's bound.
    ``strict=False`` (the PUBLISH side) includes the full length of an
    already block-aligned prefix: a published block registers under every
    boundary it covers, its own tail included."""
    ids = list(token_ids)
    buf = token_bytes(ids)
    n_max = ((len(ids) - (1 if strict else 0)) // block) * block
    return [(n, prefix_key(buf, n)) for n in range(block, n_max + 1, block)]


class PrefixIndex:
    """Cluster-wide prefix-block registry with lease-based liveness.

    Thread-safe; all methods are cheap dict work (the index never touches
    KV bytes — refs and small meta dicts only). ``time_fn`` is injectable
    for staleness tests."""

    def __init__(self, *, ttl_s: float = 30.0, time_fn=None, demand_halflife_s: float = 30.0):
        self.ttl_s = float(ttl_s)
        self.demand_halflife_s = float(demand_halflife_s)
        self._now = time_fn or time.time
        self._lock = threading.Lock()
        # key -> {replica -> {"n": int, "meta": dict, "ref": ObjectRef}}
        self._entries: dict[bytes, dict[str, dict]] = {}  # guarded-by: _lock
        # replica -> {"last_seen": float, "keys": set[bytes]}
        self._replicas: dict[str, dict] = {}  # guarded-by: _lock
        # key -> decayed demand score: every router match / miss lookup
        # that queries a boundary key bumps it; scores HALVE every
        # demand_halflife_s so top_hot tracks the current workload, not
        # all-time popularity (guarded-by: _lock)
        self._demand: dict[bytes, float] = {}
        self._demand_decayed = self._now()
        self.counts = {  # guarded-by: _lock
            "registered": 0, "unregistered": 0, "expired": 0,
            "lookups": 0, "hits": 0, "lost_reports": 0, "top_hot_calls": 0,
        }

    # -- liveness ----------------------------------------------------------
    def _touch(self, replica: str) -> None:  # holds-lock: _lock
        rec = self._replicas.setdefault(replica, {"last_seen": 0.0, "keys": set()})
        rec["last_seen"] = self._now()

    def _alive(self, replica: str, now: float) -> bool:
        rec = self._replicas.get(replica)
        return rec is not None and (now - rec["last_seen"]) <= self.ttl_s

    def heartbeat(self, replica: str) -> int:
        """Refresh the replica's lease. Returns how many keys the index
        holds for it — a replica that was pruned (network partition
        outliving the lease + an expire()) sees fewer than it published
        and re-registers its live blocks (client.maybe_heartbeat)."""
        with self._lock:
            self._touch(replica)
            return len(self._replicas[replica]["keys"])

    def expire(self) -> int:
        """Prune every entry belonging to a replica past its lease.
        Matching already ignores stale replicas, so this is garbage
        collection, not correctness; called opportunistically."""
        with self._lock:
            now = self._now()
            dead = [r for r in self._replicas if not self._alive(r, now)]
            n = 0
            for r in dead:
                n += self._drop_replica_locked(r)
            self.counts["expired"] += n
            return n

    def _drop_replica_locked(self, replica: str) -> int:  # holds-lock: _lock
        rec = self._replicas.pop(replica, None)
        if rec is None:
            return 0
        n = 0
        for key in rec["keys"]:
            holders = self._entries.get(key)
            if holders and holders.pop(replica, None) is not None:
                n += 1
                if not holders:
                    del self._entries[key]
        return n

    def drop_replica(self, replica: str) -> int:
        """Remove every entry a replica registered (explicit teardown)."""
        with self._lock:
            return self._drop_replica_locked(replica)

    # -- registration ------------------------------------------------------
    def register(self, replica: str, entries: list) -> int:
        """``entries``: [(key, n_valid, meta, ref)] — every block
        boundary of one published block aliases the SAME ref with its own
        valid length (the consumer slices). Returns how many registered."""
        with self._lock:
            self._touch(replica)
            rec = self._replicas[replica]
            for key, n, meta, ref in entries:
                self._entries.setdefault(bytes(key), {})[replica] = {
                    "n": int(n), "meta": dict(meta or {}), "ref": ref,
                }
                rec["keys"].add(bytes(key))
            self.counts["registered"] += len(entries)
            return len(entries)

    def unregister(self, replica: str, keys: list) -> int:
        """Drop a replica's entries for ``keys`` (local eviction: the
        owner is about to free the block, so the route must die first)."""
        with self._lock:
            self._touch(replica)
            rec = self._replicas.get(replica)
            n = 0
            for key in keys:
                key = bytes(key)
                holders = self._entries.get(key)
                if holders and holders.pop(replica, None) is not None:
                    n += 1
                    if not holders:
                        del self._entries[key]
                if rec is not None:
                    rec["keys"].discard(key)
            self.counts["unregistered"] += n
            return n

    def report_lost(self, replica: str, key) -> None:
        """A fetch found the block gone (evicted/owner died mid-race):
        drop the dead route so nobody else burns a retry on it."""
        with self._lock:
            self.counts["lost_reports"] += 1
            holders = self._entries.get(bytes(key))
            if holders and holders.pop(replica, None) is not None:
                rec = self._replicas.get(replica)
                if rec is not None:
                    rec["keys"].discard(bytes(key))
                if not holders:
                    del self._entries[bytes(key)]

    # -- demand ------------------------------------------------------------
    def _bump_demand_locked(self, keys) -> None:  # holds-lock: _lock
        now = self._now()
        # lazy exponential decay: halve every halflife elapsed since the
        # last decay tick, dropping dust so the dict tracks the live
        # working set instead of growing with every prompt ever seen
        if now - self._demand_decayed >= self.demand_halflife_s:
            halvings = int((now - self._demand_decayed) // self.demand_halflife_s)
            self._demand_decayed += halvings * self.demand_halflife_s
            scale = 0.5 ** min(halvings, 64)
            self._demand = {k: s for k, s in ((k, s * scale) for k, s in self._demand.items()) if s >= 0.0625}
        for _n, key in keys:
            key = bytes(key)
            self._demand[key] = self._demand.get(key, 0.0) + 1.0

    def top_hot(self, k: int = 4, exclude: str | None = None) -> list:
        """The fleet's ``k`` hottest LIVE prefix blocks by decayed demand
        — the predictive-prefetch feed (client.maybe_heartbeat): a replica
        pulls these into its local PrefixCache before they are requested,
        turning remote-tier hits into local-tier hits. Entries shaped like
        ``lookup`` hits ({"key","n","replica","meta","ref"}) so the client
        fetches them through the same path. ``exclude`` drops blocks the
        asking replica already holds (it published them); boundary keys
        aliasing the SAME published ref dedup to the longest one, since a
        single fetch + local store re-mints every shorter boundary."""
        with self._lock:
            self.counts["top_hot_calls"] += 1
            now = self._now()
            cands: list = []
            for key, score in self._demand.items():
                holders = self._entries.get(key)
                if not holders:
                    continue
                if exclude is not None and exclude in holders:
                    continue  # the asker already owns a copy of these bytes
                live = [(rep, e) for rep, e in holders.items() if self._alive(rep, now)]
                if not live:
                    continue
                rep, e = max(live, key=lambda it: self._replicas[it[0]]["last_seen"])
                cands.append((score, int(e["n"]), key, rep, e))
            # hottest first; equal-demand boundary aliases of one prompt
            # resolve to the longest (its fetch covers the shorter ones)
            cands.sort(key=lambda it: (-it[0], -it[1]))
            out: list = []
            picked: set = set()
            for score, n, key, rep, e in cands:
                alias = (rep, id(e["ref"]))
                if alias in picked:
                    continue  # shorter boundary of an already-picked block
                picked.add(alias)
                out.append({"key": bytes(key), "n": n, "replica": rep,
                            "meta": dict(e["meta"]), "ref": e["ref"], "demand": score})
                if len(out) >= int(k):
                    break
            return out

    # -- lookup ------------------------------------------------------------
    def lookup(self, keys: list, exclude: str | None = None, requester: str | None = None):
        """Longest live match for a prompt's boundary ``[(n, key)]`` list
        (ascending). Returns {"key", "n", "replica", "meta", "ref"} or
        None. ``exclude`` skips the requester's own entries (its local
        cache already missed — its published copy is the same bytes);
        ``requester`` refreshes the caller's lease for free."""
        with self._lock:
            if requester is not None:
                self._touch(requester)
            self.counts["lookups"] += 1
            self._bump_demand_locked(keys)
            now = self._now()
            for n, key in reversed(list(keys)):
                holders = self._entries.get(bytes(key))
                if not holders:
                    continue
                live = [
                    (rep, e) for rep, e in holders.items()
                    if rep != exclude and self._alive(rep, now)
                ]
                if not live:
                    continue
                # freshest lease wins: most-recently-seen holder is the
                # least likely to have died since
                rep, e = max(live, key=lambda it: self._replicas[it[0]]["last_seen"])
                self.counts["hits"] += 1
                return {"key": bytes(key), "n": e["n"], "replica": rep, "meta": dict(e["meta"]), "ref": e["ref"]}
            return None

    def match_replicas(self, keys: list) -> dict:
        """{replica -> longest matched prefix length} over live replicas —
        the router's cache-aware scoring input. Dead replicas never
        appear (the 'router never routes to them' staleness contract)."""
        with self._lock:
            self._bump_demand_locked(keys)
            now = self._now()
            out: dict[str, int] = {}
            for n, key in keys:
                for rep in self._entries.get(bytes(key), {}):
                    if self._alive(rep, now) and out.get(rep, 0) < n:
                        out[rep] = n
            return out

    def stats(self) -> dict:
        with self._lock:
            now = self._now()
            return {
                **self.counts,
                "keys": len(self._entries),
                "demand_keys": len(self._demand),
                "replicas_live": sum(1 for r in self._replicas if self._alive(r, now)),
                "replicas_known": len(self._replicas),
            }
