"""Cache-aware request routing over the cluster KV plane (port of
ray_tpu/llm/kvplane/routing.py).

vLLM/SGLang-style cache-aware routing, re-expressed over the runtime's
own index: the router scores every replica by the LONGEST prefix of the
incoming prompt already cached on it (``PrefixIndex.match_replicas``)
blended with its live load, so shared-prefix traffic lands where its KV
already lives:

- **local tier**: the top-scored replica holds the prefix — admission is
  a local PrefixCache hit (no prefill, no fetch);
- **remote tier**: load pushed the request OFF the holder — the chosen
  replica's engine fetches the block over the object plane (one transfer
  instead of a prefill forward) and re-publishes, growing the local tier
  for the next request (the fetch waits for the object plane in the
  port: ROADMAP.md, queue 1, the object plane);
- **cold**: nobody holds anything — pure load balancing, and the chosen
  replica's prefill publishes the prefix for everyone after it.

``score = cache_weight * matched/len(prompt) - load_weight * inflight``:
with the defaults a near-full prefix match outweighs several queued
requests, but a severely loaded holder still sheds to an idle peer
(which then pays one object-plane fetch, not a prefill). Ties break on
load, then on replica order (deterministic for tests).

``CacheAwareRouter`` is the serve-agnostic core (mirroring
disagg/router.py): ``submit(replica_id, prompt, params) -> dict`` is
injected — deployment-handle calls under Serve, engine closures in
tests/benches — and failures retry on the next-ranked replica up to a
bounded attempt budget.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.exceptions import serving_error


@serving_error
class KVRouteError(RuntimeError):
    """Client-visible terminal failure after the router's retry budget."""


def score_replica(matched: int, prompt_len: int, load: float, *,
                  cache_weight: float = 1.0, load_weight: float = 0.1) -> float:
    """Blend of cache affinity and load pressure (see module docstring)."""
    return cache_weight * (matched / max(prompt_len, 1)) - load_weight * load


def rank_replicas(replicas, matches: dict, loads: dict, prompt_len: int, *,
                  cache_weight: float = 1.0, load_weight: float = 0.1) -> list:
    """Replica ids best-first. Deterministic: score desc, then load asc,
    then declaration order."""
    order = {r: i for i, r in enumerate(replicas)}
    return sorted(
        replicas,
        key=lambda r: (
            -score_replica(matches.get(r, 0), prompt_len, loads.get(r, 0),
                           cache_weight=cache_weight, load_weight=load_weight),
            loads.get(r, 0),
            order[r],
        ),
    )


class CacheAwareRouter:
    """Serve-agnostic cache-aware router core.

    ``index``: PrefixIndex or a handle to one (duck-typed on ``.remote``
    like the plane client). ``submit(replica_id, prompt_token_ids,
    sampling_params) -> dict`` performs the actual generation call.
    ``replicas``: the routable replica ids, matching what each replica's
    KVPlaneClient registered under."""

    def __init__(self, index, submit, replicas, *, block: int = 64,
                 cache_weight: float = 1.0, load_weight: float = 0.1,
                 max_attempts: int = 2, index_timeout_s: float = 10.0,
                 resume_submit=None, telemetry_tags: dict | None = None):
        from ray_tpu_torch.llm.telemetry import RouterTelemetry

        self._index = index
        self._submit = submit
        # resume_submit(replica_id, meta, ref, sampling_params) -> dict:
        # splice a preempted replica's published live_state checkpoint
        # (llm/migrate.py) on the chosen replica — the failover leg that
        # beats re-prefill (zero recomputed tokens). None = off.
        self._resume_submit = resume_submit
        self.replicas = list(replicas)
        self.block = int(block)
        self.cache_weight = float(cache_weight)
        self.load_weight = float(load_weight)
        self.max_attempts = max(1, int(max_attempts))
        self.index_timeout_s = float(index_timeout_s)
        self._lock = threading.Lock()
        self._inflight = {r: 0 for r in self.replicas}
        self.stats_counts = {
            "requests": 0, "routed_to_holder": 0, "routed_off_holder": 0,
            "cold": 0, "retries": 0, "failed": 0, "matched_tokens": 0,
            "index_errors": 0, "budget_exhausted": 0, "shed": 0,
            "migrations": 0, "resumed": 0,
        }
        # failover/shed events flow into the live serving metrics, same
        # catalog as the disagg router's
        self._tel = RouterTelemetry(telemetry_tags)

    def _matches(self, prompt) -> dict:
        """Per-replica longest cached prefix; {} when the index is down
        (the router degrades to pure load balancing, never fails)."""
        from ray_tpu_torch.llm.kvplane.client import index_call
        from ray_tpu_torch.llm.kvplane.index import boundary_keys

        keys = boundary_keys(prompt, self.block)
        if not keys:
            return {}
        try:
            return index_call(self._index, "match_replicas", keys, timeout_s=self.index_timeout_s) or {}
        except BaseException:  # noqa: BLE001
            with self._lock:
                self.stats_counts["index_errors"] += 1
            return {}

    def hot_prefixes(self, k: int = 4) -> list:
        """The fleet's top-k demanded prefix blocks (index.top_hot) —
        the same view replicas prefetch from, exposed router-side for
        dashboards and placement decisions. [] when the index is down."""
        from ray_tpu_torch.llm.kvplane.client import index_call

        try:
            return index_call(self._index, "top_hot", int(k), None,
                              timeout_s=self.index_timeout_s) or []
        except BaseException:  # noqa: BLE001
            with self._lock:
                self.stats_counts["index_errors"] += 1
            return []

    def route(self, prompt_token_ids) -> tuple:
        """(ranked replica ids, matches dict) for a prompt — exposed for
        tests and for callers that submit through their own transport."""
        prompt = list(prompt_token_ids)
        matches = self._matches(prompt)
        with self._lock:
            loads = dict(self._inflight)
        ranked = rank_replicas(
            self.replicas, matches, loads, len(prompt),
            cache_weight=self.cache_weight, load_weight=self.load_weight,
        )
        return ranked, matches

    def generate(self, prompt_token_ids, sampling_params: dict | None = None) -> dict:
        """Route one request: best-scored replica first, next-ranked on
        failure, KVRouteError after the bounded attempt budget."""
        prompt = list(prompt_token_ids)
        ranked, matches = self.route(prompt)
        best_match = max(matches.values(), default=0)
        with self._lock:
            self.stats_counts["requests"] += 1
            self.stats_counts["matched_tokens"] += best_match
            if best_match <= 0:
                self.stats_counts["cold"] += 1
            elif matches.get(ranked[0], 0) >= best_match:
                self.stats_counts["routed_to_holder"] += 1
            else:
                self.stats_counts["routed_off_holder"] += 1
        from ray_tpu_torch.serve.overload import RetryBudget, router_terminal

        priority = int((sampling_params or {}).get("priority", 0))
        budget = RetryBudget(self.max_attempts, self._tel)
        from ray_tpu_torch.llm.migrate import migration_lost, migration_of

        last: BaseException | None = None
        attempted = 0
        attempt = 0
        ix = 0  # position in the ranked list; a failure usually advances
        mig = None  # a preempted replica's (request_id, meta, ref) checkpoint
        while ix < len(ranked):
            if not budget.try_spend():
                break
            rid = ranked[ix]
            attempted += 1
            if attempt:
                with self._lock:
                    self.stats_counts["retries"] += 1
            attempt += 1
            with self._lock:
                self._inflight[rid] += 1
            try:
                if mig is not None and self._resume_submit is not None:
                    # resume-on-peer failover leg (llm/migrate.py): the
                    # previous replica was preempted mid-decode and
                    # checkpointed this request's live state — splice it
                    # here with ZERO recomputed tokens instead of paying
                    # prompt + generated prefix in a re-prefill
                    out = self._resume_submit(rid, mig[1], mig[2], sampling_params or {})
                    with self._lock:
                        self.stats_counts["resumed"] += 1
                    self._tel.on_migration("resumed")
                    return out
                return self._submit(rid, prompt, sampling_params or {})
            except BaseException as e:  # noqa: BLE001
                last = e
                m = migration_of(e)
                if m is not None and self._resume_submit is not None:
                    with self._lock:
                        self.stats_counts["migrations"] += 1
                    mig = m
                    ix += 1  # the dying replica is done; resume on the next
                elif mig is not None and migration_lost(e):
                    # checkpoint gone before the fetch: THIS replica is
                    # healthy (it failed to borrow, not to serve) — stay
                    # on it and re-prefill from scratch next attempt
                    # (correct, just recomputes the generated prefix)
                    self._tel.on_migration("lost")
                    mig = None
                else:
                    ix += 1
            finally:
                with self._lock:
                    self._inflight[rid] -= 1
        # shared terminal epilogue (serve/overload.py): distinguishes
        # budget exhaustion from a small fleet's ranked list running out,
        # re-raises saturation as the 429, and only counts real failures
        # as failed — the ONE policy the disagg router runs too
        router_terminal(
            last, budget=budget, priority=priority,
            counters=self.stats_counts, lock=self._lock, telemetry=self._tel,
            shed_msg=f"request shed: {attempted} replicas overloaded/draining",
        )
        raise KVRouteError(
            f"request failed on {attempted} replicas "
            f"(last: {type(last).__name__}: {last})"
        ) from last

    def stats(self) -> dict:
        with self._lock:
            return {**self.stats_counts, "inflight": dict(self._inflight)}
