"""Disaggregated serving router: admit to prefill, bind to a decode lane
(port of ray_tpu/llm/disagg/router.py).

The router is the control plane of the prefill/decode split (the data
plane is the handoff object, llm/disagg/handoff.py — the router never
touches the KV bytes). Per request it:

1. admits the prompt to the prefill pool and receives (meta, ref) — a
   tiny summary plus a borrowed reference to the owned KV block (the
   router takes whatever its prefill callable returns: an object-plane
   reference from ``handoff.publish``, or in process the payload itself);
2. binds the handoff to a decode lane (a decode submit callable; under
   Serve this is the decode deployment handle, whose pow-2 router picks
   the replica) and waits for generation;
3. tracks every in-flight handoff ref so the block stays alive from
   publish to scatter-in, and releases it the moment the request settles
   (the owner then frees on borrow-release).

Failure policy — bounded, never hanging:

- decode lane dies after the handoff (replica crash mid-request): the
  request is retried on another lane, REUSING the same handoff if the
  block is still alive, re-prefilling if it is not; after
  ``max_attempts`` total attempts the error surfaces to the client. The
  orphaned block is not leaked: the router drops its borrow and the
  owner's backstop covers the dead replica's unregistered one.
- handoff evicted/freed before scatter-in: the decode side's bounded
  fetch raises HandoffLostError; the router re-prefills (a fresh block)
  up to the same attempt budget, then fails the request client-visibly.
- decode replica PREEMPTED mid-request (llm/migrate.py): the replica's
  drain(mode="migrate") hands the waiter a RequestMigratedError carrying
  the published checkpoint's (meta, ref) — the router RESUMES the
  request on another lane via the injected ``resume`` callable, zero
  recomputed tokens, beating re-prefill (which pays prompt + generated
  prefix). A lost checkpoint degrades to re-prefill; the whole ladder
  spends the one shared RetryBudget: migrate -> re-prefill -> typed
  error.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.exceptions import serving_error
from ray_tpu_torch.llm.disagg.handoff import HandoffLostError


@serving_error
class DisaggRequestError(RuntimeError):
    """Client-visible terminal failure after the router's retry budget."""


def _handoff_lost(e: BaseException | None) -> bool:
    """True when ``e`` is (or wraps) a HandoffLostError. Under Serve the
    decode replica's exception crosses the wire inside TaskError: follow
    the ``.cause`` chain, and fall back to the remote traceback string
    for causes that didn't survive pickling."""
    for _ in range(8):
        if e is None:
            return False
        if isinstance(e, HandoffLostError):
            return True
        if "HandoffLostError" in getattr(e, "tb_str", ""):
            return True
        e = getattr(e, "cause", None)
    return False


class DisaggRouter:
    """Serve-agnostic core. ``prefill(prompt_token_ids) -> (meta, ref)``
    and ``decode(meta, ref, prompt_token_ids, sampling_params) -> dict``
    are injected (under Serve: deployment-handle calls; in tests: engine
    closures), so the policy is testable without a cluster."""

    def __init__(self, prefill, decode, *, resume=None, max_attempts: int = 3,
                 telemetry_tags: dict | None = None):
        from ray_tpu_torch.llm.telemetry import RouterTelemetry

        self._prefill = prefill
        self._decode = decode
        # resume(meta, ref, sampling_params) -> dict: splice a preempted
        # replica's published live_state checkpoint on a peer (under
        # Serve: the decode handle's resume_from_migration). None = the
        # resume leg is off and migrations degrade to re-prefill.
        self._resume = resume
        self.max_attempts = max(1, int(max_attempts))
        self._lock = threading.Lock()
        self._inflight: dict[str, object] = {}  # request key -> handoff ref
        self.stats_counts = {
            "requests": 0, "prefills": 0, "decode_retries": 0,
            "handoffs_lost": 0, "failed": 0, "handoff_bytes": 0,
            "budget_exhausted": 0, "shed": 0,
            "migrations": 0, "resumed": 0,
        }
        self._seq = 0
        # control-plane events also flow into the live serving metrics
        # (llm/telemetry.py catalog) so a /metrics scrape sees the split's
        # health, not just callers polling stats()
        self._tel = RouterTelemetry(telemetry_tags)

    def stats(self) -> dict:
        with self._lock:
            return {**self.stats_counts, "inflight": len(self._inflight)}

    def _bump(self, key: str, by: int = 1):
        with self._lock:
            self.stats_counts[key] += by

    def generate(self, prompt_token_ids, sampling_params: dict | None = None) -> dict:
        """One request end to end. The failover budget is the SHARED
        per-request ``serve.overload.RetryBudget`` (one policy across the
        disagg and kvplane routers): every attempt — prefill retry,
        handoff-lost re-prefill, decode failover — spends one unit.
        Exhaustion surfaces a typed terminal error: OverloadedError when
        the last failure was a shedding/draining replica (the 429
        propagates so clients back off), DisaggRequestError otherwise."""
        from ray_tpu_torch.llm.migrate import migration_lost, migration_of
        from ray_tpu_torch.serve.overload import RetryBudget, router_terminal

        with self._lock:
            self.stats_counts["requests"] += 1
            self._seq += 1
            key = f"dreq-{self._seq}"
        priority = int((sampling_params or {}).get("priority", 0))
        budget = RetryBudget(self.max_attempts, self._tel)
        meta = ref = None
        mig = None  # (request_id, meta, ref) of a preempted lane's checkpoint
        last: BaseException | None = None
        try:
            while budget.try_spend():
                if mig is not None and self._resume is not None:
                    # resume-on-peer leg (recompute = 0): splice the
                    # dying replica's live_state checkpoint before ever
                    # considering a re-prefill (which would recompute
                    # prompt + the whole generated prefix)
                    try:
                        out = self._resume(mig[1], mig[2], sampling_params or {})
                        self._bump("resumed")
                        self._tel.on_migration("resumed")
                        return out
                    except BaseException as e:  # noqa: BLE001
                        last = e
                        if migration_lost(e):
                            # checkpoint gone (owner exited before the
                            # fetch): degrade to re-prefill from scratch
                            self._tel.on_migration("lost")
                            mig = None
                        # an overloaded/dead peer keeps the checkpoint —
                        # the next budget unit retries the resume
                    continue
                if ref is None:
                    try:
                        meta, ref = self._prefill(list(prompt_token_ids))
                    except BaseException as e:  # noqa: BLE001
                        last = e
                        continue
                    self._bump("prefills")
                    self._bump("handoff_bytes", int(meta.get("nbytes", 0)))
                    self._tel.on_published(int(meta.get("nbytes", 0)))
                    with self._lock:
                        self._inflight[key] = ref
                try:
                    return self._decode(meta, ref, list(prompt_token_ids), sampling_params or {})
                except BaseException as e:  # noqa: BLE001
                    last = e
                    m = migration_of(e)
                    if m is not None and self._resume is not None:
                        # the decode lane was PREEMPTED and checkpointed
                        # this request's live state: switch to the resume
                        # leg. The prefill handoff ref is KEPT — its owner
                        # (the prefill replica) is not the one dying, so
                        # if the checkpoint is lost the retry can still
                        # re-decode from the surviving block instead of
                        # re-prefilling
                        self._bump("migrations")
                        mig = m
                    elif _handoff_lost(e):
                        # block gone before scatter-in (possibly wrapped
                        # in the task layer's TaskError): this ref is
                        # dead weight — drop it and re-prefill
                        self._bump("handoffs_lost")
                        self._tel.on_lost()
                        self._drop(key)
                        meta = ref = None
                    else:
                        # decode lane failure (replica death, transport
                        # cut, or an overloaded/draining replica's shed):
                        # keep the handoff — the block lives in the
                        # PREFILL replica, so a surviving owner lets the
                        # retry skip the re-prefill entirely
                        self._bump("decode_retries")
                        self._tel.on_reused()
            # shared terminal epilogue (serve/overload.py): saturation
            # re-raises the 429 with the replica's backoff hint; real
            # failure falls through to this router's terminal class
            router_terminal(
                last, budget=budget, priority=priority,
                counters=self.stats_counts, lock=self._lock, telemetry=self._tel,
                shed_msg=(
                    f"request shed: every decode lane overloaded/draining after "
                    f"{self.max_attempts} attempts"
                ),
            )
            raise DisaggRequestError(
                f"request failed after {self.max_attempts} attempts "
                f"(last: {type(last).__name__}: {last})"
            ) from last
        finally:
            self._drop(key)

    def _drop(self, key: str):
        """Release the router's borrow of the request's handoff (the owner
        frees the block once the decode side's borrow releases too)."""
        with self._lock:
            self._inflight.pop(key, None)
