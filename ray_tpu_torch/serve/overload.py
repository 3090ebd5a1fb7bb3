"""Overload-robust serving: admission control, load shedding, drain
(port of ray_tpu/serve/overload.py).

The serving fleet's degradation order under pressure is FIXED:

    shed (lowest request class first)  ->  queue-wait  ->  never decode ITL

``AdmissionController`` bounds admission at a serving ingress: past the
caps a request is REJECTED with a typed ``OverloadedError`` (HTTP 429 and
a retry-after hint) instead of joining a queue that can only grow, so
overload shows up as shed rate and queue wait in the telemetry plane
while in-flight decode lanes keep their ITL.

Everything the controller reads is HOST state: ``engine.host_load()``
(the scheduler's shadow queue, slot and occupancy counters; no device
tensor is read, the telemetry plane's zero-sync rule) and the telemetry
plane's live ITL and service-time EMAs for the estimated-queue-wait
test. The check runs per REQUEST at the ingress, never inside
``engine.step``; the one thing it adds to a step is the gauge refresh it
installs as the telemetry's ``sample_hook``.

Request classes: ``SamplingParams.priority``, 0 = lowest. Each cap is
scaled by the class's fraction (``AdmissionConfig.class_fracs``), so the
lowest class sheds first and the highest class only at the full cap.

``RetryBudget`` is the ONE per-request failover budget the disagg and
kvplane routers both consume; ``router_terminal`` is their shared
terminal epilogue. A draining replica sheds every new request with
``ReplicaDrainingError`` (a 429 subclass: routers fail over exactly as
for overload). The serve replica that drains is ``serve/llm.py``'s
``LLMServer.drain``; ``wait_for_drain`` needs only an object with
``.engine``.

The retry-jitter RNG is ray_tpu's, seed included, so the port's hints
equal ray_tpu's draw for draw.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from ray_tpu_torch.exceptions import SERVING_ERRORS, serving_error

# Jitter for 429 retry hints: every shed client sleeping EXACTLY
# retry_after_s re-arrives as one synchronized herd and re-saturates the
# replica it just backed off from; ±25% spread de-phases them. A
# dedicated seeded RNG (never the global one) keeps shed behavior
# independent of test/chaos seeding while staying deterministic per
# process.
RETRY_JITTER_FRAC = 0.25
_retry_jitter = random.Random(0x52455452)  # "RETR"


@serving_error
class OverloadedError(RuntimeError):
    """Typed admission rejection: the replica (or the whole fleet, when a
    router exhausts its failover budget on overloaded replicas) cannot
    take this request NOW. Maps to HTTP 429; ``retry_after_s`` is the
    ingress's backoff hint (the estimated queue wait, clamped)."""

    def __init__(self, msg: str, *, retry_after_s: float = 1.0, shed_class: int = 0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.shed_class = int(shed_class)


@serving_error
class ReplicaDrainingError(OverloadedError):
    """The replica is draining (finish-in-flight only): routers treat it
    exactly like overload — fail over to another replica, never wait."""


@serving_error
class StepperDiedError(RuntimeError):
    """The replica's stepper thread died mid-flight: every waiter on this
    replica fails with the stepper's traceback as context, and another
    replica can serve the retry (503 + retryable in ``SERVING_ERRORS``).
    Subclasses RuntimeError so pre-taxonomy callers that matched the old
    bare ``RuntimeError("llm stepper died")`` keep working."""


def _causes(e: BaseException | None):
    """Bounded walk of an error's wire-wrapping chain (TaskError's
    ``.cause`` links) — the ONE traversal every typed-error probe below
    shares, so 429 detection, retry hints and class labels can never
    diverge on how deep or which links they follow."""
    for _ in range(8):
        if e is None:
            return
        yield e
        e = getattr(e, "cause", None)


def is_overloaded(e: BaseException | None) -> bool:
    """True when ``e`` is (or wraps) an OverloadedError. Under Serve the
    replica's exception crosses the wire inside TaskError: follow the
    ``.cause`` chain and fall back to the remote traceback string for
    causes that didn't survive pickling (same pattern as the disagg
    router's HandoffLostError detection)."""
    for err in _causes(e):
        if isinstance(err, OverloadedError):
            return True
        tb = getattr(err, "tb_str", "")
        if "OverloadedError" in tb or "ReplicaDrainingError" in tb:
            return True
    return False


def retry_hint_of(e: BaseException | None, default: float = 1.0) -> float:
    """The replica's backoff hint, dug out of a possibly wire-wrapped
    error: the FIRST ``retry_after_s`` along the cause chain (a
    TaskError wrapper has none — the shed replica's real hint sits on
    the wrapped OverloadedError)."""
    for err in _causes(e):
        retry = getattr(err, "retry_after_s", None)
        if retry is not None:
            return float(retry)
    return default


def shed_class_of(e: BaseException | None, default: int = 0) -> int:
    """The CLAMPED request class the shedding replica actually used,
    dug off the cause chain (OverloadedError.shed_class): routers reuse
    it so the shed metric's class label agrees between the replica and
    router stages."""
    for err in _causes(e):
        cls = getattr(err, "shed_class", None)
        if cls is not None:
            return int(cls)
    return default


def http_error_of(e: BaseException | None):
    """(status_code, body) for typed serving errors crossing the HTTP
    proxy, or None for the generic 500 path. Walks the cause chain for a
    real status/retry-after carrier FIRST (the wrapper's traceback
    string must not shadow a surviving cause's hint), then falls back to
    the remote traceback text for causes that didn't survive pickling.
    Both passes are table-driven off ``exceptions.SERVING_ERRORS``: the
    attr pass reads the ``status_code``/``retryable`` the
    ``@serving_error`` decorator stamped, the traceback pass scans for
    ANY registered class name — adding a typed error to the table is the
    whole job, no proxy ladder to extend."""
    for err in _causes(e):
        code = getattr(err, "status_code", None)
        if code is not None:
            body = {"error": str(err)}
            retry = getattr(err, "retry_after_s", None)
            if retry is not None:
                body["retry_after_s"] = round(float(retry), 3)
            return int(code), body
    for err in _causes(e):
        tb = getattr(err, "tb_str", "")
        if not tb:
            continue
        for name, spec in SERVING_ERRORS.items():
            if name in tb:
                body = {"error": str(err)}
                if spec.retryable:
                    body["retry_after_s"] = 1.0
                return spec.status_code, body
    return None


@dataclass
class AdmissionConfig:
    """Per-replica admission caps. Every cap reads host shadow state;
    each is scaled by the request class's fraction so lower classes shed
    first (``frac``). ``enabled=False`` keeps the controller counting but
    admits everything (a baseline arm to measure shedding against)."""

    enabled: bool = True
    # waiting requests (engine admission queue) before shedding
    max_queue_depth: int = 64
    # KV-occupancy cap, measured as BACKLOG: (occupied + queued-demand
    # tokens) / cache token capacity. Queued demand counts prompt +
    # max_tokens, so the ratio keeps growing with the queue — a cache
    # merely full of live sequences (ratio ~1) is healthy, a cache whose
    # backlog is several times its capacity is not.
    max_kv_backlog: float = 4.0
    # estimated queue wait (see AdmissionController.estimate_queue_wait_s)
    max_queue_wait_s: float = 30.0
    # optional headroom reservation: shed class c once slots_in_use /
    # slots_total >= max_slot_occupancy * frac(c). None (default) = off —
    # full slot occupancy is the NORMAL state of a healthy saturated
    # replica. Opt in when latency-sensitive classes must keep decoding
    # without prefill interference from backfilled low-class admissions.
    max_slot_occupancy: float | None = None
    # per-class fraction of every cap: priority 0 sheds at frac[0] of
    # each cap, the top class only at the full cap. Priorities beyond
    # the tuple clamp to the last entry.
    class_fracs: tuple = (0.5, 0.75, 1.0)

    def class_index(self, priority: int) -> int:
        """The ONE mapping from raw (client-supplied) priority to the
        clamped class index the caps, counters, and metric labels all
        use — so they can never drift apart."""
        return max(0, min(int(priority), len(self.class_fracs) - 1))

    def frac(self, priority: int) -> float:
        return float(self.class_fracs[self.class_index(priority)])


class AdmissionController:
    """Bounded admission at one serving replica's ingress.

    ``check(priority)`` either returns (admitted) or raises a typed
    ``OverloadedError``/``ReplicaDrainingError``. All inputs are host
    shadow state: ``engine.host_load()`` and the telemetry plane's live
    EMAs (``EngineTelemetry.itl_ema_s`` / ``service_ema_s``, fed by the
    flight recorder's drain-path stamps). Telemetry off (engine built
    with telemetry=False) degrades gracefully: the wait estimate is 0
    and only the depth/backlog caps apply."""

    def __init__(self, engine, cfg: AdmissionConfig | None = None):
        self.engine = engine
        self.cfg = cfg if cfg is not None else AdmissionConfig()
        self._lock = threading.Lock()
        self.counts = {  # guarded-by: _lock
            "admitted": 0, "shed_depth": 0, "shed_backlog": 0,
            "shed_wait": 0, "shed_slots": 0, "shed_draining": 0,
        }
        self.shed_by_class: dict[int, int] = {}  # guarded-by: _lock
        self._draining = False
        # pre-bound metric handles (llm/telemetry.py catalog); shed-class
        # handles bind lazily (class cardinality is tiny)
        self._tel = getattr(engine, "_tel", None)
        self._b_shed: dict[str, object] = {}
        self._b_wait = self._b_drain = None
        if self._tel is not None:
            from ray_tpu_torch.llm.telemetry import instruments

            m = instruments()
            self._m_shed = m["rt_llm_requests_shed_total"]
            self._b_wait = m["rt_llm_admission_queue_wait_est_ms"].bind(self._tel.tags)
            self._b_drain = m["rt_llm_drain_state"].bind(self._tel.tags)
            self._b_drain.set(0.0)
            # keep the wait-estimate gauge LIVE between admissions: the
            # telemetry sample tick refreshes it from the current queue
            # depth (service-path estimate only — the tick runs under
            # the engine lock, so no host_load() re-entry), so the panel
            # decays as the queue drains instead of freezing at its peak
            self._tel.sample_hook = self._refresh_wait_gauge

    def _refresh_wait_gauge(self, queue_depth: int) -> None:
        """Telemetry sample-tick hook: re-estimate from the live queue
        depth without taking the engine lock (on_step already holds it)."""
        if self._b_wait is not None and self._tel is not None:
            est = queue_depth * self._tel.service_ema_s / max(self.engine.max_num_seqs, 1)
            self._b_wait.set(round(est * 1e3, 3))

    # -- drain lifecycle ---------------------------------------------------
    def drain(self) -> None:
        """Stop admitting: every new request sheds with
        ReplicaDrainingError (drain-state gauge -> 1)."""
        self._draining = True
        if self._b_drain is not None:
            self._b_drain.set(1.0)

    def drained(self) -> None:
        """In-flight work finished and resources released (gauge -> 2)."""
        if self._b_drain is not None:
            self._b_drain.set(2.0)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- the admission test ------------------------------------------------
    def estimate_queue_wait_s(self, load: dict | None = None) -> float:
        """Expected time a request admitted NOW spends waiting for a
        slot, from the flight recorder's TWO live EMAs: the queue drains
        one request per slot-turnover (queue_depth x per-request
        service-time EMA) and, independently, must decode its queued
        token demand (live ITL EMA x queued max_tokens) — the max of the
        two paths, divided by the slots draining in parallel. The ITL
        path covers the cold window where nothing has finished yet but
        tokens are already flowing. 0 when telemetry is off or both EMAs
        are still empty."""
        tel = self._tel
        if tel is None:
            return 0.0
        if load is None:
            load = self.engine.host_load()
        service_path = load["queue_depth"] * tel.service_ema_s
        itl_path = load.get("queued_gen_tokens", 0) * tel.itl_ema_s
        return max(service_path, itl_path) / max(load["slots_total"], 1)

    def _shed(self, reason: str, priority: int, est_wait: float):
        # the CLASS (clamped, exactly what the admission arithmetic used)
        # keys the counters and the metric label — raw client-supplied
        # priorities must never mint unbounded label cardinality
        cls_ix = self.cfg.class_index(priority)
        with self._lock:
            self.counts["shed_" + reason] += 1
            self.shed_by_class[cls_ix] = self.shed_by_class.get(cls_ix, 0) + 1
        cls = str(cls_ix)
        if self._tel is not None:
            h = self._b_shed.get(cls)
            if h is None:
                h = self._b_shed[cls] = self._m_shed.bind({**self._tel.tags, "class": cls})
            h.inc(1.0)
        base = min(max(est_wait, 0.25), 30.0)
        retry = base * (1.0 + _retry_jitter.uniform(-RETRY_JITTER_FRAC, RETRY_JITTER_FRAC))
        err_cls = ReplicaDrainingError if reason == "draining" else OverloadedError
        # shed_class carries the CLAMPED class (what the admission
        # arithmetic used) so routers re-counting the shed label it
        # identically to this replica's own metric
        raise err_cls(
            f"replica overloaded ({reason}): request class {priority} shed; "
            f"retry after ~{retry:.2f}s",
            retry_after_s=retry,
            shed_class=cls_ix,
        )

    def check(self, priority: int = 0) -> None:
        """Admit or raise. Reads one host_load() snapshot; updates the
        queue-wait-estimate gauge so the dashboard shows the admission
        plane's view of pressure even between sheds."""
        if self._draining:
            self._shed("draining", priority, 2.0)
        cfg = self.cfg
        load = self.engine.host_load()
        est_wait = self.estimate_queue_wait_s(load)
        if self._b_wait is not None:
            self._b_wait.set(round(est_wait * 1e3, 3))
        if not cfg.enabled:
            with self._lock:
                self.counts["admitted"] += 1
            return
        frac = cfg.frac(priority)
        if load["queue_depth"] >= cfg.max_queue_depth * frac:
            self._shed("depth", priority, est_wait)
        backlog = (load["occupied_tokens"] + load["queued_tokens"]) / max(load["capacity_tokens"], 1)
        if backlog >= cfg.max_kv_backlog * frac:
            self._shed("backlog", priority, est_wait)
        if est_wait >= cfg.max_queue_wait_s * frac:
            self._shed("wait", priority, est_wait)
        if cfg.max_slot_occupancy is not None:
            slot_occ = load["slots_in_use"] / max(load["slots_total"], 1)
            if slot_occ >= cfg.max_slot_occupancy * frac:
                self._shed("slots", priority, est_wait)
        with self._lock:
            self.counts["admitted"] += 1

    def check_capacity(self) -> None:
        """Class-blind admission at the FULL caps — for ingresses that do
        not know the request class (the disagg prefill replica: the
        class-aware shed already ran at the router/decode ingress)."""
        self.check(len(self.cfg.class_fracs) - 1)

    def stats(self) -> dict:
        # estimate BEFORE taking the lock: it may fall through to
        # engine.host_load(), which waits on the ENGINE lock (held for
        # whole serving steps) — computing it under self._lock would stall
        # every ingress check()/record_outcome() behind a step boundary
        wait_est = round(self.estimate_queue_wait_s(), 4)
        with self._lock:
            return {
                **self.counts,
                "shed_by_class": dict(self.shed_by_class),
                "draining": self._draining,
                "queue_wait_est_s": wait_est,
            }


def router_terminal(last, *, budget, priority: int, counters: dict, lock,
                    telemetry=None, shed_msg: str) -> None:
    """The ONE terminal epilogue both routers run when their failover
    loop ends without success (the second half of the shared-budget
    policy — keeping it here means the disagg and kvplane routers can
    never drift):

    - budget exhaustion (vs. the ranked list merely running out on a
      small fleet) counts into ``budget_exhausted`` + the telemetry
      counter;
    - when the LAST failure was itself a shed, the request was gracefully
      load-shed, not broken: count ``shed`` (never ``failed`` — a
      deliberate shedding event must not read as an error-rate spike)
      and RAISE OverloadedError with the replica's dug-out backoff hint;
    - otherwise count ``failed`` + the error-finish metric and RETURN so
      the caller raises its own terminal class.
    """
    if budget.remaining == 0:
        budget.exhaust()
        with lock:
            counters["budget_exhausted"] += 1
    if is_overloaded(last):
        # re-use the shedding replica's CLAMPED class so the router- and
        # replica-stage shed series label the same traffic identically;
        # when the attribute was lost in wire pickling (tb_str-only
        # detection), clamp with the DEFAULT class count — the router
        # cannot know a non-default replica config, but agrees with every
        # default-config replica
        cls = shed_class_of(last, default=AdmissionConfig().class_index(priority))
        with lock:
            counters["shed"] += 1
        if telemetry is not None:
            telemetry.on_shed(cls)
        raise OverloadedError(
            shed_msg, retry_after_s=retry_hint_of(last), shed_class=cls
        ) from last
    with lock:
        counters["failed"] += 1
    if telemetry is not None:
        telemetry.on_failed()


class RetryBudget:
    """Per-request cross-replica failover budget, shared by the disagg
    and kvplane routers (one policy, one exhaustion counter). Every
    ATTEMPT — first try included — spends one unit; ``exhaust()`` is the
    router's terminal-failure hook (counts into
    ``rt_llm_retry_budget_exhausted_total`` when telemetry is wired)."""

    def __init__(self, attempts: int, telemetry=None):
        self.attempts = max(1, int(attempts))
        self.spent = 0
        self._tel = telemetry

    def try_spend(self) -> bool:
        if self.spent >= self.attempts:
            return False
        self.spent += 1
        return True

    @property
    def remaining(self) -> int:
        return self.attempts - self.spent

    def exhaust(self) -> None:
        if self._tel is not None:
            try:
                self._tel.on_budget_exhausted()
            except Exception:  # noqa: BLE001 — telemetry accounting is never load-bearing; failing it must not fail the request path
                pass


def wait_for_drain(server, timeout_s: float = 30.0, poll_s: float = 0.02) -> bool:
    """Poll a serving replica's engine until in-flight work settles (the
    drain loop's bounded wait, shared by drain() and tests)."""
    deadline = time.time() + timeout_s
    while server.engine.has_unfinished():
        if time.time() >= deadline:
            return False
        time.sleep(poll_s)
    return True
