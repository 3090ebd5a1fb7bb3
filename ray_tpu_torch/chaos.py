"""Deterministic fault injection for the serving planes (port of
ray_tpu/chaos.py).

One seeded, rule-based plane whose injection points reach what the
serving fleet's failure semantics depend on. The site table is
ray_tpu's, unchanged, so a test's rules read the same in both packages.
A site whose call site is not ported yet stays in the table; its row
below names the ROADMAP.md queue 1 item that brings the call site:

======================  =================================================
site                    injection point
======================  =================================================
direct.put_owned        owner-local publish on the direct object plane
                        (call site waits for: the object plane)
direct.get_owned_view   borrow-get of an owned object (handoff/prefix/
                        live-state fetch) (the object plane)
handoff.put             disagg/kvplane handoff publish (codec -> owned
                        object) (the object plane)
handoff.fetch           bounded-retry handoff fetch, each ATTEMPT a hit
                        (the object plane)
kvplane.index           every prefix-index call (filter with methods=):
                        ``llm/kvplane/client.py::index_call``
kvplane.prefetch        one predictive-prefetch round of the plane
                        client's worker (the object plane: the client
                        publishes through it)
llm.suspend             ``LLMEngine.suspend_request``'s spill decision: a
                        DROP or raises rule refuses with a typed
                        MigrationError, the conversation still RUNNING
                        and untouched; a delay rule models a slow spill
serve.step              the serve replica's stepper tick (the serve
                        wiring)
serve.preempt           the preemption notice of a serve replica (the
                        serve wiring)
======================  =================================================

Rules (``inject``) can DELAY (sleep inline), DROP (``apply`` returns
False; each site maps a drop onto its native loss signal, e.g. a dropped
``kvplane.index`` call raises ConnectionError into the caller's degrade
path), or RAISE a supplied exception type. ``max_hits`` bounds a rule,
``after`` skips the first N matches, ``methods`` filters multi-method
sites like ``kvplane.index``. ray_tpu's ``rpc.<msg_type>`` namespace is
accepted by ``inject`` as there; its transport adapter
(``core/rpc_chaos.py``) waits for the object plane.

Safety contract, as in ray_tpu:

- **Inert by default.** With no rule installed, ``apply()`` is one
  module-flag check.
- **Unreachable from non-test config.** Nothing under ``ray_tpu_torch/``
  calls ``inject()``/``seed()``; rules come from tests and smoke scripts.
- **Enumerable.** Every ``apply`` call site passes a literal site name
  from ``SITES``.

Determinism: drop and fail draws use one dedicated seeded RNG
(``seed``), so a chaos schedule is a pure function of its seed and call
order. This plane is the port's own: ray_tpu's plane and its rules are
not shared with it.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from ray_tpu_torch.exceptions import serving_error


@serving_error
class ChaosError(RuntimeError):
    """Default injected fault (rules may substitute any exception type)."""


# the fixed injection surface: literal site names at every apply() call
# site. The transport namespace "rpc.<msg_type>" sits on top of it.
SITES = frozenset({
    "direct.put_owned",
    "direct.get_owned_view",
    "handoff.put",
    "handoff.fetch",
    "kvplane.index",
    "kvplane.prefetch",
    "llm.suspend",
    "serve.step",
    "serve.preempt",
})

# site -> typed errors (exceptions.SERVING_ERRORS names) a fault at that
# site may surface as to a caller that exhausts its degradation path
FAULT_MODES: dict[str, tuple[str, ...]] = {
    "direct.put_owned": ("ObjectLostError",),
    "direct.get_owned_view": ("ObjectLostError",),
    "handoff.put": ("HandoffLostError",),
    "handoff.fetch": ("HandoffLostError",),
    "kvplane.index": ("KVRouteError",),
    "kvplane.prefetch": ("ChaosError",),
    "llm.suspend": ("MigrationError",),
    "serve.step": ("StepperDiedError",),
    "serve.preempt": ("RequestMigratedError",),
}

_RPC_PREFIX = "rpc."


@dataclass
class Rule:
    delay_s: float = 0.0
    drop_prob: float = 0.0
    fail_prob: float = 0.0
    raises: object = None  # exception CLASS (instantiated per hit)
    max_hits: int | None = None  # stop applying after this many hits
    after: int = 0  # skip the first N matches (warmup passes clean)
    methods: tuple | None = None  # kvplane.index: restrict to these calls
    hits: int = 0  # matches that applied (delay/drop/fail evaluated)
    seen: int = 0  # matches including ones skipped by `after`


_rules: dict[str, Rule] = {}
_lock = threading.Lock()
_rng = random.Random(0)
# fast-path flag read WITHOUT the lock: no rules installed => apply() is
# a single attribute check. Only mutated under the lock.
_armed = False


def inject(
    site: str,
    *,
    delay_s: float = 0.0,
    drop_prob: float = 0.0,
    fail_prob: float = 0.0,
    raises: object = None,
    max_hits: int | None = None,
    after: int = 0,
    methods=None,
) -> Rule:
    """Install one rule for ``site`` (replacing any existing rule there).
    ``raises`` without ``fail_prob`` means fail on every hit; ``fail_prob``
    without ``raises`` raises ChaosError. Returns the live Rule so tests
    can assert on ``.hits``."""
    global _armed
    if site not in SITES and not site.startswith(_RPC_PREFIX):
        raise ValueError(f"unknown chaos site {site!r}; sites: {sorted(SITES)} or rpc.<msg_type>")
    if raises is not None and fail_prob == 0.0:
        fail_prob = 1.0
    if fail_prob > 0.0 and raises is None:
        raises = ChaosError
    if raises is not None and not (isinstance(raises, type) and issubclass(raises, BaseException)):
        raise TypeError(f"raises must be an exception class, got {raises!r}")
    rule = Rule(
        delay_s=float(delay_s), drop_prob=float(drop_prob), fail_prob=float(fail_prob),
        raises=raises, max_hits=max_hits, after=int(after),
        methods=tuple(methods) if methods else None,
    )
    with _lock:
        _rules[site] = rule
        _armed = True
    return rule


def clear(prefix: str | None = None) -> None:
    """Remove every rule (or just those whose site starts with ``prefix``)."""
    global _armed
    with _lock:
        if prefix is None:
            _rules.clear()
        else:
            for k in [k for k in _rules if k.startswith(prefix)]:
                del _rules[k]
        _armed = bool(_rules)


def seed(n: int = 0) -> None:
    """Re-seed the drop/fail RNG: chaos schedules reproduce from here."""
    global _rng
    with _lock:
        _rng = random.Random(n)


def active() -> bool:
    """True while any rule is installed (the inert-by-default flag)."""
    return _armed


def rules() -> dict[str, Rule]:
    with _lock:
        return dict(_rules)


def apply(site: str, method: str | None = None) -> bool:
    """Evaluate chaos for one event at ``site``. Returns False when the
    event must be DROPPED (the call site maps that onto its native loss
    signal); sleeps inline for delay rules; raises for fail rules. With
    no rules installed this is a single flag check."""
    if not _armed:
        return True
    with _lock:
        rule = _rules.get(site)
        if rule is None:
            return True
        if rule.methods is not None and method not in rule.methods:
            return True
        rule.seen += 1
        if rule.seen <= rule.after:
            return True
        if rule.max_hits is not None and rule.hits >= rule.max_hits:
            return True
        rule.hits += 1
        delay = rule.delay_s
        drop = rule.drop_prob > 0 and _rng.random() < rule.drop_prob
        fail = rule.fail_prob > 0 and (rule.fail_prob >= 1.0 or _rng.random() < rule.fail_prob)
        exc = rule.raises
    if delay > 0:
        time.sleep(delay)
    if fail:
        raise exc(f"chaos: injected fault at {site}" + (f".{method}" if method else ""))
    return not drop
