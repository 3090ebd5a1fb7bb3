"""Speculation config and the per-request adaptive-k controller (port of
ray_tpu/llm/spec/controller.py, a copy).

The verify step is captured for ONE static width `k` (shapes never
vary); adaptivity is expressed as a per-lane *effective* k lane on
device — acceptance is masked beyond it — driven by a running
acceptance-rate EMA per request. A request whose drafter keeps missing
spends its rounds at `k_min` (bounding wasted verify positions and the
discarded-trailing-round cost); one whose suffix is predictable climbs
back to `k`. This layer is pure host config/state.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SpecConfig:
    """User-facing speculative decoding configuration.

    drafter: "ngram" (prompt-lookup over the sequence's own history —
    zero extra weights) or "model" (a smaller llama proposing greedily
    from its own KV cache; requires ``draft_config`` with the target's
    vocab, optionally ``draft_params``).

    k is the verify program's static width (proposals per round); the
    adaptive controller moves each request's effective k inside
    [k_min, k] on its acceptance EMA. ``ngram`` is the lookup n-gram
    size for the ngram drafter.
    """

    drafter: str = "ngram"
    k: int = 4
    k_min: int = 1
    ngram: int = 3
    adaptive: bool = True
    ema_alpha: float = 0.4  # weight of the newest round's acceptance rate
    raise_at: float = 0.8  # EMA >= raise_at -> effective k += 1
    lower_at: float = 0.3  # EMA < lower_at -> effective k -= 1
    draft_config: object = None  # ray_tpu_torch.models.llama.LlamaConfig
    draft_params: object = None  # optional pretrained draft parameter tree (tensors)
    draft_seed: int = 0

    def __post_init__(self):
        if self.drafter not in ("ngram", "model"):
            raise ValueError(f"drafter must be 'ngram' or 'model', got {self.drafter!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if not 1 <= self.k_min <= self.k:
            # k_min=0 would be a one-way door: a lane at effective k 0
            # proposes nothing, so observe() gets proposed=0 forever and
            # the EMA can never recover — while still paying the full
            # k+1-wide verify forward for 1 token/round
            raise ValueError("k_min must be in [1, k]")
        if self.ngram < 1:
            raise ValueError("ngram must be >= 1")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")


class AdaptiveKController:
    """Per-request acceptance EMA -> effective k in [k_min, k].

    State survives preemption (the request id persists across recompute
    re-admissions) and is dropped on finish via ``forget``.
    """

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self._state: dict[str, list] = {}  # request_id -> [ema | None, k]

    def admit(self, request_id: str) -> int:
        """Effective k for a (re)admitted request: sticky across
        preemptions, cfg.k for a fresh one."""
        return self._state.setdefault(request_id, [None, self.cfg.k])[1]

    def observe(self, request_id: str, proposed: int, accepted: int) -> int:
        """Fold one round's (proposed, accepted) into the EMA; returns the
        (possibly moved) effective k."""
        st = self._state.setdefault(request_id, [None, self.cfg.k])
        if proposed <= 0:
            return st[1]
        rate = accepted / proposed
        st[0] = rate if st[0] is None else self.cfg.ema_alpha * rate + (1.0 - self.cfg.ema_alpha) * st[0]
        if self.cfg.adaptive:
            if st[0] >= self.cfg.raise_at:
                st[1] = min(st[1] + 1, self.cfg.k)
            elif st[0] < self.cfg.lower_at:
                st[1] = max(st[1] - 1, self.cfg.k_min)
        return st[1]

    def export(self, request_id: str) -> tuple | None:
        """(ema, effective_k) for a live request — the sticky state a
        migration checkpoint carries (``llm/migrate.py``) so the restoring
        engine's controller continues where this one left off."""
        st = self._state.get(request_id)
        return None if st is None else (st[0], st[1])

    def restore(self, request_id: str, ema=None, k=None) -> None:
        """Seed a migrated request's sticky state under its (possibly
        new) request id; k clamps into [k_min, k] against THIS engine's
        config (a heterogeneous fleet may run narrower verify widths)."""
        kk = self.cfg.k if k is None else max(self.cfg.k_min, min(int(k), self.cfg.k))
        self._state[request_id] = [None if ema is None else float(ema), kk]

    def forget(self, request_id: str) -> None:
        self._state.pop(request_id, None)

    def current(self) -> dict:
        """{request_id: effective k} for every tracked request."""
        return {rid: st[1] for rid, st in self._state.items()}
