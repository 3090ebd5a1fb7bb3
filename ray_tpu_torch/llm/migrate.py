"""Live request migration (port of ray_tpu/llm/migrate.py): a request's
mid-decode state as a versioned, validated dict.

The unit of migration is a **live_state** dict: one request's complete
resumable state —

- the KV block covering every attended position (``extract_sequence`` /
  ``gather_pages``, the disagg extracts; an int8 cache ships int8 values
  and per-head scales, which a peer of either cache dtype takes through
  the requantizing inserts),
- the emitted tokens (and logprobs) the client has already seen,
- the lane's live PRNG key (a seeded lane carries its ADVANCED key, never
  a reset), as two uint32 words, ray_tpu's layout: the port's lane keys
  are int64 words masked to 32 bits (``prng.py``) and convert on the way
  out and in (``key_to_wire``, ``key_from_wire``),
- the sampling parameters, and the speculative controller's sticky
  (acceptance EMA, effective k) when speculation is on.

**Splice-dedup contract.** ``LLMEngine.checkpoint_request`` first settles
the one-step-delayed emission (the step in flight drains), so the
checkpoint holds every token the device has minted; the peer's
``restore_request`` binds the last emitted token as the next decode
input and emits NOTHING at admission. The stream can neither repeat nor
drop a token across the splice.

Its second consumer is the conversation tier: ``suspend_request`` spills
an idle conversation's state to host memory through the same dict and
``resume_suspended`` scatters it back in.

``publish`` stores a checkpoint as an owned object on the object plane
(``core/direct.py``) and returns (meta, ref); ``fetch`` borrows it on the
peer with a bounded retry budget (``LLMEngine.restore_request`` takes the
ref directly).
"""

from __future__ import annotations

import time

import numpy as np

from ray_tpu_torch.exceptions import serving_error
from ray_tpu_torch.llm.disagg import handoff as _handoff
from ray_tpu_torch.llm.sampling import SamplingParams

LIVE_STATE_VERSION = 1
LIVE_KIND = _handoff.LIVE_KIND


@serving_error
class MigrationError(ValueError):
    """Malformed/inconsistent live_state payload, or a request whose
    state cannot be checkpointed (streaming consumer, prefill-only stub,
    sampled request with no live lane key)."""


@serving_error
class MigrationLostError(RuntimeError):
    """The published checkpoint vanished before a peer could fetch it
    (``fetch``, after its bounded retries)."""


@serving_error
class RequestMigratedError(RuntimeError):
    """Typed signal a migrating replica hands each in-flight waiter: the
    request did not fail — its live state was checkpointed and published,
    and ``migration_ref``/``migration_meta`` let a router resume it on a
    peer with zero recomputed tokens."""

    def __init__(self, request_id: str, meta: dict, ref):
        super().__init__(
            f"request {request_id} migrated: live decode state published "
            f"({meta.get('nbytes', 0)} bytes, {meta.get('emitted', 0)} tokens emitted); "
            "resume on a peer via resume_from_migration"
        )
        self.request_id = str(request_id)
        self.migration_meta = dict(meta)
        self.migration_ref = ref


def _causes(e):
    """Bounded walk of an error's wire-wrapping chain (``.cause`` links)."""
    for _ in range(8):
        if e is None:
            return
        yield e
        e = getattr(e, "cause", None)


def migration_of(e) -> tuple | None:
    """(request_id, meta, ref) when ``e`` is (or wraps) a
    RequestMigratedError whose checkpoint ref survived the wire; None
    otherwise."""
    for err in _causes(e):
        ref = getattr(err, "migration_ref", None)
        if ref is not None:
            return (
                getattr(err, "request_id", ""),
                dict(getattr(err, "migration_meta", None) or {}),
                ref,
            )
    return None


def migration_lost(e) -> bool:
    """True when ``e`` is (or wraps) a lost/invalid checkpoint: the resume
    leg is dead and a router must fall back to re-prefill."""
    for err in _causes(e):
        if isinstance(err, (MigrationLostError, MigrationError)):
            return True
        tb = getattr(err, "tb_str", "")
        if "MigrationLostError" in tb or "MigrationError" in tb:
            return True
    return False


def key_to_wire(lane_key) -> np.ndarray:
    """A lane key (two uint32 words held as int64, ``prng.py``) as the
    wire's uint32 [2]."""
    return np.asarray(lane_key, np.int64).astype(np.uint32)


def key_from_wire(key) -> np.ndarray:
    """The wire's uint32 [2] key as the port's int64 lane words."""
    return np.asarray(key, np.uint32).astype(np.int64)


def _sampling_to_wire(p: SamplingParams) -> dict:
    return {
        "max_tokens": int(p.max_tokens),
        "temperature": float(p.temperature),
        "top_k": int(p.top_k),
        "top_p": float(p.top_p),
        "stop_token_ids": [int(t) for t in p.stop_token_ids],
        "seed": None if p.seed is None else int(p.seed),
        "logprobs": bool(p.logprobs),
        "priority": int(p.priority),
    }


def params_of(state: dict) -> SamplingParams:
    """Reconstruct (and validate: SamplingParams raises on garbage) the
    request's sampling params from a live_state dict."""
    sp = dict(state.get("sampling") or {})
    if not isinstance(sp.get("max_tokens"), int):
        raise MigrationError(f"live_state sampling block malformed: {sp!r}")
    sp["stop_token_ids"] = tuple(int(t) for t in sp.get("stop_token_ids", ()))
    try:
        return SamplingParams(**sp)
    except (TypeError, ValueError) as e:
        raise MigrationError(f"live_state sampling params invalid: {e}") from e


def check_state(state: dict) -> dict:
    """Validate an engine-facing live_state dict (the decode product, or
    a checkpoint handed over in-process). Raises MigrationError on
    anything inconsistent; returns the state for chaining."""
    if not isinstance(state, dict) or state.get("kind") != LIVE_KIND:
        raise MigrationError(f"not a live_state payload: {type(state).__name__}")
    prompt = state.get("prompt_token_ids")
    emitted = state.get("emitted_token_ids")
    if not isinstance(prompt, list) or not prompt:
        raise MigrationError("live_state without prompt_token_ids")
    if not isinstance(emitted, list):
        raise MigrationError("live_state without emitted_token_ids")
    params_of(state)
    hot = state.get("k") is not None
    if hot:
        if not emitted:
            raise MigrationError("hot live_state with zero emitted tokens (nothing to splice)")
        n = int(state.get("n", -1))
        if n != len(prompt) + len(emitted) - 1:
            raise MigrationError(
                f"live_state KV length {n} != prompt ({len(prompt)}) + emitted "
                f"({len(emitted)}) - 1 — the last emitted token's KV is minted by the "
                "peer's first decode step"
            )
        if n > state["k"].shape[1]:
            raise MigrationError(f"KV length {n} outside block width {state['k'].shape[1]}")
        key = state.get("rng_key")
        if key is None or np.asarray(key).dtype != np.uint32 or np.asarray(key).ndim != 1:
            raise MigrationError("hot live_state needs its lane's uint32 PRNG key data")
    spec = state.get("spec")
    if spec is not None and not isinstance(spec, dict):
        raise MigrationError(f"live_state spec block malformed: {spec!r}")
    return state


def encode(state: dict) -> dict:
    """Engine-facing live_state -> self-describing wire dict.

    The KV block half rides the handoff codec (kind=live_state): its
    ``prompt_token_ids`` on the wire are the COVERED tokens (prompt +
    emitted[:-1], the ``n`` positions the block holds), so the handoff
    layer's length/shape/scale validation applies unchanged. The live half
    (emitted stream, PRNG key, sampling, spec state) travels under
    ``live``."""
    check_state(state)
    prompt = [int(t) for t in state["prompt_token_ids"]]
    emitted = [int(t) for t in state["emitted_token_ids"]]
    live = {
        "version": LIVE_STATE_VERSION,
        "n_prompt": len(prompt),
        "emitted_token_ids": emitted,
        "emitted_logprobs": [float(x) for x in state.get("emitted_logprobs", [])],
        "sampling": dict(state["sampling"]),
        "spec": None if state.get("spec") is None else dict(state["spec"]),
    }
    if state.get("k") is not None:
        covered = prompt + emitted[:-1]
        block = {"k": state["k"], "v": state["v"], "n": int(state["n"]), "prompt_token_ids": covered}
        for extra in ("k_scale", "v_scale", "trace", "submitted_at"):
            if state.get(extra) is not None:
                block[extra] = state[extra]
        try:
            wire = _handoff.encode(block, kind=LIVE_KIND)
        except _handoff.HandoffError as e:
            raise MigrationError(str(e)) from e
        live["rng_key"] = np.asarray(state["rng_key"], np.uint32)
    else:
        # cold checkpoint (the request was waiting: no bound lane, no KV):
        # the peer re-admits prompt+generated like a recompute preemption
        wire = {"version": _handoff.HANDOFF_VERSION, "kind": LIVE_KIND, "prompt_token_ids": prompt}
        if state.get("trace") is not None:
            wire["trace"] = dict(state["trace"])
        if state.get("submitted_at") is not None:
            wire["submitted_at"] = float(state["submitted_at"])
    wire["live"] = live
    return wire


def decode(wire: dict) -> dict:
    """Wire dict -> validated engine-facing live_state (the
    ``restore_request`` input). MigrationError on anything inconsistent: a
    truncated block, a foreign kind, drifted versions, a coverage mismatch
    between the block and the emitted stream."""
    if not isinstance(wire, dict) or wire.get("kind") != LIVE_KIND:
        raise MigrationError(f"not a {LIVE_KIND} wire payload: {type(wire).__name__}")
    live = wire.get("live")
    if not isinstance(live, dict) or live.get("version") != LIVE_STATE_VERSION:
        raise MigrationError(
            f"live_state version {None if not isinstance(live, dict) else live.get('version')} "
            f"!= {LIVE_STATE_VERSION}"
        )
    emitted = [int(t) for t in live.get("emitted_token_ids", [])]
    n_prompt = int(live.get("n_prompt", 0))
    if n_prompt < 1:
        raise MigrationError(f"live_state n_prompt {n_prompt} invalid")
    state = {
        "kind": LIVE_KIND,
        "emitted_token_ids": emitted,
        "emitted_logprobs": [float(x) for x in live.get("emitted_logprobs", [])],
        "sampling": dict(live.get("sampling") or {}),
        "spec": None if live.get("spec") is None else dict(live["spec"]),
    }
    if wire.get("k") is not None:
        try:
            block = _handoff.decode(wire, kind=LIVE_KIND)
        except _handoff.HandoffError as e:
            raise MigrationError(str(e)) from e
        covered = [int(t) for t in block["prompt_token_ids"]]
        if n_prompt > len(covered) or covered[n_prompt:] != emitted[:-1]:
            raise MigrationError(
                "live_state coverage mismatch: the KV block's covered tokens do not "
                "equal prompt + emitted[:-1]"
            )
        state["prompt_token_ids"] = covered[:n_prompt]
        state.update(k=block["k"], v=block["v"], n=int(block["n"]))
        if block.get("k_scale") is not None:
            state.update(k_scale=block["k_scale"], v_scale=block["v_scale"])
        # keep the wire dtype as it is: check_state REJECTS a non-uint32 key
        state["rng_key"] = None if live.get("rng_key") is None else np.asarray(live["rng_key"])
        for extra in ("trace", "submitted_at"):
            if block.get(extra) is not None:
                state[extra] = block[extra]
    else:
        prompt = [int(t) for t in wire.get("prompt_token_ids", [])]
        if len(prompt) != n_prompt:
            raise MigrationError(f"cold live_state prompt length {len(prompt)} != n_prompt {n_prompt}")
        state["prompt_token_ids"] = prompt
        for extra in ("trace", "submitted_at"):
            if wire.get(extra) is not None:
                state[extra] = wire[extra]
    return check_state(state)


def meta_of(state: dict) -> dict:
    """Small router-facing summary (no arrays) of a live_state dict."""
    hot = state.get("k") is not None
    return {
        "kind": LIVE_KIND,
        "hot": hot,
        "n": int(state.get("n", 0)) if hot else 0,
        "emitted": len(state.get("emitted_token_ids", [])),
        "prompt_tokens": len(state.get("prompt_token_ids", [])),
        "nbytes": state_nbytes(state),
    }


def state_nbytes(state: dict) -> int:
    """KV payload size of a live_state dict (0 for a cold checkpoint): the
    spill and transfer accounting both consumers report."""
    if state.get("k") is None:
        return 0
    nbytes = int(state["k"].nbytes + state["v"].nbytes)
    if state.get("k_scale") is not None:
        nbytes += int(state["k_scale"].nbytes + state["v_scale"].nbytes)
    return nbytes


def publish(state: dict):
    """Encode a checkpoint and store it as an owned object in THIS
    process. Returns (meta, ref): only the small pair travels to the
    router; the bytes stay owner-local until a peer's fetch borrows them.
    The object lives as long as the dying replica does: a fetch that
    arrives too late sees MigrationLostError, and the leak backstop
    reclaims a checkpoint nobody fetched."""
    from ray_tpu_torch.core import direct as _direct

    wire = encode(state)
    ref = _direct.put_owned(wire)
    return meta_of(state), ref


def fetch(ref, meta: dict | None = None, *, timeout_s: float = 10.0, retries: int = 2,
          retry_wait_s: float = 0.2) -> dict:
    """Borrow-get a published checkpoint with a bounded retry budget and
    full wire validation. A checkpoint that is GONE (its owner exited: the
    normal case of a late fetch after a preemption) raises
    MigrationLostError after the final attempt; a caller never hangs on a
    dead replica's state."""
    from ray_tpu_torch.core import direct as _direct
    from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError

    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            t0 = time.time()
            value = _direct.get_owned_view(ref.id, timeout=timeout_s)
            state = decode(value)
            if meta is not None and meta.get("emitted") is not None and int(meta["emitted"]) != len(
                    state["emitted_token_ids"]):
                raise MigrationError(f"fetched checkpoint emitted count {len(state['emitted_token_ids'])} does not "
                                     f"match routed meta {meta['emitted']}")
            _handoff._handoff_span("llm.migrate.fetch", value, t0, attempts=attempt + 1)
            return state
        except (ObjectLostError, GetTimeoutError, ConnectionError, FileNotFoundError) as e:
            last = e
            if attempt < retries:
                time.sleep(retry_wait_s)
    raise MigrationLostError(
        f"live_state checkpoint {ref.id.hex()[:16]} lost before restore ({retries + 1} attempts): {last}"
    ) from last
