"""KV handoff codec (port of ray_tpu/llm/disagg/handoff.py): the wire
format between prefill and decode engines.

A handoff is ONE request's prefilled state: the contiguous KV block the
prefill engine extracted (``scatter.py``), the first-token logits, and
the layout metadata the decode side validates before it scatters the
block into its own cache: shapes, dtype, real length, the producer's
bucket width. The wire dict has ray_tpu's keys (``version``, ``kind``,
``n``, ``t_pad``, ``shape``, ``dtype``, ...), and ``dtype`` holds
ray_tpu's names ("bfloat16", "float32", "int8").

Its arrays are host torch tensors: a bf16 block has no numpy dtype
without ``ml_dtypes``. The codec also takes numpy arrays of the dtypes
torch shares with numpy (f32, int8), so ray_tpu's f32 and int8 payloads
decode here as they are.

``publish`` stores a handoff as an owned object on the object plane
(``core/direct.py``: the bytes in a shared-memory segment, the owner this
process) and returns the small (meta, ref) pair that travels to the
router; ``fetch`` borrows it on the decode side, zero-copy, under a
bounded retry budget.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.exceptions import serving_error

HANDOFF_VERSION = 1


@serving_error
class HandoffError(ValueError):
    """Malformed or inconsistent handoff payload (codec-level)."""


@serving_error
class HandoffLostError(RuntimeError):
    """The handoff object vanished before the decode side could scatter
    it in (``fetch``, after its bounded retries)."""


def host_tensor(x) -> torch.Tensor:
    """``x`` (a torch tensor, or a numpy array of a dtype torch shares) as
    a host tensor, without a copy where it already is one."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return torch.as_tensor(x).cpu()


def dtype_name(x) -> str:
    """ray_tpu's name of an array's dtype ("bfloat16", "float32", "int8")
    for a torch tensor or a numpy array."""
    return str(x.dtype).removeprefix("torch.")


def _handoff_span(name: str, payload: dict, t0: float, **attrs) -> None:
    """Record a handoff span under the trace context the wire dict carries
    (no-op unless RT_TRACING=1 and the producer traced)."""
    from ray_tpu_torch.util import tracing

    tr = payload.get("trace")
    if not tracing.enabled() or not isinstance(tr, dict):
        return
    import uuid

    tracing.record_span(
        name, "internal", str(tr["trace_id"]), uuid.uuid4().hex[:16], tr.get("parent_id"),
        int(t0 * 1e9), time.time_ns(), dict(attrs),
    )


def _scale_shape(shape: tuple) -> tuple:
    """Expected wire scale shape [L, kv, T_pad] for a k block [L, T_pad,
    kv, hd]: one f32 per (layer, head, position), position axis last."""
    return (shape[0], shape[2], shape[1])


PREFIX_KIND = "kv_prefix"  # a cluster prefix block (llm/kvplane/): the
# same wire validation, no first-token logits

LIVE_KIND = "live_state"  # live request migration (llm/migrate.py): a
# mid-decode checkpoint's KV half; its wire prompt_token_ids are the
# COVERED tokens (prompt + emitted[:-1], the n attended positions), and
# like a prefix block it carries no logits

# kinds whose wire carries no first-token logits
_NO_LOGITS_KINDS = (PREFIX_KIND, LIVE_KIND)


def encode(kv: dict, *, kind: str = "kv_handoff") -> dict:
    """Engine handoff payload -> self-describing wire dict.

    ``kv`` is the engine's prefill-extract product: k/v [L, T_pad, kv_h,
    hd], logits [vocab] f32, n real tokens, prompt_token_ids, and for an
    int8 producer cache also k_scale/v_scale [L, kv_h, T_pad] f32."""
    k, v = host_tensor(kv["k"]), host_tensor(kv["v"])
    n = int(kv["n"])
    if k.ndim != 4 or k.shape != v.shape:
        raise HandoffError(f"KV block must be [L, T_pad, kv, hd] twins, got k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 0 < n <= k.shape[1]:
        raise HandoffError(f"real length {n} outside block width {k.shape[1]}")
    wire = {
        "version": HANDOFF_VERSION,
        "kind": kind,
        "n": n,
        "t_pad": int(k.shape[1]),
        "shape": tuple(int(d) for d in k.shape),
        "dtype": dtype_name(k),
        "prompt_token_ids": [int(t) for t in kv["prompt_token_ids"]],
        "k": k,
        "v": v,
    }
    if kind not in _NO_LOGITS_KINDS:
        wire["logits"] = host_tensor(kv["logits"]).float()
    # the producer's trace context and submit stamp ride the wire
    if isinstance(kv.get("trace"), dict) and kv["trace"].get("trace_id"):
        wire["trace"] = {"trace_id": str(kv["trace"]["trace_id"]), "parent_id": kv["trace"].get("parent_id")}
    if kv.get("submitted_at") is not None:
        wire["submitted_at"] = float(kv["submitted_at"])
    if (kv.get("k_scale") is not None) != (kv.get("v_scale") is not None):
        raise HandoffError("k_scale and v_scale must be supplied together")
    if kv.get("k_scale") is not None:
        k_sc, v_sc = host_tensor(kv["k_scale"]), host_tensor(kv["v_scale"])
        if dtype_name(k) != "int8":
            raise HandoffError(f"scale tensors supplied for a non-int8 block ({dtype_name(k)})")
        want = _scale_shape(tuple(k.shape))
        if tuple(k_sc.shape) != want or tuple(v_sc.shape) != want:
            raise HandoffError(f"scale shape must be {want} ([L, kv, T_pad]), got k{tuple(k_sc.shape)} "
                               f"v{tuple(v_sc.shape)}")
        if dtype_name(k_sc) != "float32" or dtype_name(v_sc) != "float32":
            raise HandoffError(f"scales must be float32, got k:{dtype_name(k_sc)} v:{dtype_name(v_sc)}")
        wire["k_scale"] = k_sc
        wire["v_scale"] = v_sc
    elif dtype_name(k) == "int8":
        raise HandoffError("int8 block without its per-head scale tensors")
    return wire


def decode(payload: dict, *, kind: str = "kv_handoff") -> dict:
    """Wire dict -> validated engine admission payload (``add_prefilled``
    format, host tensors). Raises HandoffError on anything inconsistent,
    the same checks as ray_tpu's: a truncated or foreign object must never
    scatter garbage into a live pool; an int8 block's scales are checked
    (shape [L, kv, T_pad], float32) with the same severity."""
    if not isinstance(payload, dict) or payload.get("kind") != kind:
        raise HandoffError(f"not a {kind} payload: {type(payload).__name__}")
    if payload.get("version") != HANDOFF_VERSION:
        raise HandoffError(f"handoff version {payload.get('version')} != {HANDOFF_VERSION}")
    k, v = payload["k"], payload["v"]
    shape = tuple(payload["shape"])
    if tuple(k.shape) != shape or tuple(v.shape) != shape:
        raise HandoffError(f"block shape mismatch: meta {shape}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dtype_name(k) != payload["dtype"]:
        raise HandoffError(f"block dtype mismatch: meta {payload['dtype']}, got {dtype_name(k)}")
    n = int(payload["n"])
    prompt = payload["prompt_token_ids"]
    if not 0 < n <= shape[1] or n != len(prompt):
        raise HandoffError(f"length {n} inconsistent with block width {shape[1]} / prompt {len(prompt)}")
    out = {"k": host_tensor(k), "v": host_tensor(v), "n": n, "prompt_token_ids": list(prompt)}
    if kind not in _NO_LOGITS_KINDS:
        out["logits"] = host_tensor(payload["logits"])
    if isinstance(payload.get("trace"), dict) and payload["trace"].get("trace_id"):
        out["trace"] = dict(payload["trace"])
    if payload.get("submitted_at") is not None:
        out["submitted_at"] = float(payload["submitted_at"])
    if payload["dtype"] == "int8":
        k_sc, v_sc = payload.get("k_scale"), payload.get("v_scale")
        if k_sc is None or v_sc is None:
            raise HandoffError("int8 block without its per-head scale tensors")
        want = _scale_shape(shape)
        if tuple(k_sc.shape) != want or tuple(v_sc.shape) != want:
            raise HandoffError(f"scale shape mismatch: expected {want}, got k{tuple(k_sc.shape)} "
                               f"v{tuple(v_sc.shape)}")
        if dtype_name(k_sc) != "float32" or dtype_name(v_sc) != "float32":
            raise HandoffError(f"scale dtype must be float32, got k:{dtype_name(k_sc)} v:{dtype_name(v_sc)}")
        out["k_scale"] = host_tensor(k_sc)
        out["v_scale"] = host_tensor(v_sc)
    elif payload.get("k_scale") is not None or payload.get("v_scale") is not None:
        raise HandoffError(f"scale tensors on a non-int8 block ({payload['dtype']})")
    return out


def meta_of(payload: dict) -> dict:
    """Small router-facing summary of a wire dict (no arrays)."""
    nbytes = int(payload["k"].nbytes + payload["v"].nbytes)
    if payload.get("logits") is not None:
        nbytes += int(payload["logits"].nbytes)
    if payload.get("k_scale") is not None:
        nbytes += int(payload["k_scale"].nbytes + payload["v_scale"].nbytes)
    return {
        "n": payload["n"],
        "t_pad": payload["t_pad"],
        "shape": tuple(payload["shape"]),
        "dtype": payload["dtype"],
        "quantized": payload.get("k_scale") is not None,
        "nbytes": nbytes,
    }


def publish(kv: dict):
    """Encode and store a handoff as an owned object in THIS process.

    Returns (meta, ref): the multi-MB payload stays owner-local (shm for
    anything over the inline threshold) and only the small (meta, ref)
    pair travels back to the router."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core import direct as _direct

    payload = encode(kv)
    t0 = time.time()
    # chaos site: a dropped publish surfaces as the owner-side loss the
    # router's re-prefill path must absorb (inert when unarmed)
    if not chaos.apply("handoff.put"):
        raise HandoffLostError("chaos: handoff publish dropped")
    ref = _direct.put_owned(payload)
    _handoff_span("llm.handoff.put", payload, t0, nbytes=meta_of(payload)["nbytes"])
    return meta_of(payload), ref


def fetch(
    ref, meta: dict | None = None, *, timeout_s: float = 30.0, retries: int = 2,
    retry_wait_s: float = 0.2, kind: str = "kv_handoff",
) -> dict:
    """Borrow-get a published handoff with a bounded retry budget.

    The get decodes zero-copy: the tensors are views into a private,
    copy-on-write mapping of the owner's segment, so the borrow path
    copies no byte and the device upload at scatter-in is the only copy
    the decode side pays. ``retries`` extra attempts absorb transient
    owner-side races; a handoff that is GONE (the owner freed it, or the
    owner process died) raises HandoffLostError after the final attempt:
    a caller never hangs on a dead handoff. ``kind=PREFIX_KIND`` fetches a
    cluster prefix block under the same contract (the KV plane client maps
    the loss to its local-prefill fallback), ``LIVE_KIND`` a checkpoint."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core import direct as _direct
    from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError

    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            t0 = time.time()
            # chaos site, INSIDE the bounded-retry loop: each attempt is one
            # hit, so a max_hits rule can lose the first N attempts and let
            # the retry succeed (or exhaust into HandoffLostError); a drop
            # maps onto the native loss signal
            if not chaos.apply("handoff.fetch"):
                raise ObjectLostError("chaos: handoff fetch dropped")
            value = _direct.get_owned_view(ref.id, timeout=timeout_s)
            payload = decode(value, kind=kind)
            if meta is not None and tuple(meta.get("shape", payload["k"].shape)) != tuple(payload["k"].shape):
                raise HandoffError(f"fetched block {tuple(payload['k'].shape)} does not match routed meta "
                                   f"{meta['shape']}")
            _handoff_span("llm.handoff.fetch", payload, t0, attempts=attempt + 1)
            return payload
        except (ObjectLostError, GetTimeoutError, ConnectionError, FileNotFoundError) as e:
            last = e
            if attempt < retries:
                time.sleep(retry_wait_s)
    raise HandoffLostError(
        f"handoff object {ref.id.hex()[:16]} lost before scatter-in ({retries + 1} attempts): {last}"
    ) from last
