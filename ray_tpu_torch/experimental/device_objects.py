"""Device objects: pass tensors on the card between tasks and actors by
reference (port of ray_tpu/experimental/device_objects.py).

- In the owning process, a ``DeviceRef`` resolves to the registered
  tensor itself: no copy, no host traffic. The runtime's worker reuse and
  actor affinity make this the common case (weights shared between an
  engine and its replica, or between calls to one GPU actor).
- Across processes, the owner exports once through the object plane: a
  host copy (``.cpu()``, same dtype: a tensor and not a numpy array,
  because numpy has no bf16) returned by the owner's builtin
  ``__rt_device_get__`` rides out of band into a shared-memory segment;
  the consumer moves it onto its device and caches it, so a second
  resolve returns the same object. The owner must be an actor: it has to
  be alive to serve the transfer.

Same-card CUDA IPC would skip the host, but it aliases the owner's memory
where ray_tpu copies; it is held for a later change (ROADMAP.md).

    ref = device_put_object(t)            # register, no copy
    t = device_get(ref)                   # owner process: the same object
    t = device_get(ref)                   # elsewhere: one transfer, cached
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import dataclass, field

import torch

_lock = threading.Lock()
_registry: dict[str, torch.Tensor] = {}  # id -> tensor (this process's objects)
_transfer_cache: dict[str, torch.Tensor] = {}  # id -> fetched copy (consumer side)
FETCH_TIMEOUT_S = 600.0  # one leaf's export and transfer


@dataclass(frozen=True)
class DeviceRef:
    """Handle to a tensor registered in some process's registry."""

    object_id: str
    owner_pid: int
    shape: tuple
    dtype: str
    owner_actor: object = field(default=None, compare=False)

    def __repr__(self):
        return f"DeviceRef({self.object_id[:8]}, pid={self.owner_pid}, {self.dtype}{list(self.shape)})"


def device_put_object(t, owner_actor=None) -> DeviceRef:
    """Register a tensor in this process's registry. ``owner_actor``:
    this actor's own handle, if the ref will be resolved in other
    processes (they fetch through it)."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    obj_id = uuid.uuid4().hex
    with _lock:
        _registry[obj_id] = t
    return DeviceRef(object_id=obj_id, owner_pid=os.getpid(), shape=tuple(t.shape),
                     dtype=str(t.dtype).removeprefix("torch."), owner_actor=owner_actor)


def _default_device() -> torch.device:
    from ray_tpu_torch.llm.engine import resolve_device

    return resolve_device(None)


def device_get(ref: DeviceRef, device=None):
    """Resolve a DeviceRef to a tensor. The registered object in the
    owner process; elsewhere one transfer onto ``device`` (the card
    unless the caller passes ``device="cpu"``), cached in process."""
    if ref.owner_pid == os.getpid():
        with _lock:
            try:
                return _registry[ref.object_id]
            except KeyError:
                raise KeyError(f"device object {ref.object_id[:8]} freed or unknown") from None
    with _lock:
        hit = _transfer_cache.get(ref.object_id)
    if hit is not None:
        return hit
    if ref.owner_actor is None:
        raise ValueError(
            "DeviceRef is being resolved outside its owner process but carries "
            "no owner_actor handle; pass owner_actor= to device_put_object"
        )
    import ray_tpu_torch

    dev = _default_device() if device is None else torch.device(device)
    host = ray_tpu_torch.get(ref.owner_actor.__rt_device_get__.remote(ref.object_id), timeout=FETCH_TIMEOUT_S)
    t = host.to(dev)
    with _lock:
        # two threads may race on one ref: keep the first copy
        t = _transfer_cache.setdefault(ref.object_id, t)
    return t


def free_device_object(ref: DeviceRef):
    """Drop this process's registry and cache entries for the ref."""
    with _lock:
        _registry.pop(ref.object_id, None)
        _transfer_cache.pop(ref.object_id, None)


def export_for_transfer(object_id: str) -> torch.Tensor:
    """The owner's export (the builtin actor method ``__rt_device_get__``,
    core/worker_main.py): a host copy of the same dtype, which the
    runtime's return path writes into shared memory out of band."""
    with _lock:
        t = _registry.get(object_id)
    if t is None:
        raise KeyError(f"device object {object_id} not registered in this process (freed or unknown)")
    return t.detach().cpu()


# ----------------------------------------------------------------------
# trees: register and resolve whole parameter trees
# ----------------------------------------------------------------------
def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and tuples (a
    namedtuple keeps its type); everything else is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, is_leaf)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def device_put_tree(tree, owner_actor=None):
    return tree_map(lambda t: device_put_object(t, owner_actor=owner_actor), tree)


def device_get_tree(tree_of_refs, device=None):
    return tree_map(lambda r: device_get(r, device), tree_of_refs, is_leaf=lambda x: isinstance(x, DeviceRef))
