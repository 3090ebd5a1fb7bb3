"""Checkpoint save and restore of a tree of tensors (port of
ray_tpu/train/jax_checkpoint.py: the module's name and functions, with
torch state where ray_tpu writes jax arrays through orbax).

A tree is a nested dict (or list) of tensors and plain values: the
parameters, an optimizer's ``state_dict()``, a step count. It is written
with ``torch.save`` to ``<path>/state`` and read back with
``torch.load`` onto the device the caller names. ``async_save=True``
copies the tensors to host memory first, then writes from a thread and
returns a handle whose ``wait_until_finished()`` joins it (commit the
checkpoint after that). Sharded restores (``shardings=``) wait for the
port's multi-device axes.
"""

from __future__ import annotations

import os
import threading

import torch

from ray_tpu_torch.core.context import MESH_ITEM

_STATE = "state"


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class AsyncSave:
    """The handle of an asynchronous save."""

    def __init__(self, target, args):
        self.error: BaseException | None = None

        def run():
            try:
                target(*args)
            except BaseException as e:  # noqa: BLE001
                self.error = e

        self._thread = threading.Thread(target=run, name="rt-ckpt-save", daemon=True)
        self._thread.start()

    def wait_until_finished(self, timeout: float | None = None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the checkpoint write did not finish within {timeout} s")
        if self.error is not None:
            raise self.error


def _write(host_tree, out: str):
    tmp = out + ".tmp"
    torch.save(host_tree, tmp)
    os.replace(tmp, out)


def save_pytree(path: str, tree, *, async_save: bool = False):
    """Save ``tree`` into ``path``; with ``async_save`` return the
    ``AsyncSave`` handle to wait on before the checkpoint is committed."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    host = _to_host(tree)
    out = os.path.join(path, _STATE)
    if async_save:
        return AsyncSave(_write, (host, out))
    _write(host, out)
    return None


def _check_like(got, want, where="tree"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: the checkpoint's keys {sorted(map(str, got)) if isinstance(got, dict) else got!r}"
                             f" differ from the target's {sorted(map(str, want))}")
        for k in want:
            _check_like(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{where}: the checkpoint holds {got!r}, the target a sequence of {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
            desc = (tuple(got.shape), got.dtype) if isinstance(got, torch.Tensor) else type(got).__name__
            raise ValueError(f"{where}: the checkpoint holds {desc}, the target {(tuple(want.shape), want.dtype)}")


def restore_pytree(path: str, *, target=None, device=None, shardings=None):
    """Load the tree saved under ``path`` onto ``device`` (None: the card,
    raising where there is none; "cpu": the host). With ``target`` the
    tree's structure, shapes and dtypes must equal the target's."""
    if shardings is not None:
        raise NotImplementedError(
            f"restoring onto shardings is not ported to ray_tpu_torch yet (ROADMAP.md, {MESH_ITEM})")
    from ray_tpu_torch.llm.engine import resolve_device

    tree = torch.load(os.path.join(os.path.abspath(path), _STATE), map_location=resolve_device(device),
                      weights_only=True)
    if target is not None:
        _check_like(tree, target)
    return tree
