"""Weight transfer from the JAX package's parameter tree, and a rank's
shard of a tree.

The trees have the same shape and leaf names on both sides
(``models/llama.py`` keeps ``PARAM_AXES``), so conversion is leaf by
leaf. This module imports neither jax nor ray_tpu: leaves arrive as
numpy arrays (``np.asarray`` of a jax.Array is one).

``shard_params(tree, cfg, mesh, rank)`` slices rank r's part of the
port's tree by ``PARAM_AXES`` under ``parallel.mesh.DEFAULT_RULES``: over
a tp mesh heads, kv heads, the MLP's hidden dim and the vocab are split
(wq/wk/wv and w_gate/w_up by columns, wo and w_down by rows, the
embedding by vocab rows, the unembedding by vocab columns, or ``embed.T``
when tied), norms are whole, and a leaf on fsdp or dp axes splits there
too; each shard equals the addressable shard that ray_tpu's
``jax.device_put(params, NamedSharding(mesh, _param_pspecs(cfg, mesh)))``
gives device r. ``init_params_shard`` draws the whole tree from the
generator, leaf by leaf as ``init_params`` does, and keeps only the
rank's slice of each, so ranks made from one seed hold the tp=1 weights.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One leaf: numpy (or anything ``np.asarray`` takes) -> torch on
    ``device``. numpy's bfloat16 (the ml_dtypes dtype) has no torch
    counterpart in ``torch.from_numpy``, so its bits travel as uint16 and
    are reinterpreted."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:  # jax hands out read-only views; torch wants to own writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device=None):
    """The port's parameter tree from the JAX one (nested dicts of
    arrays). ``device`` defaults to "cuda"; pass "cpu" to stay on the host."""
    device = torch.device("cuda" if device is None else device)
    if isinstance(tree, dict):
        return {name: params_from_jax(leaf, device) for name, leaf in tree.items()}
    return tensor_from_numpy(tree, device)


def _axes_at(axes: dict, path: str):
    node = axes
    for part in path.split("/"):
        node = node[part]
    return node


def _shard_leaf(t: torch.Tensor, axes: tuple, mesh, rank: int) -> torch.Tensor:
    from ray_tpu_torch.parallel.mesh import DEFAULT_RULES, shard_slices

    idx = shard_slices(t.shape, DEFAULT_RULES.spec(axes, mesh), mesh, rank)
    if all(s == slice(None) for s in idx):
        return t
    return t[idx].clone(memory_format=torch.contiguous_format)  # no view keeps the whole leaf alive


def shard_params(tree: dict, cfg, mesh, rank: int) -> dict:
    """Rank ``rank``'s shard of the port's parameter tree over ``mesh``
    (module docstring). Whole leaves are the same tensors; split ones are
    contiguous copies."""
    from ray_tpu_torch.models.llama import param_logical_axes

    axes = param_logical_axes(cfg)

    def walk(node, ax):
        if isinstance(node, dict):
            return {name: walk(leaf, ax[name]) for name, leaf in node.items()}
        return _shard_leaf(node, ax, mesh, rank)

    return walk(tree, axes)


def init_params_shard(cfg, generator: torch.Generator, mesh, rank: int) -> dict:
    """Rank ``rank``'s shard of ``init_params(cfg, generator)``: the same
    draws, each leaf sliced as soon as it is drawn."""
    from ray_tpu_torch.models.llama import init_params, param_logical_axes

    axes = param_logical_axes(cfg)
    return init_params(cfg, generator, leaf_fn=lambda path, t: _shard_leaf(t, _axes_at(axes, path), mesh, rank))
