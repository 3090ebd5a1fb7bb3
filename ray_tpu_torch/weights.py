"""Weight transfer from the JAX package's parameter tree.

The trees have the same shape and leaf names on both sides
(``models/llama.py`` keeps ``PARAM_AXES``), so conversion is leaf by
leaf. This module imports neither jax nor ray_tpu: leaves arrive as
numpy arrays (``np.asarray`` of a jax.Array is one).
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
