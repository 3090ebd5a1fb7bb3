"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
module names (``ops/layers.py``, ``ops/flash_attention.py``,
``models/llama.py``, ``llm/...``) so each port sits next to its
counterpart by path. It imports ``torch`` and nothing of ``jax`` or
``ray_tpu``.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``_kernels.py``). Each kernel's Python wrapper launches it for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__all__ = ["llm", "models", "ops", "parallel"]
