"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
module names (``api.py``, ``core/...``, ``ops/layers.py``,
``ops/flash_attention.py``, ``models/llama.py``, ``llm/...``) so each port
sits next to its counterpart by path. It imports ``torch`` and nothing of
``jax`` or ``ray_tpu``.

The runtime's API is ray_tpu's: ``init()`` (the host's cards are its
``"GPU"`` resource), ``@remote`` functions and actors, ``put``/``get``/
``wait``/``cancel``, ``get_actor``, ``kill`` and the cluster's resources.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``_kernels.py``). Each kernel's Python wrapper launches it for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch.api import (  # noqa: F401
    ActorClass,
    ActorHandle,
    RemoteFunction,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    internal_free,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator  # noqa: F401

__all__ = ["ActorClass", "ActorHandle", "ObjectRef", "ObjectRefGenerator", "RemoteFunction", "available_resources",
           "cancel", "cluster_resources", "exceptions", "get", "get_actor", "get_runtime_context", "init",
           "internal_free", "is_initialized", "kill", "llm", "method", "models", "nodes", "ops", "parallel", "put",
           "remote", "shutdown", "timeline", "wait"]
