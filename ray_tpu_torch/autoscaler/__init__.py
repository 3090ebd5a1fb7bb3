"""The autoscaler and the cluster launcher (port of ray_tpu/autoscaler/):
``Autoscaler`` over a ``NodeProvider``, and ``up``/``down`` behind ``rt up``
and ``rt down``. ray_tpu's GKE provider has no counterpart on one H100."""

from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    CommandNodeProvider,
    LocalNodeProvider,
    NodeProvider,
    NodeTypeConfig,
)
from ray_tpu_torch.autoscaler.launcher import Cluster as LaunchedCluster
from ray_tpu_torch.autoscaler.launcher import down, load_config, up

__all__ = [
    "Autoscaler",
    "CommandNodeProvider",
    "LaunchedCluster",
    "LocalNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "down",
    "load_config",
    "up",
]
