"""A cluster of several nodes on one host, for tests (port of
ray_tpu/cluster_utils.py).

``add_node`` starts a real node-agent process by default
(``core/node_agent.py``): its workers live under the agent, frames cross
a socket and the health loop watches it. ``num_tpus`` (ray_tpu's name)
folds into ``"GPU"``, as everywhere in the port.
"""

from __future__ import annotations

from ray_tpu_torch.accelerators.gpu import fold_card
from ray_tpu_torch.core import context
from ray_tpu_torch.core.runtime import Runtime


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: dict | None = None):
        self._rt: Runtime | None = None
        self.head_node = None
        if initialize_head:
            args = dict(head_node_args or {})
            resources = fold_card(args.pop("resources", {}))
            if "num_cpus" in args:
                resources["CPU"] = float(args.pop("num_cpus"))
            self._rt = Runtime(resources=resources or None, **args)
            context.set_client(self._rt)
            self.head_node = self._rt.head_node

    def connect(self):
        context.set_client(self._rt)
        return self._rt

    @property
    def address(self) -> str:
        return "local://" + (self._rt.node_id.hex() if self._rt else "none")

    def add_node(self, *, num_cpus: int = 1, num_tpus: int = 0, resources: dict | None = None,
                 labels: dict | None = None, env: dict | None = None, remote: bool = True,
                 shm_isolation: bool | None = None):
        """``num_tpus`` cards, as ``"GPU"``. ``shm_isolation=True`` gives the
        node a shm namespace of its own: every object that crosses its
        boundary rides the transfer servers, as between hosts."""
        res = fold_card(resources or {})
        res.setdefault("CPU", float(num_cpus))
        if num_tpus:
            res["GPU"] = float(num_tpus)
        return self._rt.add_node(res, labels=labels, env=env, remote=remote, shm_isolation=shm_isolation)

    def remove_node(self, node, allow_graceful: bool = True):
        node_id = node.node_id if hasattr(node, "node_id") else node
        self._rt.remove_node(node_id, graceful=allow_graceful)

    def wait_for_nodes(self, timeout: float = 30.0):
        return True  # membership is synchronous in process

    def shutdown(self):
        if self._rt is not None:
            self._rt.shutdown()
            self._rt = None
