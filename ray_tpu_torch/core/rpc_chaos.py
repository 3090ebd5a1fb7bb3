"""RPC chaos for the runtime's transport (port of
ray_tpu/core/rpc_chaos.py): faults by message type, as rules at site
``rpc.<msg_type>`` of the port's chaos plane (``ray_tpu_torch/chaos.py``),
so one ``chaos.clear()``/``chaos.seed()`` governs transport and serving
faults together.

Sites in the port's runtime: ``to_worker`` (every message the head sends
a worker; a drop loses it), each inbound worker message by its type
(``ready``, ``done``, ``seal``, ``stream_item``, ...; a drop loses it),
``direct_call`` (a direct submission; a drop sends it down the head path)
``direct_result`` (a direct reply; a drop fails the connection, so
its calls fail over), ``transfer_chunk`` (a chunk of an object pull; a
drop aborts the stream), and the health loop's probes of node agents:
``ping`` (the head's probe; a drop loses it) and ``pong`` (an agent's
answer, by its type like every agent message; dropping them all starves
the node into being declared dead).

    from ray_tpu_torch.core import rpc_chaos
    rpc_chaos.inject("done", delay_s=0.1)          # slow completions
    rpc_chaos.inject("to_worker", delay_s=0.2)     # slow dispatch
    rpc_chaos.clear()
"""

from __future__ import annotations

from ray_tpu_torch import chaos
from ray_tpu_torch.chaos import Rule  # noqa: F401 (re-export)

class _RulesView:
    """msg_type -> the live chaos Rule, derived on every access from the
    shared registry (no second copy of state to fall out of step)."""

    @staticmethod
    def _live() -> dict:
        return {k[4:]: r for k, r in chaos.rules().items() if k.startswith("rpc.")}

    def __getitem__(self, msg_type):
        return self._live()[msg_type]

    def __contains__(self, msg_type):
        return msg_type in self._live()

    def get(self, msg_type, default=None):
        return self._live().get(msg_type, default)

    def __iter__(self):
        return iter(self._live())

    def __len__(self):
        return len(self._live())

    def __bool__(self):
        return bool(self._live())

    def keys(self):
        return self._live().keys()

    def values(self):
        return self._live().values()

    def items(self):
        return self._live().items()

    def __repr__(self):
        return repr(self._live())


_rules = _RulesView()


def inject(msg_type: str, *, delay_s: float = 0.0, drop_prob: float = 0.0, max_hits: int | None = None):
    chaos.inject("rpc." + msg_type, delay_s=delay_s, drop_prob=drop_prob, max_hits=max_hits)


def clear():
    chaos.clear(prefix="rpc.")


def seed(n: int):
    chaos.seed(n)


def apply(msg_type: str) -> bool:
    """Apply chaos for one message. Returns False if the message must be
    DROPPED; sleeps inline for delay rules."""
    return chaos.apply("rpc." + msg_type)
