"""Replica-side client of the cluster KV plane (port of
ray_tpu/llm/kvplane/client.py), its transport seam only: ``index_call``.

ray_tpu's ``KVPlaneClient`` publishes freshly cached prefix blocks as
owned objects on the direct object plane and fetches remote hits from
it; it is not ported, because the object plane is not (ROADMAP.md,
queue 1, the object plane). ``index_call`` needs none of that: it calls
an in-process ``PrefixIndex`` directly, or a handle to one that exposes
``.remote``.
"""

from __future__ import annotations

from ray_tpu_torch import chaos


def index_call(index, name: str, *args, timeout_s: float = 10.0):
    """Dispatch one index method against either transport: a deployment
    handle (``.remote(...).result(timeout_s)``) or an in-process
    PrefixIndex (direct call). The ONE copy of this duck-type: the client
    and the cache-aware router both route through it. Raises on transport
    failure; callers own their degrade policy.

    Chaos plane (``ray_tpu_torch/chaos.py``, site ``kvplane.index``):
    tests inject per-method delays and failures HERE, the one seam every
    index call crosses, so the router's index-down degrade is exercised
    over the real call path. A single flag check when unarmed."""
    if not chaos.apply("kvplane.index", method=name):
        raise ConnectionError(f"chaos: dropped index rpc {name}")
    method = getattr(index, name)
    remote = getattr(method, "remote", None)
    if remote is not None:
        return remote(*args).result(timeout_s=timeout_s)
    return method(*args)
