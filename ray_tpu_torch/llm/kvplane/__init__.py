"""Cluster KV plane (port of ray_tpu/llm/kvplane/), the in-process half:

- **index.py**: the content-stable blake2b prefix keys the local prefix
  cache uses, ``boundary_keys`` and ``PrefixIndex``, the cluster map of
  key -> {replica -> (n_valid, meta, ref)} with lease-based staleness and
  decayed demand;
- **routing.py**: ``CacheAwareRouter``, which scores replicas by longest
  cached prefix blended with load;
- **client.py**: ``index_call``, the one seam every index call crosses.

Not ported: ``KVPlaneClient`` (it publishes and fetches prefix blocks as
owned objects), the wire quantizers of ``quant.py`` and the engine's
remote-prefix tier; they wait for the object plane (ROADMAP.md, queue 1,
the object plane).
"""

from ray_tpu_torch.llm.kvplane.index import PrefixIndex, boundary_keys, stable_hash, token_bytes
from ray_tpu_torch.llm.kvplane.routing import CacheAwareRouter, KVRouteError, rank_replicas, score_replica

__all__ = [
    "CacheAwareRouter",
    "KVRouteError",
    "PrefixIndex",
    "boundary_keys",
    "rank_replicas",
    "score_replica",
    "stable_hash",
    "token_bytes",
]
