"""Cluster KV plane (port of ray_tpu/llm/kvplane/), the in-process half:

- **index.py**: the content-stable blake2b prefix keys the local prefix
  cache uses, ``boundary_keys`` and ``PrefixIndex``, the cluster map of
  key -> {replica -> (n_valid, meta, ref)} with lease-based staleness and
  decayed demand;
- **routing.py**: ``CacheAwareRouter``, which scores replicas by longest
  cached prefix blended with load;
- **client.py**: ``KVPlaneClient``: a replica publishes freshly cached
  prefix blocks as owned objects on the object plane (``core/direct.py``,
  the handoff codec with ``kind=kv_prefix``, an int8 wire for int8
  caches) and fetches remote hits zero-copy under a bounded retry budget;
  every failure degrades to a local prefill. ``index_call`` is the one
  seam every index call crosses;
- **quant.py**: the wire quantize and dequantize between fp PrefixCache
  entries and the int8 wire.

Engine integration: ``LLMEngine(kv_plane=KVPlaneClient(...))``: a local
prefix-cache miss consults the index, fetches the longest live remote
block, scatters it in through the inserts (requantizing across cache
dtypes) and republishes it.
"""

from ray_tpu_torch.llm.kvplane.client import KVPlaneClient
from ray_tpu_torch.llm.kvplane.index import PrefixIndex, boundary_keys, stable_hash, token_bytes
from ray_tpu_torch.llm.kvplane.routing import CacheAwareRouter, KVRouteError, rank_replicas, score_replica

__all__ = [
    "CacheAwareRouter",
    "KVPlaneClient",
    "KVRouteError",
    "PrefixIndex",
    "boundary_keys",
    "rank_replicas",
    "score_replica",
    "stable_hash",
    "token_bytes",
]
