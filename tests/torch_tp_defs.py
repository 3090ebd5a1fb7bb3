"""Rank-side code for ``tests/test_torch_tp_collective.py`` and
``test_torch_engine_tp.py`` (no jax): the factory a rank process builds
its probe from (``parallel/ranks.py`` imports it by reference), the
probe's collectives, and ``prefix_groups`` for ``LLMEngine.tp_call``. Rank 0 runs the
same probe in the test process; each op stores its result for a later
``result()`` call (a call that waited for its reply would hold rank 0
out of the collective its peers are in)."""

from __future__ import annotations

import torch

from ray_tpu_torch.collective import ici
from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.weights import shard_params


class Probe:
    def __init__(self, group):
        self.group = group
        self.out = None

    def _mine(self, xs):
        return torch.from_numpy(xs[self.group.rank].copy())

    def qpsum(self, xs):
        self.out = ici.quantized_psum(self._mine(xs), self.group)
        return self.out

    def psum(self, xs):
        self.out = ici.psum(self._mine(xs), self.group)
        return self.out

    def gather(self, xs):
        self.out = ici.all_gather(self._mine(xs), self.group, axis=-1)
        return self.out

    def fused(self, cfg, params, mesh, collective, k0, v0, lengths, lanes):
        """One slot fused step of this rank's shard over a given cache."""
        r, tp = self.group.rank, self.group.size
        kv = cfg.num_kv_heads // tp
        cache = {"k": torch.from_numpy(k0[:, :, :, r * kv:(r + 1) * kv].copy()),
                 "v": torch.from_numpy(v0[:, :, :, r * kv:(r + 1) * kv].copy()),
                 "length": torch.from_numpy(lengths.copy())}
        step = mr.make_fused_fns(cfg, mesh, collective, group=self.group)
        _, toks, logps, *_ = step(shard_params(params, cfg, mesh, r), cache,
                                  *(torch.from_numpy(a.copy()) for a in lanes))
        self.out = (toks, logps)
        return self.out

    def result(self):
        return self.out


def probe(group, conn):
    return Probe(group)


def prefix_groups(eng) -> int:
    """Prefix groups whose shards this rank holds for rank 0's cache (rank
    0 keeps its own in the cache itself)."""
    return len(getattr(eng, "_tp_prefix", {}))


def fail_on_rank(eng, rank: int):
    """Raise in rank ``rank`` (the failure path of LLMEngine.tp_call)."""
    if eng._group.rank == rank:
        raise RuntimeError(f"probe failure in rank {rank}")
    return eng._group.rank
