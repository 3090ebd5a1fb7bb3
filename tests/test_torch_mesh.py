"""The port's meshes and sharding rules (``ray_tpu_torch/parallel/mesh.py``,
``weights.shard_params``) against ray_tpu's (``ray_tpu/parallel/mesh.py``
over the 8 virtual CPU devices the conftest provides): ``MeshConfig``
resolution and its errors, ``create_mesh``'s axis names and shapes,
the axis helpers, ``ShardingRules.spec`` for every ``PARAM_AXES`` leaf over
tp, dp x tp and fsdp x tp meshes, and each rank's weight shard equal,
exactly, to the addressable shard ray_tpu's ``jax.device_put`` gives
that device. A port mesh places ranks on ``torch.device``s (here the CPU
named once per rank); ray_tpu's names devices. ~10 s."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import NamedSharding  # noqa: E402

from ray_tpu.llm.model_runner import _param_pspecs  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from ray_tpu_torch.weights import init_params_shard, params_from_jax, shard_params  # noqa: E402

MESHES = [dict(tp=2), dict(dp=2, tp=2), dict(fsdp=2, tp=2), dict(tp=4), dict(dp=2, fsdp=2, tp=2)]
IDS = ["tp2", "dp2_tp2", "fsdp2_tp2", "tp4", "dp2_fsdp2_tp2"]


def _both(n, **axes):
    j = jmesh.create_mesh(devices=jax.devices()[:n], **axes)
    t = tmesh.create_mesh(devices=["cpu"] * n, **axes)
    return j, t


def _n(axes):
    return int(np.prod(list(axes.values())))


@pytest.mark.parametrize("cfg, n", [
    (dict(), 8), (dict(tp=2), 8), (dict(dp=2, tp=4), 8), (dict(dp=-1, fsdp=2, tp=2), 8), (dict(dp=2, tp=2), 4),
    (dict(dp=1, pp=2, sp=2, ep=2), 8), (dict(dp=-1, tp=3), 8), (dict(dp=-1, tp=-1), 8), (dict(dp=2, tp=2), 8),
])
def test_mesh_config_resolve_matches_ray_tpu(cfg, n):
    def run(mod):
        try:
            return mod.MeshConfig(**cfg).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh) == run(jmesh)


@pytest.mark.parametrize("axes", MESHES + [dict(), dict(pp=2, dp=2, sp=2)], ids=IDS + ["default", "pp_dp_sp"])
def test_create_mesh_axes_and_shapes_match_ray_tpu(axes):
    n = _n(axes) if axes else 8
    j, t = _both(n, **axes)
    assert t.axis_names == tuple(j.axis_names)
    assert t.devices.shape == j.devices.shape
    assert tmesh.mesh_axes(t) == jmesh.mesh_axes(j) == t.shape
    for name in tmesh.AXIS_ORDER:
        assert tmesh.axis_size(t, name) == jmesh.axis_size(j, name)
    for names in (("dp", "fsdp"), ("tp",), ("sp",), ("pp", "tp", "ep")):
        assert tmesh.axis_or_none(t, *names) == jmesh.axis_or_none(j, *names)
    assert tmesh.is_tp_only(t) == jmesh.is_tp_only(j)
    assert tuple(tmesh.shard_batch_spec(t)) == tuple(jmesh.shard_batch_spec(j))
    assert tmesh.replicated(t) == tuple(jmesh.replicated(j).spec)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    # the same constructors: a MeshConfig and a dict
    if axes:
        assert tmesh.create_mesh(tmesh.MeshConfig(**{"dp": -1, **axes}), devices=["cpu"] * n).shape == t.shape
        assert tmesh.create_mesh({"dp": -1, **axes}, devices=["cpu"] * n).shape == t.shape
    assert all(d == torch.device("cpu") for d in t.devices.reshape(-1))


def test_create_mesh_places_ranks_and_refuses_a_silent_cpu():
    t = tmesh.create_mesh(tp=2, devices=["cpu", "cpu"])
    assert [t.device_of(r) for r in range(2)] == [torch.device("cpu")] * 2
    assert t.coords(1) == {"tp": 1}
    m = tmesh.create_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert [m.coords(r) for r in range(4)] == [{"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0},
                                               {"dp": 1, "tp": 1}]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.create_mesh(tp=2)


@pytest.mark.parametrize("axes", MESHES, ids=IDS)
def test_sharding_rules_spec_matches_partition_specs(axes):
    j, t = _both(_n(axes), **axes)
    rules_j, rules_t = jmesh.ShardingRules(), tmesh.ShardingRules()
    for cfg in (dict(), dict(tie_embeddings=True)):
        logical = tllama.param_logical_axes(tllama.LlamaConfig.tiny(**cfg))
        specs = rules_t.tree_specs(logical, t)

        def walk(node, sp):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], sp[k])
            else:
                assert sp == tuple(rules_j.spec(node, j)), (node, sp)

        walk(logical, specs)
    for extra in (("batch", "sequence", None), ("expert", "embed"), ("stage", "heads", "kv_heads", "vocab")):
        assert rules_t.spec(extra, t) == tuple(rules_j.spec(extra, j))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("axes", MESHES, ids=IDS)
def test_shard_params_equal_ray_tpu_addressable_shards(axes, tied):
    n = _n(axes)
    j, t = _both(n, **axes)
    kw = dict(num_heads=4, num_kv_heads=4, dtype="float32", tie_embeddings=tied)
    jcfg, tcfg = jllama.LlamaConfig.tiny(**kw), tllama.LlamaConfig.tiny(**kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(j, s)), jp, _param_pspecs(jcfg, j))
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    devs = list(j.devices.reshape(-1))
    for r in range(n):
        mine = shard_params(tp, tcfg, t, r)
        for path, arr in flat:
            leaf = mine
            for k in path:
                leaf = leaf[k.key]
            (shard,) = [s for s in arr.addressable_shards if s.device == devs[r]]
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(shard.data), err_msg=f"rank {r} {path}")


def test_init_params_shard_is_the_slice_of_the_seeded_tree():
    cfg = tllama.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, dtype="float32")
    mesh = tmesh.create_mesh(tp=2, devices=["cpu", "cpu"])
    full = tllama.init_params(cfg, torch.Generator().manual_seed(7))
    for r in range(2):
        a = shard_params(full, cfg, mesh, r)
        b = init_params_shard(cfg, torch.Generator().manual_seed(7), mesh, r)
        assert a.keys() == b.keys()
        for name in ("embed", "unembed", "final_norm"):
            assert torch.equal(a[name], b[name])
        for name in a["layers"]:
            assert torch.equal(a["layers"][name], b["layers"][name])
    assert b["layers"]["wq"].shape[-1] == cfg.num_heads * cfg.hd // 2
    assert b["embed"].shape[0] == cfg.vocab_size // 2 and b["unembed"].shape[1] == cfg.vocab_size // 2
