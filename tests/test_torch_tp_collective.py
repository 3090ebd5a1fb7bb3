"""The port's device collectives (``ray_tpu_torch/collective/ici.py``)
against ray_tpu's: the eager helpers over per-device tensors (the twin
of ``test_device_objects.py::test_ici_backend_allreduce_allgather``), and
the tensor-parallel step's in-group collectives over a 2-rank gloo group
(rank 0 here, rank 1 a process of ``parallel/ranks.py`` running
``tests/torch_tp_defs.py``'s probe): ``quantized_psum`` against ray_tpu's
under ``shard_map`` on the same seeded inputs within one int8 step of
each chunk's scale and equal on both ranks, the exact sum bit for bit in
f32, the int8 collective's logit drift in (0, 0.2) beside ray_tpu's, and
one decode step's counted wire bytes, fp and int8, equal to ray_tpu's
``collective_wire_report`` of its fused step. ray_tpu's shard_map bodies
run through the test-side shims of ``tests/test_torch_engine_tp.py``
(``check_vma=False``), and its wire report through one more: jax 0.9
moved ``ClosedJaxpr``/``Jaxpr`` to ``jax.extend.core``, and the report
reads them from ``jax.core``. Then the ``"xla"`` backend, accepted by both
packages. ~20 s."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.extend.core as jex_core  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import ray_tpu.llm.model_runner as jmr  # noqa: E402
import ray_tpu.llm.spec.verify as jverify  # noqa: E402
from ray_tpu.collective import ici as jici  # noqa: E402
from ray_tpu.collective import types as jtypes  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel.mesh import create_mesh as jax_mesh  # noqa: E402
from ray_tpu_torch.collective import ici  # noqa: E402
from ray_tpu_torch.collective import types as ttypes  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from ray_tpu_torch.parallel.ranks import Ranks  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

import torch_tp_defs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KW = dict(num_heads=4, num_kv_heads=4, dtype="float32", max_seq_len=256)
CFG_J = jllama.LlamaConfig.tiny(attention_impl="xla", **KW)
CFG_T = tllama.LlamaConfig.tiny(**KW)


def _unchecked(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, axis_names={"tp"}, check_vma=False)


@pytest.fixture
def ray_tpu_tp(monkeypatch):
    monkeypatch.setattr(jmr, "_tp_shard_map", _unchecked)
    monkeypatch.setattr(jverify, "_tp_shard_map", _unchecked)
    monkeypatch.setattr(jax.core, "ClosedJaxpr", jex_core.ClosedJaxpr, raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", jex_core.Jaxpr, raising=False)


@pytest.fixture(scope="module")
def ranks():
    """One 2-rank group for the module: rank 1 imports the probe from this
    directory, so the rank process gets it on its PYTHONPATH."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, old) if p)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rk = Ranks(["cpu", "cpu"], ("torch_tp_defs", "probe"))
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    rk.wait_ready()
    yield rk, torch_tp_defs.Probe(rk.group)
    rk.close()
    torch.set_num_threads(n)


def _run(ranks, op, *args):
    """``op`` on both ranks at once; returns [rank 0's, rank 1's] result."""
    rk, mine = ranks
    rk.send(op, *args)
    out0 = getattr(mine, op)(*args)
    return [out0, rk.call("result")[0]]


def test_ici_backend_allreduce_allgather():
    """The eager helpers over 4 per-device tensors: values and placements
    as ray_tpu's over 4 virtual devices (here all 4 on the host)."""
    n = 4
    devs = jax.local_devices()[:n]
    per_j = [jax.device_put(jnp.full((8,), float(i + 1)), devs[i]) for i in range(n)]
    per_t = [torch.full((8,), float(i + 1)) for i in range(n)]
    out_j, out_t = jici.allreduce(per_j), ici.allreduce(per_t)
    assert len(out_t) == n
    for j, t, src in zip(out_j, out_t, per_t):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.device == src.device and t.dtype == src.dtype and t.data_ptr() != src.data_ptr()
    for op in (jtypes.ReduceOp.MAX, jtypes.ReduceOp.MIN, jtypes.ReduceOp.PRODUCT):
        np.testing.assert_array_equal(ici.allreduce(per_t, ttypes.ReduceOp(op.value))[2].numpy(),
                                      np.asarray(jici.allreduce(per_j, op)[2]))
    np.testing.assert_array_equal(ici.allgather(per_t)[0].numpy(), np.asarray(jici.allgather(per_j)[0]))
    rs_j = jici.reducescatter([jax.device_put(jnp.arange(float(n * 2)), devs[i]) for i in range(n)])
    rs_t = ici.reducescatter([torch.arange(float(n * 2)) for _ in range(n)])
    for j, t in zip(rs_j, rs_t):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    bc_j, bc_t = jici.broadcast(jnp.ones((3,)), n), ici.broadcast(torch.ones(3), n)
    assert len(bc_t) == len(bc_j) == n and all(float(b.sum()) == 3 for b in bc_t)
    with pytest.raises(ValueError, match="world size"):
        ici.reducescatter([torch.arange(5.0)] * n)


def _jax_collective(fn, xs):
    """ray_tpu's in-program collective under shard_map over 2 devices, on
    the stacked per-rank inputs xs [2, ...]; returns [2, ...]."""
    mesh = jax_mesh(tp=2, devices=jax.devices()[:2])
    body = _unchecked(lambda x: fn(x[0], "tp")[None], mesh, (P("tp"),), P("tp"))
    x = jax.device_put(jnp.asarray(xs), NamedSharding(mesh, P("tp")))
    return np.asarray(jax.jit(body)(x))


def test_quantized_psum_matches_ray_tpu(ranks):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 4, 1, 128)).astype(np.float32)
    got = _run(ranks, "qpsum", xs)
    ref = _jax_collective(jici.quantized_psum, xs)
    assert torch.equal(got[0], got[1])  # replicated exactly
    exact = xs.sum(axis=0)
    # one int8 step of each chunk's scale: |x| max over the chunk / 127
    step = np.abs(exact.reshape(4, 1, 2, 64)).max(-1, keepdims=True) / 127.0
    diff = np.abs(got[0].numpy() - ref[0]).reshape(4, 1, 2, 64)
    assert (diff <= step).all(), float(diff.max())
    assert float(np.abs(got[0].numpy() - exact).max()) < 0.05
    with pytest.raises(ValueError, match="divisible"):
        ici.quantized_psum(torch.zeros(3, 5), ranks[1].group)


def test_exact_sum_and_gather_bit_for_bit(ranks):
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((2, 4, 1, 128)).astype(np.float32)
    got = _run(ranks, "psum", xs)
    ref = _jax_collective(jax.lax.psum, xs)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), xs[0] + xs[1])
        np.testing.assert_array_equal(g.numpy(), ref[0])
    gat = _run(ranks, "gather", xs)
    assert torch.equal(gat[0], gat[1])
    np.testing.assert_array_equal(gat[0].numpy(), np.concatenate([xs[0], xs[1]], axis=-1))


def test_int8_collective_logit_drift_beside_ray_tpu(ranks, ray_tpu_tp):
    """One slot fused step at tp=2 over the same seeded cache: the int8
    collective drifts the sampled logprobs by a nonzero amount under 0.2
    against the fp collective, in both packages; fp logprobs agree."""
    jp = jllama.init_params(CFG_J, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    B, S, L = 4, 64, CFG_T.num_layers
    rng = np.random.default_rng(0)
    k0 = rng.normal(size=(L, B, S, CFG_T.num_kv_heads, CFG_T.hd)).astype(np.float32)
    v0 = rng.normal(size=k0.shape).astype(np.float32)
    lengths = np.full((B,), 3, np.int64)
    keys = np.asarray(jax.vmap(lambda s: jax.random.key_data(jax.random.PRNGKey(s)))(
        jnp.arange(B, dtype=jnp.uint32))).astype(np.int64)
    lanes = (np.asarray([5, 6, 7, 8], np.int64), keys, np.zeros((B,), np.float32), np.zeros((B,), np.int64),
             np.ones((B,), np.float32))
    mesh = create_mesh(tp=2, devices=["cpu", "cpu"])
    port = {}
    for coll in ("fp", "int8"):
        out = _run(ranks, "fused", CFG_T, tp, mesh, coll, k0, v0, lengths, lanes)
        assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])  # both ranks sample alike
        port[coll] = out[0][1].numpy()
    jmesh = jax_mesh(tp=2, devices=jax.devices()[:2])
    psh = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(jmesh, s)), jp, jmr._param_pspecs(CFG_J, jmesh))
    csp = jmr._cache_pspecs("slots", False)
    rep = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P()))  # noqa: E731

    def run(collective):
        cache = {"k": jax.device_put(jnp.asarray(k0), NamedSharding(jmesh, csp["k"])),
                 "v": jax.device_put(jnp.asarray(v0), NamedSharding(jmesh, csp["v"])),
                 "length": rep(lengths.astype(np.int32))}
        jl = (rep(lanes[0].astype(np.int32)), rep(keys.astype(np.uint32)), rep(lanes[2]),
              rep(lanes[3].astype(np.int32)), rep(lanes[4]))
        return np.asarray(jmr._sharded_fused_slots(CFG_J, jmesh, collective, False)(psh, cache, *jl)[2])

    ref = {coll: run(coll) for coll in ("fp", "int8")}
    drift_t = float(np.abs(port["fp"] - port["int8"]).max())
    drift_j = float(np.abs(ref["fp"] - ref["int8"]).max())
    assert 0.0 < drift_t < 0.2, drift_t
    assert 0.0 < drift_j < 0.2, drift_j
    np.testing.assert_allclose(port["fp"], ref["fp"], atol=1e-4)


@pytest.mark.parametrize("collective", ["fp", "int8"])
def test_decode_step_wire_bytes_match_ray_tpu_report(params_tp, ray_tpu_tp, collective):
    """One decode step of a tp=2 slot engine with B lanes: the bytes rank
    0's group counted, by dtype, equal ray_tpu's collective_wire_report of
    its fused step at the same shapes; the int8 step ships int8 per-layer
    payloads and one f32 scale per 64-byte chunk row (H = 128 split over 2
    ranks): the scales are 1/16 of the int8 bytes."""
    B = 4
    eng = LLMEngine(CFG_T, params_tp, mesh=create_mesh(tp=2, devices=["cpu", "cpu"]), max_num_seqs=B,
                    max_seq_len=64, tp_collective=collective)
    reports = []
    orig = eng._decode_step

    def counted():
        mark = eng._group.wire.mark()
        handle = orig()
        reports.append(eng._group.wire.since(mark))
        return handle

    eng._decode_step = counted
    try:
        eng.generate([[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]], SamplingParams(temperature=0.0, max_tokens=3))
    finally:
        eng.shutdown()
    jmesh = jax_mesh(tp=2, devices=jax.devices()[:2])
    args = (jmr._sds_params(CFG_J), jmr._sds_cache(CFG_J, B, 64)) + jmr._sds_lanes(B)
    ref = jici.collective_wire_report(jax.make_jaxpr(jmr._sharded_fused_slots(CFG_J, jmesh, collective, False))(*args),
                                      axis_size=2)
    assert reports and all(r["bytes_by_dtype"] == ref["bytes_by_dtype"] for r in reports), (reports[0], ref)
    assert reports[0]["total_bytes"] == ref["total_bytes"] == eng.tp_wire_step_bytes
    # the per-layer ops (two sums a layer; fp's embed sum shares their shape)
    layer = [op for op in reports[0]["ops"] if op["count"] >= 2 * CFG_T.num_layers]
    if collective == "int8":
        i8 = sum(op["wire_bytes"] for op in layer if op["dtype"] == "int8")
        assert i8 > 0 and 16 * sum(op["wire_bytes"] for op in layer if op["dtype"] != "int8") == i8
    else:
        assert "int8" not in reports[0]["bytes_by_dtype"] and layer


@pytest.fixture(scope="module")
def params_tp():
    jp = jllama.init_params(CFG_J, jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_xla_backend_accepted_as_in_ray_tpu():
    """``"xla"`` normalises to itself in both packages (a group of it takes
    the object-store path, as in ray_tpu); gloo is the object store's alias."""
    for b in ("xla", ttypes.Backend.XLA):
        assert ttypes.Backend.normalize(b) is ttypes.Backend.XLA
        assert jtypes.Backend.normalize(str(b.value if hasattr(b, "value") else b)) is jtypes.Backend.XLA
    assert ttypes.Backend.normalize("gloo") is ttypes.Backend.OBJECT_STORE
    with pytest.raises(ValueError):
        ttypes.Backend.normalize("nccl")


