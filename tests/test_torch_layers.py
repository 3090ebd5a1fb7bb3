"""ray_tpu_torch.ops.layers against ray_tpu.ops.layers on the same
numpy-seeded inputs, f32 on the CPU (atol 1e-6: the same f32 arithmetic,
summed in possibly another order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.ops import layers as jl  # noqa: E402
from ray_tpu_torch.ops import layers as tl  # noqa: E402

ATOL = 1e-6


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((3, 5, 64)).astype(np.float32))
    wj, wt = _both(rng.standard_normal(64).astype(np.float32))
    np.testing.assert_allclose(tl.rms_norm(xt, wt, 1e-5).numpy(), np.asarray(jl.rms_norm(xj, wj, 1e-5)), atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("batched", [False, True], ids=["shared_positions", "per_lane_positions"])
def test_rope_matches_jax(theta, batched):
    rng = np.random.default_rng(1)
    B, H, T, D = 2, 3, 7, 32
    xj, xt = _both(rng.standard_normal((B, H, T, D)).astype(np.float32))
    pos = rng.integers(0, 300, size=(B, T) if batched else (T,)).astype(np.int32)
    cj, sj = jl.rotary_embedding(jnp.asarray(pos), D, theta)
    ct, st = tl.rotary_embedding(torch.from_numpy(pos), D, theta)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(
        tl.apply_rope(xt, ct, st).numpy(), np.asarray(jl.apply_rope(xj, cj, sj)), atol=ATOL
    )


def test_swiglu_and_embedding_match_jax():
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal((4, 32)).astype(np.float32) * 0.5)
    ws = [_both(rng.standard_normal(s).astype(np.float32) * 0.2) for s in ((32, 48), (32, 48), (48, 32))]
    out_j = jl.swiglu(xj, *(w[0] for w in ws))
    out_t = tl.swiglu(xt, *(w[1] for w in ws))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    table_j, table_t = _both(rng.standard_normal((50, 8)).astype(np.float32))
    ids = rng.integers(0, 50, size=(2, 6))
    np.testing.assert_array_equal(
        tl.embedding_lookup(table_t, torch.from_numpy(ids)).numpy(),
        np.asarray(jl.embedding_lookup(table_j, jnp.asarray(ids))),
    )


@pytest.mark.parametrize("case", ["ignore_index", "mask", "z_loss"])
def test_cross_entropy_loss_matches_jax(case):
    """Labels of -100 ignored, a mask in their place, and the z-loss term
    (atol 1e-6 on a loss of ~5: f32 logsumexp in another order)."""
    rng = np.random.default_rng(3)
    logits_j, logits_t = _both(rng.standard_normal((2, 9, 40)).astype(np.float32) * 3)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.int32) if case == "mask" else None
    if mask is None:  # with a mask, the mask alone says which labels count
        labels[0, :3] = -100
    z = 1e-3 if case == "z_loss" else 0.0
    ref = jl.cross_entropy_loss(logits_j, jnp.asarray(labels), None if mask is None else jnp.asarray(mask), z_loss=z)
    out = tl.cross_entropy_loss(logits_t, torch.from_numpy(labels.astype(np.int64)),
                                None if mask is None else torch.from_numpy(mask), z_loss=z)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), float(ref), atol=ATOL)


def test_rms_norm_fused_cpu_branch_matches_pallas_interpret():
    """K5's wrapper on CPU tensors (its plain version, ``rms_norm``) against
    ``rms_norm_pallas`` in interpret mode, 300 rows: a 256-row block and a
    ragged one (atol 1e-6, f32)."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(4)
    xj, xt = _both(rng.standard_normal((300, 256)).astype(np.float32))
    wj, wt = _both(rng.standard_normal(256).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = jl.rms_norm_pallas(xj, wj, 1e-5)
    before = tl.rms_norm_fused.launches
    out = tl.rms_norm_fused(xt, wt, 1e-5)
    assert tl.rms_norm_fused.launches == before  # the counter counts kernel launches only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("d,itemsize,aligned,plan", [
    (8, 2, True, (2, 1)),  # one bf16 vector: a warp, one vector a lane
    (256, 2, True, (2, 1)),  # 32 vectors: one a lane
    (264, 2, True, (2, 2)),  # 33 vectors: two a lane, the second on lane 0 only
    (2048, 2, True, (2, 8)),  # the training rows (hidden 2048)
    (4096, 2, True, (2, 16)),  # a decode step of Llama-3-8B
    (8192, 2, True, (2, 32)),  # 16 KB: the widest row a warp holds
    (8200, 2, True, (1, 0)),  # past 16 KB: a block per row
    (4096, 4, True, (2, 32)),  # f32, 16 KB
    (4100, 4, True, (1, 0)),
    (1000, 4, True, (2, 8)),  # 250 f32 vectors
    (13, 2, True, (0, 0)),  # not a whole number of vectors: element by element
    (1001, 4, True, (0, 0)),
    (4096, 2, False, (0, 0)),  # an unaligned pointer: element by element
    (100 * 1024, 2, True, (1, 0)),  # 200 KB, the widest row the block path stages
])
def test_rms_norm_fused_dispatch_rule(d, itemsize, aligned, plan):
    """K5's launch path at its edges: a warp per row up to 16 KB rows of
    whole 16-byte vectors on aligned pointers (nv, the vectors a lane
    holds, a power of two covering d), a block per row past that, and the
    element-by-element block path for ragged widths or unaligned pointers."""
    assert tl.rms_norm_plan(d, itemsize, aligned) == plan
    path, nv = plan
    if path == 2:
        vectors = d * itemsize // 16
        assert (nv & (nv - 1)) == 0 and (32 * nv >= vectors > 16 * nv or (nv == 1 and vectors <= 32))
