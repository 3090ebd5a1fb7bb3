"""The flash-attention backward (K2, K3) and the autograd Function against
the JAX reference on numpy-seeded inputs, on the CPU:

- ``attention_bwd_ref`` against ``_bwd_xla``, f32 (atol 1e-5: the same
  f32 arithmetic, summed in another order);
- the wrapper ``flash_attention_bwd`` and the gradients of
  ``flash_attention`` (the ``torch.autograd.Function``) against
  ``jax.vjp`` of ``flash_attention(..., impl="xla")``, which sums the GQA
  rep heads, at rep 1, 2 and 4, D 64 and 128, ragged T (atol 1e-5);
- the plain version against the Pallas backward itself,
  ``_bwd_pallas_with_delta`` with 32 x 32 blocks in interpret mode, so
  several blocks and the causal block skip run (atol 2e-3, the tolerance
  the forward's interpret test uses);
- ``torch.autograd.gradcheck`` of the Function in f64.

The CUDA kernels against the plain version are in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.ops import flash_attention as jfa  # noqa: E402
from ray_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 1e-5


def _inputs(seed, B, H, Hkv, T, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, H, T, D))
    return tuple(rng.standard_normal(s).astype(dtype) for s in shapes)  # q, k, v, g


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_matches_bwd_xla(causal):
    q, k, v, g = _inputs(0, 2, 4, 2, 37, 64)
    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    kb, vb = jfa._broadcast_kv(qj, kj, vj)
    o, lse = jfa._fwd_xla_with_lse(qj, kb, vb, causal, None)
    ref = jfa._bwd_xla(qj, kb, vb, o, lse, gj, causal, None)
    out = tfa.attention_bwd_ref(*map(torch.from_numpy, (q, k, v, np.asarray(o), np.asarray(lse), g)), causal=causal)
    for t, j in zip(out, ref):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("rep,T,D,causal", [(1, 33, 64, True), (2, 50, 128, True), (4, 33, 64, True),
                                             (1, 50, 128, False), (2, 33, 64, False), (4, 50, 128, False)])
def test_wrapper_and_function_match_jax_vjp(rep, T, D, causal):
    q, k, v, g = _inputs(rep * T + D, 2, 2 * rep, 2, T, D)

    @jax.jit
    def value_and_vjp(q, k, v, g):
        o, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal, None, "xla"), q, k, v)
        return o, vjp(g)

    o_j, ref = value_and_vjp(*map(jnp.asarray, (q, k, v, g)))

    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd(qt, kt, vt, causal=causal)
    delta = (gt * o).sum(-1)
    launches = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    wrapped = tfa.flash_attention_bwd(qt, kt, vt, gt, lse, delta, causal=causal)
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == launches  # CPU: no kernel

    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out = tfa.flash_attention(*leaves, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_j), atol=ATOL)
    # the gradient arrives through a transpose, as it does from the model
    out.transpose(1, 2).backward(gt.transpose(1, 2))
    for w, leaf, j in zip(wrapped, leaves, ref):
        assert w.shape == leaf.shape and w.dtype == leaf.dtype
        np.testing.assert_allclose(w.numpy(), np.asarray(j), atol=ATOL)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(j), atol=ATOL)


def test_plain_bwd_matches_pallas_interpret():
    """``_bwd_pallas_with_delta`` run by the interpreter with 32 x 32 blocks
    on a 96-long sequence: 3 x 3 blocks, the ones above the diagonal skipped."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, g = _inputs(5, 1, 2, 2, 96, 64)
    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._fwd_xla_with_lse(qj, kj, vj, True, None)
    delta = jnp.sum(gj * o, axis=-1)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._bwd_pallas_with_delta(qj, kj, vj, gj, lse, delta, causal=True, block_q=32, block_k=32)
    out = tfa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, g, np.asarray(lse), np.asarray(delta))), causal=True)
    for t, j in zip(out, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradcheck_f64(causal):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 4, 6, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    assert torch.autograd.gradcheck(lambda *a: tfa.flash_attention(*a, causal=causal), (q, k, v))
