"""K1 (flash-attention forward): the port's plain version against the
JAX reference ``_fwd_xla_with_lse`` (f32, atol 1e-5) and against the
Pallas kernel itself in interpret mode (atol 2e-3, the tolerance
tests/test_parallel.py holds that kernel to). The CUDA kernel against
the plain version is in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.ops import flash_attention as jfa  # noqa: E402
from ray_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def _qkv(seed, B, H, Hkv, T, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))


@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D", [(48, 64), (70, 128)])
def test_plain_k1_matches_xla_with_lse(rep, causal, T, D):
    q, k, v = _qkv(0, 2, 2 * rep, 2, T, D)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    kb, vb = jfa._broadcast_kv(qj, kj, vj)
    o_ref, lse_ref = jfa._fwd_xla_with_lse(qj, kb, vb, causal, None)
    o, lse = tfa.attention_with_lse_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5)


def test_plain_k1_matches_pallas_interpret():
    """The Pallas forward kernel run by the interpreter, as
    tests/test_parallel.py runs it, on GQA inputs it receives broadcast."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv(1, 1, 4, 2, 128, 64)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    kb, vb = jfa._broadcast_kv(qj, kj, vj)
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jfa._fwd_pallas(qj, kb, vb, causal=True)
    o, lse = tfa.attention_with_lse_ref(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-3)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 4, 1, 33, 64))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = tfa.attention_with_lse_ref(q, k, v, causal=True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert tfa.flash_attention_fwd.launches == before  # the counter counts kernel launches only
    assert torch.equal(tfa.flash_attention(q, k, v), o_ref)


def test_attention_ref_matches_attention_xla():
    q, k, v = _qkv(3, 2, 2, 2, 40, 64)
    ref = jfa.attention_xla(*map(jnp.asarray, (q, k, v)), causal=True)
    out = tfa.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
