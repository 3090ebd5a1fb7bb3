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
- ``torch.autograd.gradcheck`` of the Function in f64;
- the arithmetic of the bf16 CUDA kernels, written out here as a plain
  PyTorch loop over 64-wide tiles with transposed scores and with P and dS
  rounded to bf16 before the accumulate products, against
  ``attention_bwd_ref`` within 2e-2 of the largest |grad|: the tolerance
  the card checks use has room for that rounding;
- the bf16 alignment rule of the CUDA path is not applied to CPU tensors.

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


def _tiled_bwd_bf16_operands(q, k, v, g, lse, delta, causal, scale, tile=64):
    """What the bf16 K2/K3 kernels compute, tile by tile: per (kv head, key
    tile) the scores transposed, S^T = K Q^T and dP^T = V dO^T in f32 from
    zero-padded tiles, the mask as a select, P^T and dS^T rounded to bf16
    for dV += P^T dO, dK += dS^T Q and dQ += dS K (f32 sums, the rep heads
    summed in f32), scale applied once at the end, outputs cast to bf16.
    (K2 computes S and not S^T; the values are the same.)"""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    n = -(-T // tile)
    pad = n * tile - T
    log2e = 1.4426950408889634

    def padded(x):  # zeros past T, as the tile loads give them
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad) if x.dim() == 4 else (0, pad))

    qp, kp, vp, gp, lp, dp_ = map(padded, (q, k, v, g, lse, delta))
    dq = torch.zeros_like(qp)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    pos = torch.arange(n * tile)
    for kt in range(n):
        ks = slice(kt * tile, (kt + 1) * tile)
        for r in range(rep):
            heads = slice(r, H, rep)  # q head h reads kv head h // rep
            for qt in range(kt if causal else 0, n):
                qs = slice(qt * tile, (qt + 1) * tile)
                st = kp[:, :, ks] @ qp[:, heads, qs].transpose(-1, -2)  # [B, Hkv, keys, q rows]
                dpt = vp[:, :, ks] @ gp[:, heads, qs].transpose(-1, -2)
                ok = (pos[ks, None] < T) & (pos[None, qs] < T)
                if causal:
                    ok = ok & (pos[ks, None] <= pos[None, qs])
                pt = torch.where(ok, torch.exp2(st * (scale * log2e) - lp[:, heads, None, qs] * log2e),
                                 torch.zeros(()))
                ptr = pt.bfloat16().float()
                d = dpt - dp_[:, heads, None, qs]
                dv[:, :, ks] += ptr @ gp[:, heads, qs]
                # K3 forms dS^T from the rounded P^T (the f32 one does not fit its registers), K2 from f32
                dk[:, :, ks] += (ptr * d).bfloat16().float() @ qp[:, heads, qs]
                dq[:, heads, qs] += (pt * d).bfloat16().float().transpose(-1, -2) @ kp[:, :, ks]
    return (dq[:, :, :T] * scale).bfloat16(), (dk[:, :, :T] * scale).bfloat16(), dv[:, :, :T].bfloat16()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounded_tile_loop_stays_within_the_card_tolerance(D, causal):
    """Ragged T = 150 (two whole 64-wide tiles and 22 rows), rep 2."""
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in _inputs(11 + D, 2, 4, 2, 150, D))
    scale = D**-0.5
    o, lse = tfa.attention_with_lse_ref(q, k, v, causal, scale)
    delta = (g.float() * o.float()).sum(-1)
    out = _tiled_bwd_bf16_operands(q, k, v, g, lse, delta, causal, scale)
    dq_r, dk_r, dv_r = tfa.attention_bwd_ref(q, k, v, o, lse, g, causal, scale)
    refs = (dq_r, tfa._sum_rep(dk_r, 2), tfa._sum_rep(dv_r, 2))
    for t, ref in zip(out, refs):
        assert t.shape == ref.shape
        err = (t.float() - ref).abs().max().item() / ref.abs().max().item()
        assert 0 < err <= 2e-2  # rounded, so not identical; within the card checks' tolerance


def test_alignment_rule_is_not_applied_to_cpu_tensors():
    """A bf16 CPU tensor that starts 2 bytes into its buffer runs the plain
    version: the 16-byte rule belongs to the CUDA path's TMA loads."""
    shape = (1, 2, 16, 64)
    n = 2 * 16 * 64
    rng = np.random.default_rng(3)
    off = [torch.from_numpy(rng.standard_normal(n + 8).astype(np.float32)).bfloat16()[1:n + 1].view(shape)
           for _ in range(4)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in off)
    o, lse = tfa.flash_attention_fwd(*off[:3])
    delta = (off[3].float() * o.float()).sum(-1)
    out = tfa.flash_attention_bwd(*off, lse, delta)
    ref = tfa.flash_attention_bwd(*(t.clone() for t in off), lse, delta)
    for t, r in zip(out, ref):
        assert t.dtype == torch.bfloat16 and torch.equal(t, r)
