"""The training path against ray_tpu's on the same weights (converted with
``params_from_jax``) and the same numpy-seeded batch, f32 on the CPU:
``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` (remat
on and off, tied embeddings; atol 1e-5 on the loss and 2e-5 on gradients
whose largest entries are ~0.1: the same f32 arithmetic through two layers
and the unembed, summed in another order), and three AdamW steps against
``ray_tpu.parallel.train_step.train_step`` jitted with ``optax.adamw``:
loss and grad_norm per step within 3e-5 (relative, f32 sums of ~6 and ~5
after updates that differ in the last bits), every parameter within 1e-5
except at most 4 elements per leaf, which stay within one learning rate.
Adam moves each element by up to ~lr whatever its gradient's size, so an
element whose momentum cancels to near zero can take a step of another
size from gradients that differ in the last bits."""

from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

LOSS_ATOL, GRAD_ATOL, STEP_RTOL, PARAM_ATOL, LR = 1e-5, 2e-5, 3e-5, 1e-5, 3e-4
KW = dict(dtype="float32", max_seq_len=256)


def _batch(seed, vocab, B=2, T=48):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, vocab, (B, T)).astype(np.int32)
    targets[0, :5] = -100  # ignored positions
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32), "targets": targets}


def _configs(**kw):
    return jllama.LlamaConfig.tiny(**KW, **kw), tllama.LlamaConfig.tiny(**KW, **kw)


@pytest.fixture(scope="module")
def jax_params():
    """ray_tpu's tiny f32 parameters, untied; the tied tree is the same
    without the unembed (init_params draws it last)."""
    jcfg, _ = _configs()
    return jax.jit(partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))


def _params(jp, tie=False):
    if tie:
        jp = {k: v for k, v in jp.items() if k != "unembed"}
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree, prefix=""):
    out = {}
    for name in sorted(tree):
        v = tree[name]
        out.update(_flat(v, f"{prefix}{name}/") if isinstance(v, dict) else {prefix + name: v})
    return out


@pytest.mark.parametrize("remat,tie", [(False, False), (True, False), (True, True)], ids=["plain", "remat", "remat_tied"])
def test_loss_and_grads_match_jax(jax_params, remat, tie):
    jcfg, tcfg = _configs(remat=remat, tie_embeddings=tie)
    jp, tp = _params(jax_params, tie)
    batch = _batch(0, jcfg.vocab_size)
    loss_j, grads_j = jax.jit(jax.value_and_grad(partial(jllama.loss_fn, config=jcfg)))(jp, batch)
    tp = tts._tree_map(lambda t: t.requires_grad_(True), tp)
    loss_t = tllama.loss_fn(tp, tts.to_device(batch, "cpu"), tcfg)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_ATOL
    t_leaves, j_leaves = _flat(tp), _flat(grads_j)
    assert t_leaves.keys() == j_leaves.keys()
    for name, j in j_leaves.items():
        np.testing.assert_allclose(t_leaves[name].grad.numpy(), np.asarray(j), atol=GRAD_ATOL, err_msg=name)


def test_flops_per_token_and_param_axes_match_jax():
    for kw in ({}, {"tie_embeddings": True}):
        jcfg, tcfg = _configs(**kw)
        assert tllama.param_logical_axes(tcfg) == jllama.param_logical_axes(jcfg)
        for seq in (None, 128, 2048):
            assert tllama.flops_per_token(tcfg, seq) == jllama.flops_per_token(jcfg, seq)
    sft = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=18, num_heads=16,
               num_kv_heads=8, max_seq_len=2048)
    assert tllama.flops_per_token(tllama.LlamaConfig(**sft), 2048) == jllama.flops_per_token(jllama.LlamaConfig(**sft), 2048)


def test_three_adamw_steps_match_jax(jax_params):
    jcfg, tcfg = _configs(remat=True)
    jp = jax_params
    batch = _batch(1, jcfg.vocab_size)
    tx = optax.adamw(LR, weight_decay=0.01)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp))
    jstep = jax.jit(partial(jts.train_step, loss_fn=partial(jllama.loss_fn, config=jcfg), tx=tx))

    init_fn, step_fn = tts.make_train_step(partial(tllama.loss_fn, config=tcfg), tts.adamw(LR, weight_decay=0.01),
                                           param_axes=tllama.param_logical_axes(tcfg), device="cpu")
    tstate = init_fn(0, lambda gen: params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    tbatch = tts.to_device(batch, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = step_fn(tstate, tbatch)
        assert tm["step"] == int(jm["step"]) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(tm[key].item() - float(jm[key])) <= STEP_RTOL * float(jm[key]), key
    t_leaves, j_leaves = _flat(tstate.params), _flat(jstate.params)
    assert t_leaves.keys() == j_leaves.keys()
    for name, j in j_leaves.items():
        d = np.abs(t_leaves[name].detach().numpy() - np.asarray(j))
        assert d.max() <= LR and (d > PARAM_ATOL).sum() <= 4, (name, d.max(), (d > PARAM_ATOL).sum())


def test_make_train_step_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.make_train_step(lambda p, b: None, tts.adamw(1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.to_device({"tokens": np.zeros((1, 2), np.int32)})


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="multi-device"):
        tts.make_train_step(lambda p, b: None, tts.adamw(1e-3), mesh=object(), device="cpu")
    _, tcfg = _configs(remat_policy="save_only_these_names")
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="save_only_these_names"):
        tllama.forward(tp, torch.zeros((1, 4), dtype=torch.int64), tcfg)
    init_fn, _ = tts.make_train_step(lambda p, b: None, tts.adamw(1e-3), param_axes={"embed": None}, device="cpu")
    with pytest.raises(ValueError, match="param_axes"):
        init_fn(0, partial(tllama.init_params, tcfg))
