"""The remat policies of ``models/llama.py`` against ray_tpu's
``jax.checkpoint`` policies, f32 on the CPU.

For every zero-argument name of ``jax.checkpoint_policies`` (six, aliases
included), the port's loss and every gradient leaf on ray_tpu's weights
(``params_from_jax``) and a numpy-seeded batch equal ``jax.value_and_grad``
of ray_tpu's ``loss_fn`` under the same policy: atol 1e-5 on the loss and
2e-5 on gradients whose largest entries are ~0.1, as
``tests/test_torch_train.py`` holds the plain path (the same f32
arithmetic, summed in another order). What the policies keep for the
backward pass is ordered: ``nothing_saveable`` <=
``dots_with_no_batch_dims_saveable`` <= ``dots_saveable`` <=
``everything_saveable``, counting the tensors autograd saves
(``saved_tensors_hooks``) and those a selective-checkpoint policy keeps in
its cache (torch's ``_CachingTorchDispatchMode.storage``, which the hooks
do not see). The attention's products are in no policy's keep. A policy
factory and an unknown name raise."""

from dataclasses import replace
from functools import partial

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import _RECOMPUTE

jax = pytest.importorskip("jax")

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

LOSS_ATOL, GRAD_ATOL = 1e-5, 2e-5
KW = dict(dtype="float32", max_seq_len=256, num_layers=3)
POLICIES = sorted(tllama.REMAT_POLICIES)
ORDER = ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable", "everything_saveable")


def _batch(seed, vocab, B=2, T=48):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, vocab, (B, T)).astype(np.int32)
    targets[1, -4:] = -100  # ignored positions
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32), "targets": targets}


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(partial(jllama.init_params, jllama.LlamaConfig.tiny(**KW)))(jax.random.PRNGKey(1))


def _flat(tree, prefix=""):
    out = {}
    for name in sorted(tree):
        v = tree[name]
        out.update(_flat(v, f"{prefix}{name}/") if isinstance(v, dict) else {prefix + name: v})
    return out


def test_every_zero_argument_jax_policy_is_ported():
    names = {n for n in dir(jax.checkpoint_policies) if not n.startswith("_")}
    assert set(POLICIES) | set(tllama._POLICY_FACTORIES) == names
    assert set(POLICIES) == {n for n in names if n not in tllama._POLICY_FACTORIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_jax_under_each_policy(jax_params, policy):
    jcfg = jllama.LlamaConfig.tiny(**KW, remat_policy=policy)
    tcfg = tllama.LlamaConfig.tiny(**KW, remat_policy=policy)
    batch = _batch(0, jcfg.vocab_size)
    loss_j, grads_j = jax.jit(jax.value_and_grad(partial(jllama.loss_fn, config=jcfg)))(jax_params, batch)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), "cpu")
    tp = tts._tree_map(lambda t: t.requires_grad_(True), tp)
    loss_t = tllama.loss_fn(tp, tts.to_device(batch, "cpu"), tcfg)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_ATOL
    t_leaves, j_leaves = _flat(tp), _flat(grads_j)
    assert t_leaves.keys() == j_leaves.keys()
    for name, j in j_leaves.items():
        np.testing.assert_allclose(t_leaves[name].grad.numpy(), np.asarray(j), atol=GRAD_ATOL, err_msg=name)


def _saved_bytes(monkeypatch, params, batch, cfg) -> tuple[int, dict]:
    """(bytes kept for the backward pass, {op: tensors the policy's cache kept})."""
    caches = []
    real = tllama.create_selective_checkpoint_contexts

    def spy(*a, **k):
        fwd, rec = real(*a, **k)
        caches.append(fwd)
        return fwd, rec

    monkeypatch.setattr(tllama, "create_selective_checkpoint_contexts", spy)
    hooked = [0]

    def pack(t):
        hooked[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tllama.loss_fn(params, batch, cfg)
    kept, ops = 0, {}
    for mode in caches:
        for key, entries in mode.storage.items():
            for entry in entries.values():
                if entry is _RECOMPUTE:
                    continue
                for w in tree_leaves(entry):
                    if isinstance(w.val, torch.Tensor):
                        kept += w.val.numel() * w.val.element_size()
                        op = str(key[0] if isinstance(key, tuple) else key)
                        ops[op] = ops.get(op, 0) + 1
    loss.backward()
    return hooked[0] + kept, ops


def test_saved_bytes_follow_the_policies_order(jax_params, monkeypatch):
    tcfg = tllama.LlamaConfig.tiny(**KW)
    batch = tts.to_device(_batch(2, tcfg.vocab_size), "cpu")
    saved, ops = {}, {}
    for policy in POLICIES:
        tp = params_from_jax(jax.tree.map(np.asarray, jax_params), "cpu")
        tp = tts._tree_map(lambda t: t.requires_grad_(True), tp)
        saved[policy], ops[policy] = _saved_bytes(monkeypatch, tp, batch, replace(tcfg, remat_policy=policy))
    sizes = [saved[p] for p in ORDER]
    assert sizes == sorted(sizes), saved
    assert saved["nothing_saveable"] < saved["dots_with_no_batch_dims_saveable"] < saved["everything_saveable"]
    assert saved["checkpoint_dots"] == saved["dots_saveable"]
    assert saved["checkpoint_dots_with_no_batch_dims"] == saved["dots_with_no_batch_dims_saveable"]
    # the layer's 7 projections a layer, and no product of attention's
    L = tcfg.num_layers
    assert ops["dots_with_no_batch_dims_saveable"] == {"aten.mm.default": 7 * L}
    assert ops["dots_saveable"] == {"aten.mm.default": 7 * L}
    assert not ops["nothing_saveable"] and not ops["everything_saveable"]


@pytest.mark.parametrize("name", ["save_only_these_names", "offload_dot_with_no_batch_dims", "no_such_policy"])
def test_factory_and_unknown_names_raise(name):
    tcfg = tllama.LlamaConfig.tiny(**KW, remat_policy=name)
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=name):
        tllama.forward(tp, torch.zeros((1, 4), dtype=torch.int64), tcfg)
