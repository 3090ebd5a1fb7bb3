"""ray_tpu_torch.llm.sampling against ray_tpu.llm.sampling: filter_logits
to float tolerance (atol 1e-6 on kept logits, identical -inf masks),
greedy tokens and chosen-token logprobs exactly (logprobs to 1e-6: the
same log_softmax in f32, reduced in another order); ``sample`` on the same
threefry lane keys over greedy and stochastic lanes mixed in one batch:
tokens equal, new keys bit-equal (every lane's key advances, greedy lanes'
too), logprobs within 1e-5; and no host read or torch.Generator inside."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import sampling as js  # noqa: E402
from ray_tpu_torch.llm import sampling as ts  # noqa: E402


def _logits(B=5, V=300, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


@pytest.mark.parametrize(
    "temp,top_k,top_p",
    [
        ([1.0] * 5, [0] * 5, [1.0] * 5),
        ([0.7, 1.0, 1.3, 0.5, 2.0], [5, 0, 50, 1, 299], [1.0] * 5),
        ([1.0] * 5, [0] * 5, [0.9, 0.5, 0.1, 1.0, 0.99]),
        ([0.8, 1.2, 1.0, 0.3, 1.0], [10, 40, 0, 3, 7], [0.95, 0.6, 0.3, 1.0, 0.8]),
    ],
    ids=["plain", "top_k", "top_p", "both"],
)
def test_filter_logits_matches_jax(temp, top_k, top_p):
    lg = _logits()
    ref = np.asarray(js.filter_logits(jnp.asarray(lg), jnp.asarray(temp, jnp.float32),
                                      jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32)))
    out = ts.filter_logits(torch.from_numpy(lg), torch.tensor(temp), torch.tensor(top_k), torch.tensor(top_p)).numpy()
    # top-p is a threshold on a running probability mass: a token whose
    # mass-before sits within float rounding (1e-5) of top_p may fall on
    # either side (an f32 cumsum reaches 1.0 - 1e-7 at the tail); every
    # other token must be kept or dropped alike
    ambiguous = np.zeros_like(lg, dtype=bool)
    for b in range(lg.shape[0]):
        x = lg[b].astype(np.float64) / max(temp[b], 1e-6)
        if top_k[b] > 0:
            x[np.argsort(-x, kind="stable")[top_k[b]:]] = -np.inf
        order = np.argsort(-x, kind="stable")
        p = np.exp(x[order] - x[order[0]])
        p /= p.sum()
        before = np.cumsum(p) - p
        ambiguous[b, order] = np.abs(before - top_p[b]) < 1e-5
    differ = np.isinf(out) != np.isinf(ref)
    np.testing.assert_array_equal(differ & ~ambiguous, np.zeros_like(differ))
    # and what flips carries no probability worth a draw
    mass = np.exp(lg / np.maximum(np.asarray(temp), 1e-6)[:, None])
    mass /= mass.sum(axis=-1, keepdims=True)
    assert mass[differ].sum() < 1e-5
    kept = ~np.isinf(ref) & ~np.isinf(out)
    np.testing.assert_allclose(out[kept], ref[kept], atol=1e-6)


def _keys(B, seed):
    return np.stack([np.asarray(jax.random.PRNGKey(seed + i)) for i in range(B)]).astype(np.uint32)


def test_greedy_tokens_and_logprobs_match_jax():
    lg = _logits(B=6, V=512, seed=1)
    B = lg.shape[0]
    keys = _keys(B, 0)
    tok_j, logp_j, keys_j = js.sample(jnp.asarray(lg), jnp.asarray(keys), jnp.zeros(B), jnp.zeros(B, jnp.int32),
                                      jnp.ones(B))
    tok_t, logp_t, keys_t = ts.sample(torch.from_numpy(lg), torch.from_numpy(keys.astype(np.int64)), torch.zeros(B),
                                      torch.zeros(B, dtype=torch.int64), torch.ones(B))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=1e-6)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j).astype(np.int64))


# 8 lanes: greedy, temperature 0.7 / 1.3, top_k 0 / 5, top_p 1.0 / 0.8, mixed in one batch
MIXED = dict(temp=[0.0, 0.7, 1.3, 0.7, 0.0, 1.3, 0.7, 1.3], top_k=[0, 0, 5, 5, 5, 0, 0, 5],
             top_p=[1.0, 0.8, 1.0, 0.8, 0.8, 1.0, 1.0, 0.8])


@pytest.mark.parametrize("V", [64, 512, 4096])
@pytest.mark.parametrize("seed", [0, 9])
def test_sample_matches_jax_over_mixed_lanes(V, seed):
    """The same keys through both: tokens equal, new keys bit-equal,
    logprobs within 1e-5; then four more calls chained on the returned
    keys, as a lane's key advances step by step."""
    B = len(MIXED["temp"])
    keys = _keys(B, 100 * seed)
    temp = np.array(MIXED["temp"], np.float32)
    top_k, top_p = np.array(MIXED["top_k"], np.int32), np.array(MIXED["top_p"], np.float32)
    kj, kt = jnp.asarray(keys), torch.from_numpy(keys.astype(np.int64))
    for step in range(5):
        lg = _logits(B=B, V=V, seed=seed * 10 + step)
        tok_j, logp_j, kj = js.sample(jnp.asarray(lg), kj, jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
        tok_t, logp_t, kt = ts.sample(torch.from_numpy(lg), kt, torch.from_numpy(temp),
                                      torch.from_numpy(top_k.astype(np.int64)), torch.from_numpy(top_p))
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=1e-5)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
        assert (tok_t.numpy()[temp == 0] == lg[temp == 0].argmax(-1)).all()


def test_draws_respect_the_filters():
    """Over 64 lane keys: a top-k lane draws from its top k, a nucleus lane
    from its nucleus, a greedy lane the argmax; the same keys draw the
    same tokens, and every key advances."""
    n, V = 64, 64
    lg = torch.from_numpy(np.repeat(_logits(B=1, V=V, seed=2), 3 * n, axis=0))
    temp = torch.tensor([1.0, 0.0, 1.0]).repeat_interleave(n)
    top_k = torch.tensor([3, 0, 0]).repeat_interleave(n)
    top_p = torch.tensor([1.0, 1.0, 0.2]).repeat_interleave(n)
    keys = torch.stack([ts.prng.prng_key(s) for s in range(3 * n)])
    toks, _, new = ts.sample(lg, keys, temp, top_k, top_p)
    assert torch.equal(ts.sample(lg, keys, temp, top_k, top_p)[0], toks)
    assert not (new == keys).all(dim=-1).any()
    top3 = set(torch.topk(lg[0], 3).indices.tolist())
    nucleus = set(torch.nonzero(~torch.isinf(ts.filter_logits(lg[:1], temp[-1:], top_k[-1:], top_p[-1:])[0]))
                  .flatten().tolist())
    assert set(toks[:n].tolist()) <= top3 and len(set(toks[:n].tolist())) > 1
    assert (toks[n : 2 * n] == lg[0].argmax()).all()
    assert set(toks[2 * n :].tolist()) <= nucleus


def test_sample_reads_nothing_back_to_the_host(monkeypatch):
    """``sample`` is tensor arithmetic only: it never reads a value on the
    host (which a CUDA graph cannot capture) or builds a torch.Generator."""

    def refuse(*args, **kwargs):
        raise AssertionError("sample read a tensor back to the host or built a generator")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "Generator", refuse)
    monkeypatch.setattr(torch, "multinomial", refuse)
    B = len(MIXED["temp"])
    ts.sample(torch.from_numpy(_logits(B=B, V=128)), torch.from_numpy(_keys(B, 3).astype(np.int64)),
              torch.tensor(MIXED["temp"]), torch.tensor(MIXED["top_k"]), torch.tensor(MIXED["top_p"]))


def test_sampling_params_validation_matches_jax():
    for bad in (dict(temperature=-1.0), dict(top_p=0.0), dict(top_k=-1), dict(priority=-1)):
        with pytest.raises(ValueError):
            js.SamplingParams(**bad)
        with pytest.raises(ValueError):
            ts.SamplingParams(**bad)
