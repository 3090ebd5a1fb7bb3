"""ray_tpu_torch.llm.sampling against ray_tpu.llm.sampling: filter_logits
to float tolerance (atol 1e-6 on kept logits, identical -inf masks),
greedy tokens and chosen-token logprobs exactly (logprobs to 1e-6: the
same log_softmax in f32, reduced in another order). Seeded draws use
torch generators and are held by self-consistency, not to threefry."""

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


def test_greedy_tokens_and_logprobs_match_jax():
    lg = _logits(B=6, V=512, seed=1)
    B = lg.shape[0]
    keys = np.zeros((B, 2), np.uint32)
    tok_j, logp_j, _ = js.sample(jnp.asarray(lg), jnp.asarray(keys), jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B))
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    tok_t, logp_t = ts.sample(torch.from_numpy(lg), gens, torch.zeros(B), torch.zeros(B, dtype=torch.int64), torch.ones(B))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=1e-6)


def test_seeded_draws_reproduce_and_respect_filters():
    lg = torch.from_numpy(_logits(B=3, V=64, seed=2))
    temp, top_k, top_p = torch.tensor([1.0, 0.0, 1.0]), torch.tensor([3, 0, 0]), torch.tensor([1.0, 1.0, 0.2])

    def draw(seed):
        gens = [torch.Generator().manual_seed(seed + i) for i in range(3)]
        return [ts.sample(lg, gens, temp, top_k, top_p)[0].tolist() for _ in range(20)]

    a, b = draw(11), draw(11)
    assert a == b  # the same per-lane seeds give the same stream
    top3 = set(torch.topk(lg[0], 3).indices.tolist())
    greedy = int(lg[1].argmax())
    nucleus = set(torch.nonzero(~torch.isinf(ts.filter_logits(lg[2:], temp[2:], top_k[2:], top_p[2:])[0])).flatten().tolist())
    for row in a:
        assert row[0] in top3 and row[1] == greedy and row[2] in nucleus


def test_sampling_params_validation_matches_jax():
    for bad in (dict(temperature=-1.0), dict(top_p=0.0), dict(top_k=-1), dict(priority=-1)):
        with pytest.raises(ValueError):
            js.SamplingParams(**bad)
        with pytest.raises(ValueError):
            ts.SamplingParams(**bad)
