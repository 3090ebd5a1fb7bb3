"""Token sampling with per-lane parameters (port of ray_tpu/llm/sampling.py).

Each lane carries a threefry2x32 key (``prng.py``, jax.random's bits):
``sample`` splits it, draws with the first half through ``categorical``
(argmax of logits plus Gumbel noise) and returns the second half as the
lane's next key, for every lane on every call, greedy lanes included, as
ray_tpu's ``vmap`` does. So seeded streams equal ray_tpu's, and the whole
call is tensor arithmetic with no host read, which a CUDA graph captures.
Greedy tokens and chosen-token logprobs match the JAX version exactly;
``filter_logits`` matches it to float tolerance (the top-p mass is summed
in f64, see ``_apply_top_p``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ray_tpu_torch.llm import prng


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (user-facing)."""

    max_tokens: int = 64
    temperature: float = 0.0  # 0.0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    stop_token_ids: tuple = field(default_factory=tuple)
    seed: int | None = None
    logprobs: bool = False
    priority: int = 0  # admission class (kept for parity with ray_tpu)

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.priority < 0:
            raise ValueError("priority must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


def _apply_top_k(logits, top_k):
    """Mask logits outside the per-row top-k (top_k[b] == 0 disables).
    Ranks follow jnp's stable ascending argsort, reversed."""
    vocab = logits.shape[-1]
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    ranks = torch.argsort(order, dim=-1)
    k = torch.where(top_k <= 0, torch.full_like(top_k, vocab), top_k)[..., None]
    return torch.where(ranks < k, logits, torch.full((), float("-inf"), device=logits.device))


def _apply_top_p(logits, top_p):
    """Nucleus filtering: keep the smallest prefix with cumprob >= top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True, stable=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    # the running mass in f64: an f32 cumsum's last-ulp error would drop
    # the tail at top_p == 1.0 depending on summation order
    cum = torch.cumsum(probs.double(), dim=-1)
    keep_sorted = (cum - probs.double()) < top_p.double()[..., None]
    inf = torch.full((), float("inf"), device=logits.device)
    thresh = torch.where(keep_sorted, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, -inf)


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature-scale then top-k / top-p filter. logits: [..., V];
    temperature/top_p: [...] f32; top_k: [...] int (0 disables)."""
    scaled = logits / torch.clamp(temperature, min=1e-6)[..., None]
    scaled = _apply_top_k(scaled, top_k)
    return _apply_top_p(scaled, top_p)


def sample(logits, keys, temperature, top_k, top_p):
    """One token per row. logits: [B, V]; keys: [B, 2] int64 lane keys
    (``prng``); temperature/top_p: [B] f32; top_k: [B] int, all on logits'
    device. Returns (tokens [B] int64, logprobs [B] f32, new keys [B, 2]).
    Rows at temperature 0 take the argmax; their keys advance all the same."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    halves = prng.split(keys)
    drawn = prng.categorical(halves[:, 0], filter_logits(logits, temperature, top_k, top_p))
    tokens = torch.where(temperature == 0.0, greedy, drawn)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, -1, tokens[:, None])[:, 0]
    return tokens, chosen, halves[:, 1].contiguous()
