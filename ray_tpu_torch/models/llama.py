"""Llama-family transformer in PyTorch (port of ray_tpu/models/llama.py).

Weights keep the JAX package's layout so a converted tree drops in
unchanged (``ray_tpu_torch.weights.params_from_jax``): a plain dict of
tensors, ``x @ W`` with ``W: [in, out]``, and every per-layer weight
stacked on a leading ``[L, ...]`` axis under the ``PARAM_AXES`` leaf
names. Layers are iterated with a Python loop (``scan_layers`` has no
counterpart); attention goes through ``ops/flash_attention.py``'s
autograd Function (K1 forward, K2/K3 backward), as ``attention_impl``
"auto"/"pallas" asks; the card refuses any other value. ``forward`` and
``loss_fn`` are differentiable; with ``config.remat`` each layer is
recomputed in the backward pass (``torch.utils.checkpoint``), as
``jax.checkpoint`` with the ``nothing_saveable`` policy does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.layers import apply_rope, cross_entropy_loss, rms_norm, rotary_embedding

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string ("bfloat16", "float32", ...)."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    # recompute each layer in backward (training); the port takes only the
    # "nothing_saveable" policy (ROADMAP.md, queue 1, training, the rest)
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # kept for config parity with ray_tpu and not read: layers are a Python loop
    scan_layers: bool = True
    # "auto" | "pallas": K1-K3 on the card (``attention``); any other value
    # (ray_tpu's "xla") raises there, and the host runs the plain version
    attention_impl: str = "auto"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**{**dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32), **kw})

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**{**dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0), **kw})

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256), **kw})

    def num_params(self) -> int:
        h, i, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd = self.hd
        attn = h * (self.num_heads * hd) + 2 * h * (self.num_kv_heads * hd) + (self.num_heads * hd) * h
        mlp = 3 * h * i
        return L * (attn + mlp + 2 * h) + v * h * (1 if self.tie_embeddings else 2) + h


# logical axes per parameter (leaf name -> tuple of logical dims);
# layer-stacked params carry a leading "layers" axis
PARAM_AXES = {
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "final_norm": (None,),
    "layers": {
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "kv_heads"),
        "wv": (None, "embed", "kv_heads"),
        "wo": (None, "heads", "embed"),
        "w_gate": (None, "embed", "mlp"),
        "w_up": (None, "embed", "mlp"),
        "w_down": (None, "mlp", "embed"),
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
    },
}


def param_logical_axes(config: LlamaConfig) -> dict:
    """Logical axes of ``config``'s parameter tree (the unembed only when
    it is not tied)."""
    axes = {
        "embed": PARAM_AXES["embed"],
        "final_norm": PARAM_AXES["final_norm"],
        "layers": dict(PARAM_AXES["layers"]),
    }
    if not config.tie_embeddings:
        axes["unembed"] = PARAM_AXES["unembed"]
    return axes


def init_params(config: LlamaConfig, generator: torch.Generator) -> dict:
    """Random weights from ``generator`` (normal * fan_in**-0.5, norms 1),
    drawn in f32 on the generator's device and cast to ``config.dtype``.
    The draws are torch's, not jax.random's: tests that compare with
    ray_tpu convert JAX's tree instead (``weights.params_from_jax``)."""
    device = generator.device
    h, hd, L = config.hidden_size, config.hd, config.num_layers
    dt = torch_dtype(config.dtype)

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def dense_init(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * fan_in**-0.5).to(dt)

    params = {
        "embed": dense_init(config.vocab_size, h, fan_in=h),
        "final_norm": norm_init(h),
        "layers": {
            "wq": dense_init(L, h, config.num_heads * hd, fan_in=h),
            "wk": dense_init(L, h, config.num_kv_heads * hd, fan_in=h),
            "wv": dense_init(L, h, config.num_kv_heads * hd, fan_in=h),
            "wo": dense_init(L, config.num_heads * hd, h, fan_in=config.num_heads * hd),
            "w_gate": dense_init(L, h, config.intermediate_size, fan_in=h),
            "w_up": dense_init(L, h, config.intermediate_size, fan_in=h),
            "w_down": dense_init(L, config.intermediate_size, h, fan_in=config.intermediate_size),
            "attn_norm": norm_init(L, h),
            "mlp_norm": norm_init(L, h),
        },
    }
    if not config.tie_embeddings:
        params["unembed"] = dense_init(h, config.vocab_size, fan_in=h)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked ``[L, ...]`` leaves."""
    return {name: w[i] for name, w in params["layers"].items()}


def unembed_f32(x: torch.Tensor, params: dict, config: LlamaConfig) -> torch.Tensor:
    """Final projection to f32 logits (JAX: ``preferred_element_type=f32``)."""
    w = params["embed"].T if config.tie_embeddings else params["unembed"]
    return x.float() @ w.float()


KERNEL_ATTENTION_IMPLS = ("auto", "pallas")


def check_attention_impl(config: LlamaConfig, device) -> None:
    """Refuse on the card an ``attention_impl`` that asks for another path
    than the kernels. ray_tpu's "xla" runs XLA's attention at any head dim;
    the port's only attention on the card is K1-K3, which take head_dim 64
    or 128, and a silent switch to the plain version would be a fallback."""
    if torch.device(device).type == "cuda" and config.attention_impl not in KERNEL_ATTENTION_IMPLS:
        raise ValueError(
            f"LlamaConfig.attention_impl={config.attention_impl!r}: on the card attention runs only the "
            f"flash-attention kernels K1-K3 (attention_impl 'auto' or 'pallas'; head_dim 64 or 128, this "
            f"config has {config.hd}); an XLA-style path is not ported (ROADMAP.md, queue 2)")


def attention(q, k, v, config: LlamaConfig):
    """Causal attention as ``config.attention_impl`` asks: the
    ``FlashAttention`` Function, whose wrappers launch K1-K3 on the card
    and run the plain versions on the host (ray_tpu's "xla" numbers there,
    whatever the value)."""
    check_attention_impl(config, q.device)
    return flash_attention(q, k, v, True, None)


def _attention_block(x, layer, config: LlamaConfig, cos, sin):
    B, T, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.hd
    xn = rms_norm(x, layer["attn_norm"], config.rms_eps)
    q = (xn @ layer["wq"]).reshape(B, T, nh, hd).transpose(1, 2)
    k = (xn @ layer["wk"]).reshape(B, T, nkv, hd).transpose(1, 2)
    v = (xn @ layer["wv"]).reshape(B, T, nkv, hd).transpose(1, 2).contiguous()
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, config)
    o = o.transpose(1, 2).reshape(B, T, nh * hd)
    return x + o @ layer["wo"]


def _mlp_block(x, layer, config: LlamaConfig):
    xn = rms_norm(x, layer["mlp_norm"], config.rms_eps)
    return x + (F.silu(xn @ layer["w_gate"]) * (xn @ layer["w_up"])) @ layer["w_down"]


def _layer(x, cos, sin, config: LlamaConfig, *weights):
    layer = dict(zip(PARAM_AXES["layers"], weights))
    return _mlp_block(_attention_block(x, layer, config, cos, sin), layer, config)


def forward(params: dict, tokens: torch.Tensor, config: LlamaConfig, positions=None) -> torch.Tensor:
    """tokens: [B, T] int -> logits [B, T, vocab] f32. Differentiable in
    ``params``; callers that only infer wrap it in ``torch.no_grad()``."""
    B, T = tokens.shape
    if config.remat and config.remat_policy != "nothing_saveable":
        raise NotImplementedError(
            f"remat_policy={config.remat_policy!r} is not ported to ray_tpu_torch yet; only "
            "'nothing_saveable' is (ROADMAP.md, queue 1, training, the rest)")
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    cos, sin = rotary_embedding(positions, config.hd, config.rope_theta)
    x = params["embed"][tokens]
    # one unbind per stacked leaf: its backward stacks the L layer
    # gradients once, where indexing w[i] would add L full-size zero-padded
    # gradients
    per_layer = [w.unbind(0) for w in (params["layers"][n] for n in PARAM_AXES["layers"])]
    for i in range(config.num_layers):
        weights = [w[i] for w in per_layer]
        if config.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, cos, sin, config, *weights, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(x, cos, sin, config, *weights)
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    return unembed_f32(x, params, config)


def loss_fn(params: dict, batch: dict, config: LlamaConfig) -> torch.Tensor:
    """batch: {tokens [B, T], targets [B, T] (-100 = ignore)} -> scalar f32 loss."""
    logits = forward(params, batch["tokens"], config)
    return cross_entropy_loss(logits, batch["targets"])


def flops_per_token(config: LlamaConfig, seq_len: int | None = None) -> float:
    """Training FLOPs/token ~ 6N + the attention quadratic term."""
    f = 6.0 * config.num_params()
    if seq_len:
        # 12 * L * H * T * hd per token (fwd+bwd attention scores+values)
        f += 12.0 * config.num_layers * config.num_heads * seq_len * config.hd
    return f
