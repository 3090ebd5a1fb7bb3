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
recomputed in the backward pass (``torch.utils.checkpoint``) under
``config.remat_policy``, each of ``jax.checkpoint_policies``' zero-argument
names (``REMAT_POLICIES``): ``nothing_saveable`` recomputes the whole
layer; ``dots_saveable`` (alias ``checkpoint_dots``) keeps the outputs of
the matrix products (``aten.mm``/``addmm``/``bmm``/``baddbmm``) through a
selective-checkpoint policy, ``dots_with_no_batch_dims_saveable`` (alias
``checkpoint_dots_with_no_batch_dims``) those without batch dims
(``aten.mm``/``addmm``), and recomputes the rest; ``everything_saveable``
keeps everything, so nothing is recomputed. Attention (K1's launch, a
ctypes call the dispatcher never sees) is opaque to the policies, as
ray_tpu's ``pallas_call`` is no dot: it is recomputed under every policy
but ``everything_saveable``. A policy factory (``save_only_these_names``,
``offload_dot_with_no_batch_dims``, ...) raises.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

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
    # recompute each layer in backward (training) under remat_policy, a
    # name of REMAT_POLICIES
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


def init_params(config: LlamaConfig, generator: torch.Generator, leaf_fn=None) -> dict:
    """Random weights from ``generator`` (normal * fan_in**-0.5, norms 1),
    drawn in f32 on the generator's device and cast to ``config.dtype``.
    The draws are torch's, not jax.random's: tests that compare with
    ray_tpu convert JAX's tree instead (``weights.params_from_jax``).
    ``leaf_fn(path, leaf)`` (path as "layers/wq") replaces each leaf as
    soon as it is drawn, in draw order: a rank keeps its shard of a leaf
    before the next is drawn (``weights.init_params_shard``)."""
    device = generator.device
    h, hd, L = config.hidden_size, config.hd, config.num_layers
    dt = torch_dtype(config.dtype)
    keep = leaf_fn or (lambda path, t: t)

    def norm_init(path, *shape):
        return keep(path, torch.ones(shape, dtype=dt, device=device))

    def dense_init(path, *shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return keep(path, w.mul_(fan_in**-0.5).to(dt))  # in place: a second f32 copy of a stacked leaf would be 7.5 GB at 8B

    params = {
        "embed": dense_init("embed", config.vocab_size, h, fan_in=h),
        "final_norm": norm_init("final_norm", h),
        "layers": {
            "wq": dense_init("layers/wq", L, h, config.num_heads * hd, fan_in=h),
            "wk": dense_init("layers/wk", L, h, config.num_kv_heads * hd, fan_in=h),
            "wv": dense_init("layers/wv", L, h, config.num_kv_heads * hd, fan_in=h),
            "wo": dense_init("layers/wo", L, config.num_heads * hd, h, fan_in=config.num_heads * hd),
            "w_gate": dense_init("layers/w_gate", L, h, config.intermediate_size, fan_in=h),
            "w_up": dense_init("layers/w_up", L, h, config.intermediate_size, fan_in=h),
            "w_down": dense_init("layers/w_down", L, config.intermediate_size, h, fan_in=config.intermediate_size),
            "attn_norm": norm_init("layers/attn_norm", L, h),
            "mlp_norm": norm_init("layers/mlp_norm", L, h),
        },
    }
    if not config.tie_embeddings:
        params["unembed"] = dense_init("unembed", h, config.vocab_size, fan_in=h)
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


# the matrix products each selective policy keeps (JAX: a dot_general's
# output, with or without batch dims); None: checkpoint everything or nothing
_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
REMAT_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": None,
    "dots_saveable": _DOTS + _BATCH_DOTS,
    "checkpoint_dots": _DOTS + _BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS,
    "checkpoint_dots_with_no_batch_dims": _DOTS,
}
# jax.checkpoint_policies' names that build a policy from arguments
_POLICY_FACTORIES = ("offload_dot_with_no_batch_dims", "save_and_offload_only_these_names", "save_any_names_but_these",
                     "save_anything_except_these_names", "save_from_both_policies", "save_only_these_names")
# ops inside the attention kernel's region are never saved (its plain
# version on the host runs products the card's kernel does not expose);
# per thread: the recompute runs on autograd's threads
_opaque = threading.local()


@contextlib.contextmanager
def _opaque_to_remat():
    _opaque.depth = getattr(_opaque, "depth", 0) + 1
    try:
        yield
    finally:
        _opaque.depth -= 1


def _keep_dots(ops, ctx, op, *args, **kwargs):
    if op in ops and not getattr(_opaque, "depth", 0):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(policy: str):
    """``checkpoint``'s ``context_fn`` for ``policy`` (None for
    ``nothing_saveable``); ValueError for a name that is not a
    zero-argument policy of ``REMAT_POLICIES``."""
    if policy not in REMAT_POLICIES:
        kind = ("a policy factory that takes arguments" if policy in _POLICY_FACTORIES
                else "not a jax.checkpoint_policies name")
        raise ValueError(f"remat_policy={policy!r} is {kind}; ray_tpu_torch takes the zero-argument policies "
                         f"{sorted(REMAT_POLICIES)}")
    ops = REMAT_POLICIES[policy]
    if ops is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts, functools.partial(_keep_dots, ops))


def attention(q, k, v, config: LlamaConfig):
    """Causal attention as ``config.attention_impl`` asks: the
    ``FlashAttention`` Function, whose wrappers launch K1-K3 on the card
    and run the plain versions on the host (ray_tpu's "xla" numbers there,
    whatever the value)."""
    check_attention_impl(config, q.device)
    with _opaque_to_remat():
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
    context_fn = remat_context_fn(config.remat_policy) if config.remat else None
    remat = config.remat and config.remat_policy != "everything_saveable" and torch.is_grad_enabled()
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
        if remat:
            kw = {} if context_fn is None else {"context_fn": context_fn}
            x = checkpoint(_layer, x, cos, sin, config, *weights, use_reentrant=False, preserve_rng_state=False,
                           **kw)
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
