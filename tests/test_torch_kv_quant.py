"""ray_tpu_torch.llm.kv_quant against ray_tpu.llm.kv_quant: quantization
is byte-identical (same round-half-to-even, clip and zero-vector rule)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import kv_quant as jq  # noqa: E402
from ray_tpu_torch.llm import kv_quant as tq  # noqa: E402


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 64)).astype(np.float32) * rng.uniform(0.01, 10, size=(3, 7, 4, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector: q = 0, scale = 0
    x[1, 2, 3, :4] = [1.0, -1.0, 0.5, 127.0 / 2]  # exact halves after scaling
    return x


def test_quantize_heads_byte_identical():
    x = _inputs()
    qj, sj = jq.quantize_heads(jnp.asarray(x))
    qt, st = tq.quantize_heads(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    np.testing.assert_array_equal(tq.dequantize(qt, st).numpy(), np.asarray(jq.dequantize(qj, sj)))


def test_quantize_heads_bf16_input_byte_identical():
    x = _inputs()
    qj, sj = jq.quantize_heads(jnp.asarray(x, jnp.bfloat16))
    qt, st = tq.quantize_heads(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_bytes_per_token_and_dtype_names_match(dtype):
    assert tq.bytes_per_token(32, 8, 128, dtype) == jq.bytes_per_token(32, 8, 128, dtype)
    assert tq.is_int8(dtype) == jq.is_int8(dtype)
    for name in ("bf16", "F32", "int8", "float32"):
        assert tq.normalize_cache_dtype(name) == jq.normalize_cache_dtype(name)
    with pytest.raises(ValueError, match="cache_dtype"):
        tq.normalize_cache_dtype("fp8")
