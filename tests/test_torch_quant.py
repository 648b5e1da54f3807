"""KV quantization of the PyTorch port against the JAX package.

``quantize_kv`` must give the JAX function's int8 values byte for byte
and its fp32 scales bit for bit on the same inputs — bf16 and fp32, with
all-zero vectors and exact .5 ties (both round half to even) — and
``dequantize_kv`` the same values; the serving-precision knob and the
prefix-tolerance measure behave as the JAX helpers do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fleetx_tpu.ops import quant as jax_quant
from fleetx_tpu_torch.ops import quant


def _inputs(seed=0):
    """[2, 5, 3, 16] vectors: random of several magnitudes, one all-zero
    vector, and vectors whose elements land exactly on .5 of a step."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    x *= np.float32(10.0) ** rng.randint(-3, 3, (2, 5, 3, 1))
    x[0, 1, 2] = 0.0
    ties = np.arange(-8, 8, dtype=np.float32) + 0.5  # absmax 7.5
    x[1, 0, 0] = ties * np.float32(127.0 / 7.5)  # k + .5 steps
    x[1, 0, 1] = np.float32(127.0)  # absmax 127: scale exactly 1
    x[1, 0, 1, :8] = np.arange(8, dtype=np.float32) - 3.5
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_byte_identical_to_jax(dtype):
    x = _inputs()
    jq, js = jax_quant.quantize_kv(jnp.asarray(x, dtype))
    tq, ts = quant.quantize_kv(torch.tensor(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (2, 5, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[0, 1, 2].any() and ts[0, 1, 2].item() == 0.0
    # the .5 ties round to even, as jnp.round does
    np.testing.assert_array_equal(tq[1, 0, 1, :8].numpy(),
                                  [-4, -2, -2, 0, 0, 2, 2, 4])
    for out in (torch.float32, torch.bfloat16):
        jd = jax_quant.dequantize_kv(jq, js, jnp.dtype(str(out)[6:]))
        td = quant.dequantize_kv(tq, ts, out)
        assert td.dtype == out
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd, np.float32))


def test_resolve_serving_dtype(monkeypatch):
    env = "FLEETX_SERVING_KV_DTYPE"
    monkeypatch.delenv(env, raising=False)
    for value, want in ((None, "bf16"), ("INT8", "int8"), ("bf16", "bf16")):
        assert quant.resolve_serving_dtype(value, env) == want
        assert jax_quant.resolve_serving_dtype(value, env) == want
    monkeypatch.setenv(env, "int8")
    assert quant.resolve_serving_dtype(None, env) == "int8"
    assert quant.resolve_serving_dtype("bf16", env) == "bf16"  # value wins
    for bad in ("fp8", "int4"):
        with pytest.raises(ValueError, match="bf16|int8"):
            quant.resolve_serving_dtype(bad, env)
        with pytest.raises(ValueError):
            jax_quant.resolve_serving_dtype(bad, env)
    monkeypatch.setenv(env, "fp16")
    with pytest.raises(ValueError, match=env):
        quant.resolve_serving_dtype(None, env)


@pytest.mark.parametrize("got,want,frac", [
    ([1, 2, 3, 4], [1, 2, 3, 4], 1.0),
    ([1, 2, 9, 9], [1, 2, 3, 4], 0.5),
    ([9, 2, 3, 4], [1, 2, 3, 4], 0.0),
    ([1, 2, 3], [1, 2, 3, 4], 0.0),  # a missing token fails outright
    ([], [], 0.0),
])
def test_quant_parity_frac_matches_jax(got, want, frac):
    assert quant.quant_parity_frac(got, want) == frac
    assert jax_quant.quant_parity_frac(got, want) == frac
    assert quant.common_prefix_len(got, want) == jax_quant.common_prefix_len(
        got, want)
    assert quant.QUANT_PREFIX_BUDGET == jax_quant.QUANT_PREFIX_BUDGET
