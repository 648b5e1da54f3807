"""Int8 serving weights in the port against the JAX package.

The port's ``quantize_tree_int8`` on the bridged weights must give JAX's
``quantize_tree_int8`` values byte for byte and its scales bit for bit,
mapped through the layout ``params_from_jax`` maps (the flax kernel's last
axis is the channel; the scanned ``[L, ...]`` leaf shares one scale over
the layers). The port's int8-weight engine must emit the greedy streams of
JAX's int8-weight engine (``test_quantized_serving.py``
``test_int8_weight_only_parity``), paged and slot, at fp32 and int8 KV,
and its weight-bytes gauge must be its own leaves' bytes.
"""

import numpy as np
import pytest
import torch

from fleetx_tpu.ops import quant as jax_quant
from fleetx_tpu_torch.models.gpt.convert import (
    convert_qkv_layout,
    params_from_jax,
)
from fleetx_tpu_torch.models.gpt.model import GPTConfig
from fleetx_tpu_torch.ops.quant import (
    dequantize_tree_int8,
    quantize_tree_int8,
    serving_weight_params,
)
from test_torch_gpt import TINY
from torch_serving_cases import (
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
    weights,
)

L = TINY["num_layers"]


def _jax_view(name, port_name, leaf, hd):
    """JAX's ``(q8, scale)`` of one port entry, in the port's layout (the
    map ``params_from_jax`` applies to the float kernel)."""
    q8, scale = (np.asarray(leaf["_q8"]), np.asarray(leaf["_scale"]))
    i = int(port_name.split(".")[2]) if ".layers." in port_name else None
    if i is not None:
        q8 = q8[i]
    if name in ("qkv_proj", "q_proj", "k_proj", "v_proj"):
        return q8.reshape(q8.shape[0], -1).T, scale.reshape(-1, 1)
    if name == "out_proj":
        return q8.reshape(-1, q8.shape[-1]).T, scale.reshape(-1, 1)
    if name in ("up_proj", "down_proj"):
        return q8.T, scale.reshape(-1, 1)
    return q8, scale.reshape(1, -1)  # an embedding table


@pytest.mark.parametrize("fused", [True, False], ids=["qkv", "q_k_v"])
def test_quantize_tree_matches_jax(fused):
    """Every ``_q8`` byte-equal and every ``_scale`` bit-equal to JAX's,
    the tied word table and the position table included; idempotent."""
    tree = weights()[0]
    if not fused:
        tree = {"params": {"gpt": convert_qkv_layout(
            tree["params"]["gpt"], to_fused=False)}}
    cfg = GPTConfig(**TINY, dtype=torch.float32, fuse_attn_qkv=fused)
    ours = quantize_tree_int8(params_from_jax(tree, cfg), cfg.head_dim)
    theirs = jax_quant.quantize_tree_int8(tree)["params"]["gpt"]
    stack = theirs["layers"]["layer"]
    checked = 0
    for port_name, q8 in ours.items():
        if not port_name.endswith("_q8"):
            continue
        base = port_name[:-3]
        if base.startswith("gpt.layers."):
            name = base.split(".")[-2]
            group = "attn" if "attn." in base else "mlp"
            leaf = stack[group][name]["kernel"]
        else:
            name = base.split(".")[-1]
            leaf = theirs[name]
        want_q8, want_scale = _jax_view(name, base, leaf, cfg.head_dim)
        np.testing.assert_array_equal(q8.numpy(), want_q8, err_msg=base)
        got_scale = ours[base + "_scale"].numpy()
        assert got_scale.shape == want_scale.shape, base
        assert got_scale.tobytes() == want_scale.tobytes(), base
        checked += 1
    per_layer = 4 if fused else 6
    assert checked == L * per_layer + 2
    assert quantize_tree_int8(ours, cfg.head_dim).keys() == ours.keys()
    again = quantize_tree_int8(ours, cfg.head_dim)
    assert all(again[k] is ours[k] for k in ours)


def test_dequantize_and_the_serving_seam():
    """``dequantize_tree_int8`` gives JAX's float weights back (within half
    a step); ``serving_weight_params`` refuses a quantized state dict at
    bf16 as JAX's does, passes a float one through, and is idempotent."""
    tree, cfg, params = weights()
    q = quantize_tree_int8(params, cfg.head_dim)
    back = dequantize_tree_int8(q)
    assert back.keys() == params.keys()
    for name, t in params.items():
        if name + "_scale" in q:
            step = q[name + "_scale"].max().item()
            assert (back[name] - t).abs().max().item() <= 0.5 * step + 1e-7
    with pytest.raises(ValueError, match="already int8-quantized"):
        serving_weight_params(q, "bf16", cfg.head_dim)
    with pytest.raises(ValueError, match="already int8-quantized"):
        jax_quant.serving_weight_params(jax_quant.quantize_tree_int8(tree),
                                        "bf16")
    assert serving_weight_params(params, "bf16", cfg.head_dim) is params
    assert all(serving_weight_params(q, "int8", cfg.head_dim)[k] is q[k]
               for k in q)
    with pytest.raises(ValueError, match="WEIGHT_DTYPE"):
        port_engine(weights(), weight_dtype="int3")
    with pytest.raises(ValueError, match="WEIGHT_DTYPE"):
        jax_engine(weights(), weight_dtype="int3")


@pytest.fixture(scope="module")
def w():
    return weights()


CASES = {f"{layout}-{kv or 'fp32'}": dict(paged=layout == "paged",
                                          kv_dtype=kv)
         for layout in ("paged", "slot") for kv in (None, "int8")}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_weight_streams_match_jax_int8_engine(w, case):
    """Greedy streams of the port's int8-weight engine byte-equal to JAX's
    int8-weight engine (whose dequant runs inside its jitted calls)."""
    kw = dict(CASES[case], weight_dtype="int8")
    want = serve(jax_engine(w, **kw), prompts())
    eng = port_engine(w, **kw)
    got = serve(eng, prompts())
    assert tokens(got) == tokens(want)
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    snap = eng.metrics.snapshot()
    assert snap["weight_dtype"] == "int8"
    assert snap["kv_dtype"] == (CASES[case]["kv_dtype"] or "bf16")


def test_weight_bytes_gauge_is_the_int8_leaves(w):
    """The gauge is the engine's own state dict's bytes: int8 values, fp32
    scales and the float rest (biases at the compute dtype, norms fp32),
    from the shapes; below the float engine's."""
    eng = port_engine(w, weight_dtype="int8")
    state = eng.model.state_dict()
    assert any(t.dtype == torch.int8 for t in state.values())
    want = sum(t.numel() * t.element_size() for t in state.values())
    by_shape = 0
    for name, t in state.items():
        item = (1 if name.endswith("_q8") else 4 if name.endswith("_scale")
                else t.element_size())
        by_shape += int(np.prod(t.shape)) * item
    snap = eng.metrics.snapshot()
    assert snap["weight_bytes"] == want == by_shape == eng.weight_nbytes()
    float_eng = port_engine(w)
    assert 0 < want < float_eng.metrics.snapshot()["weight_bytes"]
