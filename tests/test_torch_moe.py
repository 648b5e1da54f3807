"""The MoE path of the PyTorch port against the JAX package.

Routing (``parallel/moe.py``): expert ids, queue positions and keep flags
bit-equal to JAX ``compute_routing_indices`` for the naive, gshard and
switch gates at ample and tight capacity (the cases of
``tests/test_moe.py``), combine weights and the balance loss within
1e-6; gshard's second-expert keep and switch's jitter bit-equal to JAX's
draws from one raw threefry key, also for a rank's slice of the global
draw. ``MoEMLP`` on bridged weights: output, balance loss and every
gradient within 2e-5 of JAX's under both JAX dispatch modes; and JAX's
own ``MoEMLP`` on a dp 2 mesh equal to its single device, which is the
global routing the port's expert parallelism computes. The MoE GPT, its
module and trainer: ``tests/test_torch_moe_training.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.models.gpt.model import GPTConfig as JaxGPTConfig
from fleetx_tpu.parallel import moe as jax_moe
from fleetx_tpu_torch.models.gpt.model import GPTConfig
from fleetx_tpu_torch.parallel import moe

KEY = (0x1234ABCD, 0x0BADF00D)  # one raw threefry key for both packages


def routing_logits(case):
    """The gate logits of each routing case (tests/test_moe.py's)."""
    rng = np.random.RandomState({"ample": 0, "tight": 1, "drop": 2,
                                 "collide": 1, "norm": 2}[case])
    if case == "drop":  # every token prefers expert 0
        return np.tile(np.asarray([[10.0, 0.0]], np.float32), (16, 1))
    shape = {"ample": (32, 4), "tight": (64, 8), "collide": (64, 8),
             "norm": (16, 4)}[case]
    return rng.randn(*shape).astype(np.float32)


# (gate, case, top_k, capacity, key)
ROUTES = [("switch", "ample", 1, 32, False), ("switch", "drop", 1, 4, False),
          ("switch", "tight", 1, 5, False), ("naive", "collide", 2, 16, False),
          ("naive", "norm", 2, 16, False), ("naive", "tight", 2, 9, False),
          ("gshard", "ample", 2, 32, True), ("gshard", "tight", 2, 9, True),
          ("gshard", "tight", 2, 9, False)]


@pytest.mark.parametrize("gate,case,k,capacity,keyed", ROUTES)
def test_routing_indices_match_jax(gate, case, k, capacity, keyed):
    """Ids, positions and keep bit-equal; weights and aux within 1e-6;
    the dense dispatch equal and the combine within 1e-6."""
    logits = routing_logits(case)
    rng = jnp.asarray(KEY, jnp.uint32) if keyed else None
    want = jax_moe.compute_routing_indices(jnp.asarray(logits), k, capacity,
                                           gate, rng)
    got = moe.compute_routing_indices(torch.from_numpy(logits), k, capacity,
                                      gate, KEY if keyed else None)
    idx, pos, w, keep, aux = (np.asarray(a) for a in want)
    assert np.array_equal(got[0].numpy(), idx)
    assert np.array_equal(got[1].numpy(), pos)
    assert np.array_equal(got[3].numpy(), keep)
    np.testing.assert_allclose(got[2].numpy(), w, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[4].item(), float(aux), rtol=1e-6)
    if not keyed:
        dispatch, combine, _ = jax_moe.compute_routing(
            jnp.asarray(logits), k, capacity, gate)
        d, c, _ = moe.compute_routing(torch.from_numpy(logits), k, capacity,
                                      gate)
        assert np.array_equal(d.numpy(), np.asarray(dispatch))
        np.testing.assert_allclose(c.numpy(), np.asarray(combine),
                                   rtol=1e-6, atol=1e-7)
    if case == "drop":  # 12 of the 16 dropped, as tests/test_moe.py holds
        assert int(got[3].sum()) == capacity


def test_gate_draws_match_jax_bits():
    """gshard's keep draw ``uniform(key, (n,))`` and switch's jitter
    ``uniform(key, (n, E), 0.98, 1.02)`` bit-equal to JAX's from one raw
    key; a rank's rows [16, 48) of the global draw equal JAX's rows."""
    key = jnp.asarray(KEY, jnp.uint32)
    n, e = 64, 8
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = moe.uniform(KEY, torch.arange(n))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    want = np.asarray(jax.random.uniform(key, (n, e), minval=0.98,
                                         maxval=1.02))
    idx = torch.arange(n * e).view(n, e)
    got = moe.uniform(KEY, idx, 0.98, 1.02)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    part = moe.uniform(KEY, idx[16:48], 0.98, 1.02)
    assert np.array_equal(part.numpy(), want[16:48])


def _jax_layer(mode):
    cfg = JaxGPTConfig(hidden_size=32, ffn_hidden_size=64, num_experts=4,
                       expert_mode=True, top_k=2, gate="gshard",
                       dtype=jnp.float32, moe_dispatch=mode)
    return jax_moe.MoEMLP(cfg)


def _port_layer(params, mode="auto", **kw):
    cfg = GPTConfig(hidden_size=32, ffn_hidden_size=64, num_experts=4,
                    expert_mode=True, top_k=2, gate="gshard",
                    dtype=torch.float32, moe_dispatch=mode, **kw)
    layer = moe.MoEMLP(cfg)
    p = {"gate.weight": np.asarray(params["gate"]["kernel"]).T,
         **{n: np.asarray(params[n]) for n in moe.EXPERT_LEAVES}}
    layer.load_state_dict({n: torch.tensor(v) for n, v in p.items()},
                          assign=True)
    return layer


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_moe_mlp_output_aux_and_grads_match_jax(mode):
    """On the JAX init bridged: output, balance loss and the gradients of
    ``sum(y²) + aux`` w.r.t. every parameter and the input within 2e-5
    (JAX's own bound between its two dispatch modes)."""
    x = np.random.RandomState(0).randn(2, 16, 32).astype(np.float32)
    layer = _jax_layer(mode)
    params = nn.meta.unbox(layer.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))["params"]

    def jloss(p, xx):
        y, mut = layer.apply({"params": p}, xx, mutable=["intermediates"])
        aux = mut["intermediates"]["balance_loss"][0]
        return (y ** 2).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = _port_layer(params, mode)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = port(tx)
    ((y ** 2).sum() + aux).backward()
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(aux.item(), float(jaux), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(port.gate.weight.grad.numpy(),
                               np.asarray(jg["gate"]["kernel"]).T, **tol)
    for n in moe.EXPERT_LEAVES:
        np.testing.assert_allclose(getattr(port, n).grad.numpy(),
                                   np.asarray(jg[n]), err_msg=n, **tol)


def test_moe_dispatch_is_validated_like_jax():
    with pytest.raises(ValueError, match="moe_dispatch='dense'"):
        _port_layer({"gate": {"kernel": np.zeros((32, 4), np.float32)},
                     **{n: np.zeros(s, np.float32) for n, s in (
                         ("w_up", (4, 32, 64)), ("b_up", (4, 64)),
                         ("w_down", (4, 64, 32)), ("b_down", (4, 32)))}},
                    mode="dense")


def test_jax_moe_on_a_dp2_mesh_equals_one_device(eight_devices):
    """JAX's ``MoEMLP`` with its experts sharded over a dp 2 mesh computes
    the single device's output and balance loss: GSPMD routes the global
    batch, which is what the port's expert parallelism reproduces."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from fleetx_tpu.parallel.sharding import make_rules

    layer = _jax_layer("scatter")
    x = jnp.asarray(np.random.RandomState(3).randn(4, 16, 32), jnp.float32)
    variables = layer.init(jax.random.PRNGKey(1), x)

    def run(v, xx):
        y, mut = layer.apply(v, xx, mutable=["intermediates"])
        return y, mut["intermediates"]["balance_loss"][0]

    y1, aux1 = jax.jit(run)(variables, x)
    mesh = Mesh(np.array(eight_devices[:2]).reshape(1, 2, 1, 1, 1),
                ("pp", "dp", "fsdp", "cp", "mp"))
    with mesh, nn.logical_axis_rules(make_rules()):
        shardings = nn.logical_to_mesh_sharding(
            nn.get_partition_spec(variables), mesh, make_rules())
        sharded = jax.device_put(nn.meta.unbox(variables), shardings)
        xs = jax.device_put(x, NamedSharding(mesh, PartitionSpec("dp")))
        y2, aux2 = jax.jit(run)(sharded, xs)
    w_up = sharded["params"]["w_up"]
    assert len({s.index for s in w_up.addressable_shards}) == 2
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux2), float(aux1), rtol=1e-6)
