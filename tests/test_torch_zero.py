"""The port's ZeRO weight-update shard and elastic planners against the
JAX package.

- ``parallel/sharding.zero_update_spec`` (the port's copy of JAX's rule)
  gives JAX's weight-update specs on the tiny model's leaves, as the JAX
  ``Trainer`` derives them (``_zero_param_shardings`` of its
  ``_state_shardings``), at fsdp 2, dp 2 × mp 2 and dp 2 × fsdp 2 × mp 2
  on 8 virtual devices.
- The port's ``Trainer`` at sharding 2 (stage 2) and at dp 2, the update
  shard on, matches the JAX ``Trainer`` on the same mesh after 3 steps
  from the JAX init (bridged by ``params_from_jax``; fp32, flash on with
  ``FLEETX_FORCE_FLASH=1`` so JAX runs its Pallas kernels in interpret
  mode): every parameter within ``test_zero_update.py``'s ``atol 2e-6``
  and the losses within 1e-5. The ranks are spawned gloo processes
  (``test_torch_zero_ranks.py``).
- ``resilience/elastic.plan_shrunken_mesh`` and ``apply_mesh_to_config``
  give JAX's results, and raise where JAX raises, on the same inputs.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.parallel import mesh as jax_mesh
from fleetx_tpu.parallel.sharding import param_shardings
from fleetx_tpu.resilience import elastic as jax_elastic
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.parallel import mesh as port_mesh
from fleetx_tpu_torch.parallel.mesh import set_mesh
from fleetx_tpu_torch.parallel.sharding import zero_update_spec
from fleetx_tpu_torch.resilience import elastic
from fleetx_tpu_torch.utils.config import get_config
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_zero_ranks import STEPS, zero_fit_program

MESHES = {
    "fsdp2": (2, ("Distributed.sharding.sharding_degree=2",
                  "Distributed.sharding.sharding_stage=2")),
    "dp2xmp2": (4, ("Distributed.dp_degree=2", "Distributed.mp_degree=2")),
    "dp2xfsdp2xmp2": (8, ("Distributed.dp_degree=2",
                          "Distributed.mp_degree=2",
                          "Distributed.sharding.sharding_degree=2",
                          "Distributed.sharding.sharding_stage=2")),
}


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def _jax_trainer(tmp_path, nranks, extra):
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *extra),
                          nranks=nranks)
    jmod = jax_build_module(jcfg)
    jloader = jax_build_dataloader(jcfg, "Train")
    batch = {k: jnp.asarray(v) for k, v in next(iter(jloader)).items()}
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(batch)
    return jtrainer, jmod, jloader


@pytest.mark.parametrize("name", sorted(MESHES))
def test_zero_update_spec_matches_jax_on_the_tiny_model(tmp_path,
                                                        monkeypatch, name):
    """On every leaf of the tiny model (its shape and its mp spec), the
    port's rule gives the weight-update spec the JAX ``Trainer`` derived,
    and most leaves are sharded over a data axis."""
    monkeypatch.setenv("FLEETX_ZERO_UPDATE", "1")
    nranks, extra = MESHES[name]
    jtrainer, _, _ = _jax_trainer(tmp_path, nranks, extra)
    sizes = dict(jtrainer.mesh.shape)
    base = jax.tree.leaves(param_shardings(jtrainer.state.params,
                                           jtrainer.mesh, jtrainer.rules))
    zero = jax.tree.leaves(jtrainer._zero_param_shardings)
    leaves = jax.tree.leaves(nn.meta.unbox(jtrainer.state.params))
    assert len(base) == len(zero) == len(leaves) > 10
    folded = 0
    for leaf, b, z in zip(leaves, base, zero):
        got = zero_update_spec(tuple(b.spec), leaf.shape, sizes)
        want = tuple(z.spec)
        # a spec compares equal with or without its trailing Nones
        assert got + (None,) * (len(want) - len(got)) == \
            want + (None,) * (len(got) - len(want)), (leaf.shape, b.spec)
        folded += any(a in (e if isinstance(e, tuple) else (e,))
                      for e in want for a in ("dp", "fsdp"))
    assert folded > len(leaves) // 2


@pytest.mark.parametrize("name,extra", [
    ("fsdp2", ("Distributed.sharding.sharding_degree=2",
               "Distributed.sharding.sharding_stage=2")),
    ("dp2", ("Distributed.dp_degree=2",)),
])
def test_sharded_trainer_matches_the_jax_trainer(tmp_path, monkeypatch,
                                                 name, extra):
    """Three steps at ``name`` on 2 ranks with the update shard on, from
    the JAX init, against the JAX ``Trainer`` on the same 2-device mesh:
    the losses within 1e-5, every parameter within 2e-6, both ranks bit
    for bit equal.

    AdamW's epsilon is 1e-6 here, not the yaml's 1e-8: the key bias's
    gradient is zero in exact arithmetic (softmax ignores a constant added
    to every key), so both packages hold fp32 summation noise of ~1e-10
    there, and at epsilon 1e-8 AdamW's first steps turn that noise into
    updates of up to lr / 2, whose sign is the noise's (6e-6 apart between
    the packages on those 64 elements at lr 1e-3). The layouts within one
    package agree at 1e-8 (``test_torch_zero_ranks.py``)."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    monkeypatch.setenv("FLEETX_ZERO_UPDATE", "1")
    extra = extra + ("Global.local_batch_size=2",
                     "Global.micro_batch_size=1", "Optimizer.epsilon=1e-6",
                     f"Engine.max_steps={STEPS}", "Engine.logging_freq=1")
    jtrainer, jmod, jloader = _jax_trainer(tmp_path, 2, extra)
    assert jtrainer._zero_update
    init = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    jlosses = []
    monkeypatch.setattr(jmod, "training_step_end",
                        lambda log: jlosses.append(log["loss"]))
    jtrainer.fit(jloader)
    assert len(jlosses) == STEPS
    gcfg = build_module(get_config(
        TINY, overrides=overrides(tmp_path, "torch"), nranks=1)).gpt_config
    start = {n: t.numpy() for n, t in
             params_from_jax({"params": init}, gcfg).items()}
    want = params_from_jax({"params": jax.tree.map(
        np.asarray, nn.meta.unbox(jtrainer.state.params))}, gcfg)
    runs = run_ranks(zero_fit_program, 2, TINY,
                     overrides(tmp_path, "torch", *extra), STEPS, start)
    assert [r["zero"] for r in runs] == [True, True]
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    for n, w in want.items():
        np.testing.assert_array_equal(runs[0]["params"][n],
                                      runs[1]["params"][n], err_msg=n)
        np.testing.assert_allclose(runs[0]["params"][n], w.numpy(), rtol=0,
                                   atol=2e-6, err_msg=f"{name} {n}")


SHRINKS = [dict(dp=4), dict(dp=2, fsdp=2), dict(fsdp=4),
           dict(dp=2, mp=2), dict(dp=4, pp=2), dict(dp=3, fsdp=2),
           dict(mp=2), dict(dp=3), dict(fsdp=2, cp=2)]


@pytest.mark.parametrize("degrees", SHRINKS,
                         ids=["-".join(f"{k}{v}" for k, v in d.items())
                              for d in SHRINKS])
def test_plan_shrunken_mesh_matches_jax(degrees):
    """dp gives up ranks first, then fsdp; a mesh with neither to give up
    raises ``ElasticMeshMismatch`` in both packages."""
    def plan(module, cfg_cls):
        try:
            return dataclasses.asdict(
                module.plan_shrunken_mesh(cfg_cls(**degrees)))
        except module.ElasticMeshMismatch as e:
            return str(e)

    assert plan(elastic, port_mesh.MeshConfig) == \
        plan(jax_elastic, jax_mesh.MeshConfig)


@pytest.mark.parametrize("start,shrunk,local,micro", [
    ((4, 1), (2, 1), 2, 2),
    ((4, 1), (2, 1), 2, 1),
    ((2, 2), (1, 2), 2, 1),
    ((1, 4), (1, 2), 2, 1),
    ((2, 2), (1, 1), 2, 2),
    ((4, 1), (3, 1), 2, 2),
    ((2, 1), (1, 1), 3, 1),
], ids=["dp4-dp2", "dp4-dp2-accum2", "dp2fsdp2-fsdp2", "fsdp4-fsdp2",
        "dp2fsdp2-one", "gbs-indivisible", "accum-kept"])
def test_apply_mesh_to_config_matches_jax(tmp_path, start, shrunk, local,
                                          micro):
    """The config rewritten for the shrunken mesh: the same degrees and
    batch sizes (the global batch and the accumulation factor held), or
    the same refusal."""
    dp, fsdp = start
    over = [f"Distributed.dp_degree={dp}",
            f"Distributed.sharding.sharding_degree={fsdp}",
            f"Global.local_batch_size={local}",
            f"Global.micro_batch_size={micro}"]

    def rewrite(get, module, cfg_cls, name):
        cfg = get(TINY, overrides=overrides(tmp_path, name, *over),
                  nranks=dp * fsdp)
        try:
            module.apply_mesh_to_config(cfg, cfg_cls(dp=shrunk[0],
                                                     fsdp=shrunk[1]))
        except module.ElasticMeshMismatch as e:
            return str(e)
        g = cfg.Global
        return (cfg.Distributed.dp_degree,
                cfg.Distributed.sharding.sharding_degree,
                g.global_batch_size, g.local_batch_size, g.micro_batch_size)

    ours = rewrite(get_config, elastic, port_mesh.MeshConfig, "torch")
    assert ours == rewrite(jax_get_config, jax_elastic, jax_mesh.MeshConfig,
                           "jax")
