"""Pipeline parallelism of the PyTorch port against the JAX package: the
param-tree remaps, pipeline-layout trees through ``params_from_jax`` and
into generation, and the loss over microbatches whose mask counts differ.

The trees are the tiny config's GPT cut to 4 layers (the JAX module's own
init, numpy), in the three layouts JAX writes: pp 2, and pp 2 with 2
virtual stages streamed (one ``pipe`` tree of 4 rows) or in sequential
chunks (``pipe_chunk{j}``). The remaps must be bit-equal to JAX's; the
loss at pp 2 (2 gloo ranks, the plain versions of B1-B3 on the CPU)
within 1e-5 of JAX's pp 2 loss and every gradient leaf within 1e-4 (the
tolerances ``test_torch_mp_training.py`` holds mp to), with
``FLEETX_FORCE_FLASH=1`` so that JAX takes its Pallas kernels in
interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.parallel import pipeline as jax_pipeline
from fleetx_tpu.parallel.mesh import use_mesh
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import gather_stages, params_from_jax
from fleetx_tpu_torch.parallel import pipeline
from fleetx_tpu_torch.parallel.mesh import set_mesh
from fleetx_tpu_torch.utils.config import get_config
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_pp_ranks import joined, pp_step_program

LAYOUTS = [pytest.param(2, 1, True, id="pp2"),
           pytest.param(2, 2, True, id="pp2xv2-streamed"),
           pytest.param(2, 2, False, id="pp2xv2-chunks")]
FOUR = ("Model.num_layers=4",)


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The JAX module's init of the 4-layer tiny GPT (numpy, sequential
    layout, ``{"params": ...}``) and the port's config of it."""
    tmp = tmp_path_factory.mktemp("seq")
    jcfg = jax_get_config(TINY, overrides=overrides(tmp, "jax", *FOUR),
                          nranks=1)
    tree = jax.tree.map(np.asarray, nn.meta.unbox(
        jax_build_module(jcfg).nets.init(jax.random.PRNGKey(3),
                                         jnp.zeros((1, 8), jnp.int32))))
    tcfg = get_config(TINY, overrides=overrides(tmp, "torch", *FOUR),
                      nranks=1)
    return tree, build_module(tcfg).gpt_config


def flat(tree) -> dict:
    return flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree["params"]), sep="/")


def assert_same_tree(got, want):
    """The same leaves, the same dtypes and the same bits."""
    a, b = flat(got), flat(want)
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


@pytest.mark.parametrize("pp,v,stream", LAYOUTS)
def test_remaps_are_bit_equal_to_jax(seq, pp, v, stream):
    """The numpy remaps give JAX's pipeline tree from the sequential one,
    and the sequential one back from JAX's (its inverse and the
    ``maybe_`` form), bit for bit; a sequential tree passes unchanged."""
    tree, _ = seq
    theirs = jax_pipeline.sequential_params_to_pipeline(tree, pp, v,
                                                        stream=stream)
    assert_same_tree(pipeline.sequential_params_to_pipeline(
        tree, pp, v, stream=stream), theirs)
    back = pipeline.pipeline_params_to_sequential(theirs)
    assert_same_tree(back, jax_pipeline.pipeline_params_to_sequential(theirs))
    assert_same_tree(back, tree)
    assert_same_tree(pipeline.maybe_pipeline_params_to_sequential(theirs),
                     tree)
    assert pipeline.maybe_pipeline_params_to_sequential(tree) is tree
    scope = "pipe" if v == 1 or stream else "pipe_chunk1"
    assert scope in theirs["params"]["gpt"]["layers"]


@pytest.mark.parametrize("pp,v,stream", LAYOUTS)
def test_params_from_jax_reads_pipeline_trees(seq, pp, v, stream):
    """``params_from_jax`` of a JAX pipeline tree gives its sequential
    twin's state dict bit for bit; at pp each stage's part holds the
    layers of its chunks (chunk g of pp · v on stage g mod pp), and the
    stages joined give the whole again."""
    tree, gcfg = seq
    pipe = jax_pipeline.sequential_params_to_pipeline(tree, pp, v,
                                                      stream=stream)
    want = params_from_jax(tree, gcfg)
    got = params_from_jax(pipe, gcfg)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[n], want[n]) for n in want)
    staged = dataclasses.replace(gcfg, pp_degree=pp, virtual_pp_degree=v)
    parts = [params_from_jax(pipe, staged, pp_rank=p) for p in range(pp)]
    layers = [sorted({int(n.split(".")[2]) for n in part
                      if n.startswith("gpt.layers.")}) for part in parts]
    assert layers == ([[0, 1], [2, 3]] if v == 1 else [[0, 2], [1, 3]])
    assert "gpt.word_embeddings" in parts[0] and "gpt.word_embeddings" in \
        parts[-1]
    assert "gpt.final_norm.scale" in parts[-1] and \
        "gpt.position_embeddings" not in parts[-1]
    whole = gather_stages(parts)
    assert whole.keys() == want.keys()
    assert all(torch.equal(whole[n], want[n]) for n in want)


@pytest.mark.parametrize("pp,v,stream", LAYOUTS)
def test_generation_decodes_a_pipeline_tree_as_its_sequential_twin(
        seq, tmp_path, pp, v, stream):
    """``GPTGenerationModule.set_state`` of a JAX pipeline-layout tree (JAX
    ``set_state``, language_module_generation.py:40-42) decodes the greedy
    tokens of the sequential tree, byte for byte."""
    tree, _ = seq
    pipe = jax_pipeline.sequential_params_to_pipeline(tree, pp, v,
                                                      stream=stream)
    over = overrides(tmp_path, "torch", *FOUR,
                     "Model.module=GPTGenerationModule",
                     "Generation.decode_strategy=greedy",
                     "Generation.max_dec_len=6",
                     "Generation.eos_token_id=1000",
                     "Generation.pad_token_id=0")
    ids = np.random.RandomState(2).randint(0, 128, (2, 5)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    outs = []
    for state in (pipe, tree):
        module = build_module(get_config(TINY, overrides=over, nranks=1))
        module.set_state(state, device="cpu")
        outs.append(module.generate_ids(ids, attention_mask=mask))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 11)


def unequal_batch(seed=9, rows=4, seq=64, vocab=128) -> dict:
    """A batch of 2 microbatches of 2 rows whose loss masks count 128 and
    40 tokens."""
    rng = np.random.RandomState(seed)
    mask = np.ones((rows, seq), np.float32)
    mask[2:, 20:] = 0.0
    return {"tokens": rng.randint(0, vocab, (rows, seq)).astype(np.int64),
            "position_ids": np.tile(np.arange(seq, dtype=np.int64),
                                    (rows, 1)),
            "labels": rng.randint(0, vocab, (rows, seq)).astype(np.int64),
            "loss_mask": mask}


def test_masked_mean_over_unequal_microbatches_matches_jax(tmp_path,
                                                           monkeypatch):
    """pp 2 over 2 microbatches whose mask counts differ (128 and 40): the
    loss is JAX's whole-batch masked mean and every gradient leaf JAX's
    pp 2 gradient, on 2 ranks; one rank accumulating the same 2
    microbatches (the mean of their means) lies off it."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    extra = ("Distributed.pp_degree=2", "Global.local_batch_size=4",
             "Global.micro_batch_size=2", *FOUR)
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *extra),
                          nranks=2)
    jmod = jax_build_module(jcfg)
    assert jmod.gpt_config.num_microbatches == 2
    batch = unequal_batch()
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                             else v) for k, v in batch.items()}
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(jbatch)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    with use_mesh(jtrainer.mesh):
        jl, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jmod.loss_fn(p, jbatch, None, train=False)[0]))(params)

    whole = build_module(get_config(
        TINY, overrides=overrides(tmp_path, "torch", *FOUR), nranks=1)
    ).gpt_config
    init = {n: t.numpy() for n, t in
            params_from_jax({"params": params}, whole).items()}
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           whole)
    over = overrides(tmp_path, "torch", *extra)
    runs = run_ranks(pp_step_program, 2, TINY, over, init, batch)
    for r in runs:
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-5)
        assert (r["loss"], r["grad_norm"]) == (runs[0]["loss"],
                                               runs[0]["grad_norm"])
    got = joined(runs)
    assert got.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    means = run_ranks(pp_step_program, 1, TINY,
                      overrides(tmp_path, "torch", *extra[1:]), init, batch)
    assert abs(means[0]["loss"] - float(jl)) > 1e-2
