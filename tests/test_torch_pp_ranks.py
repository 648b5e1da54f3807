"""Rank programs of the port's pipeline-parallel (pp) tests, and the tests
that need nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
these programs in fresh processes (the ranks of one gloo group on the CPU,
or ranks that share the card), which import this module and nothing of
JAX. The parity tests against the JAX package
(``test_torch_pipeline.py``, ``test_torch_pp_training.py``) and the card
tests (``test_torch_cuda.py``) call them, and so does
``test_torch_pp_resume.py`` (a pp 2 checkpoint resumed bit for bit,
refused at another layout, and decoded from its stage files). The tests
here hold the port's pipeline against itself: the mesh's pp groups, and
pp 2 (also with virtual stages and with mp) against one rank accumulating
over the same microbatches with dropout on. A pipeline changes only the
order of fp32 sums, so it is held to one rank within 1e-5 on losses and
1e-4 on gradients, as mp is.
"""

import hashlib

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, mp_train_program, overrides

# the tiny config cut into 4 layers, 2 microbatches of 2 rows, dropout on
PP_OVER = ("Model.num_layers=4", "Global.local_batch_size=4",
           "Global.micro_batch_size=2", "Model.hidden_dropout_prob=0.1",
           "Model.attention_probs_dropout_prob=0.1")


# ------------------------------------------------------------ rank programs

def pp_mesh_program(config, overrides):
    """``mesh_from_config`` of the config on this rank: its coordinates,
    stage flags, pipeline and the sums of the rank ids over its pp,
    embedding, data and mp groups (an axis of one rank has no group: its
    sum is the rank itself)."""
    import torch.distributed as dist

    from fleetx_tpu_torch.parallel.mesh import mesh_from_config
    from fleetx_tpu_torch.utils.config import get_config

    mesh = mesh_from_config(get_config(config, overrides=list(overrides)))
    sums = []
    for group in (mesh.pp_group, mesh.embed_group, mesh.data_group,
                  mesh.mp_group):
        t = torch.tensor([float(mesh.rank)])
        if group is not None:
            dist.all_reduce(t, group=group)
        sums.append(int(t))
    return (mesh.pp_rank, mesh.dp_rank, mesh.mp_rank, mesh.is_first_stage,
            mesh.is_last_stage, mesh.pp_ranks, tuple(sums))


def transport_program(device="cpu"):
    """Both directions of a pp 2 group's transport on this rank: stage 0
    sends three tensors (bf16, fp32, bf16) back to back, then receives
    stage 1's three; stage 1 receives first, then sends. Returns the bytes
    of what it sent and of what it received (by dtype and shape), and
    whether every received tensor landed on ``device``."""
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.parallel.pipeline import Transport

    mesh = build_mesh(pp=2)
    set_mesh(mesh)
    transport = Transport(mesh.pp_group)
    other = mesh.pp_ranks[1 - mesh.pp_rank]
    gen = torch.Generator().manual_seed(mesh.rank)
    sent = [torch.randn(shape, generator=gen).to(dtype) for shape, dtype in
            (((3, 5, 8), torch.bfloat16), ((7,), torch.float32),
             ((2, 64, 16), torch.bfloat16))]
    got = []

    def receive():
        for t in sent:
            got.append(transport.recv(t.shape, t.dtype, other, device))

    if mesh.pp_rank == 1:
        receive()
    for t in sent:
        transport.send(t.to(device), other)
    if mesh.pp_rank == 0:
        receive()
    transport.wait_sends()

    def raw(t):
        return (str(t.dtype), tuple(t.shape),
                t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes())

    return ([raw(t) for t in sent], [raw(t) for t in got],
            all(t.device.type == torch.device(device).type for t in got))


def digests(trainer) -> dict:
    """sha256 of every parameter, AdamW state tensor and the generator of
    ``trainer``, by name."""
    out = {}
    for n, p in trainer.module.nets.named_parameters():
        tensors = [("", p.detach())] + [
            (":" + k, v) for k, v in
            trainer.optimizer.state.get(p, {}).items()]
        for suffix, t in tensors:
            out[n + suffix] = hashlib.sha256(
                t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
            ).hexdigest()
    out["generator"] = hashlib.sha256(
        trainer.generator.get_state().numpy().tobytes()).hexdigest()
    return out


def pp_fit_program(config, overrides, resume_step=None, device="cpu"):
    """A fresh ``Trainer`` of the config (whose overrides name its output
    directory) fitted to its max_steps; with ``resume_step`` it restores
    that step first and its sampler starts after the consumed samples.
    Returns the per-step losses and grad norms, the digests of its
    tensors, its step, consumed samples, stage, parameters (numpy, by
    name) and B1-B3 launches; or the message of an
    ``ElasticMeshMismatch`` the restore raised."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.resilience.elastic import ElasticMeshMismatch
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(overrides))
    trainer = Trainer(cfg, build_module(cfg), device=device)
    loader = build_dataloader(cfg, "Train")
    try:
        trainer.init_state()
    except ElasticMeshMismatch as e:
        return {"refused": str(e)}
    if resume_step is not None:
        if not (trainer.load(step=resume_step)
                and trainer.step == resume_step):
            raise AssertionError(f"resumed at step {trainer.step}")
        loader.batch_sampler.consumed_samples = trainer.consumed_samples
    before = dict(fa.launches)
    trainer.fit(loader)
    return {"losses": [float(h["loss"]) for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "digests": digests(trainer), "step": trainer.step,
            "consumed": trainer.consumed_samples,
            "pp_rank": trainer.mesh.pp_rank,
            "params": {n: p.detach().cpu().numpy() for n, p in
                       trainer.module.nets.named_parameters()},
            "launches": {k: v - before[k] for k, v in fa.launches.items()}}


def joined(runs, key="grads"):
    """The whole model's ``key`` entries (numpy, by name) from the stages
    of an mp 1 pipeline's ``runs``, each name from the first stage that
    holds it."""
    out = {}
    for r in sorted(runs, key=lambda r: r["pp_rank"]):
        for n, g in r[key].items():
            out.setdefault(n, g)
    return out


def pp_step_program(config, overrides, params, batch):
    """One ``Trainer`` step on this rank's dp rows of the global numpy
    ``batch``, from ``params`` (the whole model's numpy state dict, cut to
    this rank's stage and mp shards): the loss, the grad norm, this rank's
    gradients after the data-group and tied sums (numpy, by name) and its
    stage."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models.gpt.convert import local_params
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(overrides))
    module = build_module(cfg)
    trainer = Trainer(cfg, module, device="cpu")
    mesh = trainer.mesh
    trainer.init_state(local_params(
        {n: torch.from_numpy(p) for n, p in params.items()},
        module.gpt_config, mesh.mp_rank, mesh.pp_rank))
    names = [n for n, _ in module.nets.named_parameters()]
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        grads.extend(g.detach().numpy().copy() for g in gs)
        return clip(gs, norm)

    trainer.clip = capture
    b = batch["tokens"].shape[0] // mesh.dp
    rows = {k: v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
            for k, v in batch.items()}
    out = trainer.train_step(trainer._to_device(rows))
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "grads": dict(zip(names, grads)), "pp_rank": mesh.pp_rank}


# ---------------------------------------------------------------- tests

@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_mesh_from_config_builds_a_pp2_mesh(tmp_path):
    """``Distributed.pp_degree=2`` at mp 2 over 4 gloo ranks: pp is the
    outermost axis (rank = pp_rank · 2 + mp_rank), each pipeline joins the
    ranks of one mp rank, the embedding group is the first and the last
    stage, the data group is the rank alone (dp 1) and the mp group the
    stage's two ranks."""
    over = overrides(tmp_path, "torch", "Distributed.pp_degree=2",
                     "Distributed.mp_degree=2", "Model.num_layers=4")
    got = run_ranks(pp_mesh_program, 4, TINY, over)
    assert got == [
        (0, 0, 0, True, False, (0, 2), (2, 2, 0, 1)),
        (0, 0, 1, True, False, (1, 3), (4, 4, 1, 1)),
        (1, 0, 0, False, True, (0, 2), (2, 2, 2, 5)),
        (1, 0, 1, False, True, (1, 3), (4, 4, 3, 5))]


def test_pp_with_cp_raises_naming_pipeline_parallelism(tmp_path):
    """pp × cp is not ported: ``mesh_from_config`` raises naming the
    ROADMAP item before it builds a group."""
    from fleetx_tpu_torch.parallel.mesh import mesh_from_config
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(TINY, overrides=overrides(
        tmp_path, "torch", "Distributed.pp_degree=2",
        "Distributed.cp_degree=2"), nranks=4)
    with pytest.raises(NotImplementedError,
                       match='ROADMAP Queue A, "Pipeline parallelism"'):
        mesh_from_config(cfg)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The overrides of the dropout drive and one rank's two steps of it
    (``mp_train_program``), accumulating over its 2 microbatches."""
    base = overrides(tmp_path_factory.mktemp("pp"), "torch", *PP_OVER)
    return base, run_ranks(mp_train_program, 1, TINY, base, 2, None)[0]


@pytest.mark.parametrize("layout,nprocs", [
    (("Distributed.pp_degree=2",), 2),
    (("Distributed.pp_degree=2", "Model.virtual_pp_degree=2"), 2),
    (("Distributed.pp_degree=2", "Distributed.mp_degree=2"), 4),
], ids=["pp2", "pp2xv2", "pp2xmp2"])
def test_pp_with_dropout_equals_one_rank_accumulating(one_rank, layout,
                                                      nprocs):
    """Two steps at hidden and attention dropout 0.1 over 2 microbatches:
    the pipeline draws every layer's seeds as one rank accumulating over
    the same microbatches draws them, so its losses, grad norms and
    first-step gradients (the stages joined, the mp shards gathered)
    equal that rank's within 1e-5 and 1e-4; every rank logs the same
    losses, and the tied embedding's two copies stay bit-equal."""
    from fleetx_tpu_torch.models.gpt.convert import gather_params

    base, ref = one_rank
    runs = run_ranks(mp_train_program, nprocs, TINY, base + list(layout),
                     2, None)
    for r in runs:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=1e-5)
        assert r["losses"] == runs[0]["losses"]
        assert r["grad_norms"] == runs[0]["grad_norms"]
        assert r["n_params"] == ref["n_params"]
    mp = 2 if nprocs == 4 else 1
    stages = [joined([r for r in runs if r["coords"][2] == m])
              for m in range(mp)]
    from fleetx_tpu_torch.models.gpt.model import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                    num_attention_heads=4, ffn_hidden_size=128, mp_degree=mp)
    got = gather_params([{n: torch.from_numpy(g) for n, g in s.items()}
                         for s in stages], cfg)
    assert got.keys() == ref["grads"].keys()
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    first, last = (r for r in runs[:2 * mp:mp])
    assert first["pp_rank"] == 0 and last["pp_rank"] == 1
    np.testing.assert_array_equal(first["grads"]["gpt.word_embeddings"],
                                  last["grads"]["gpt.word_embeddings"])
