"""Rank programs of the port's tensor-parallel (mp) tests, and the tests
that need nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
these programs in fresh processes (the ranks of one gloo group on the CPU,
or ranks that share the card), which import this module and nothing of
JAX. The parity tests against the JAX package
(``test_torch_tensor_parallel.py``, ``test_torch_mp_training.py``) and the
card tests (``test_torch_cuda.py``) call them. The tests here hold the
port against itself in fp32: the mesh's groups, B12 against the unsharded
fused CE, and ``Trainer`` steps at cp 2 × mp 2 against one rank (mp 2 and
dp 2 × mp 2 are in ``test_torch_mp_layouts.py``). An mp layout changes
only the order of fp32 sums, so it is held to one rank within 1e-5 on
losses and 1e-4 on gradients.
"""

import os

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.parallel.launch import spawn
from fleetx_tpu_torch.parallel.mesh import build_mesh, set_mesh
from test_torch_cp_ranks import RANK_TIMEOUT, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")


def write_corpus(prefix, seed=0, n_docs=60, vocab=120):
    """A synthetic corpus (``{prefix}_ids.npy``, ``{prefix}_idx.npz``) from a
    numpy seed, as ``test_torch_training.write_corpus`` writes it."""
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, vocab, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(n_docs)]
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int32))


def overrides(tmp_path, name, *extra, seq=64):
    """The tiny config's overrides over a corpus of this package's own
    (each package caches its index maps next to the data)."""
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    write_corpus(str(d / "tiny"), n_docs=60)
    return [f"Data.Train.dataset.input_dir={d}/tiny",
            f"Data.Train.dataset.max_seq_len={seq}",
            f"Model.max_position_embeddings={seq}",
            "Model.use_flash_attention=True",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0",
            "Optimizer.lr.warmup_steps=0", "Optimizer.lr.max_lr=1e-3",
            "Optimizer.lr.decay_steps=100",
            f"Engine.save_load.output_dir={d}/out", *extra]


# ------------------------------------------------------------ rank programs

def vp_ce_program(h, w, labels, g, mp, device="cpu", dtype=torch.float32,
                  plain=False):
    """B12 on this rank: ``fused_linear_ce`` of the global numpy ``h`` [n,
    E] over this rank's vocab shard of ``w`` [V, E] with global ``labels``
    under an mp ``mp`` mesh, on ``device`` in ``dtype``, backward with the
    per-token cotangent ``g``. ``plain`` swaps B4-B6 for their plain
    versions. Returns (loss, dh, this rank's dW shard, this rank's partial
    dh before the sum over the shards) as fp32 numpy, and B12's launch
    counts."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    mesh = build_mesh(1, 1, mp)
    set_mesh(mesh)
    v_loc = w.shape[0] // mp
    shard = w[mesh.mp_rank * v_loc:(mesh.mp_rank + 1) * v_loc]
    ht = torch.from_numpy(h).to(device, dtype).requires_grad_()
    wt = torch.from_numpy(shard).to(device, dtype).requires_grad_()
    fns = {name: getattr(ce, name + ("_ref" if plain else ""))
           for name in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")}
    partial = []

    def dh_kept(*args):
        partial.append(fns["fused_ce_dh"](*args))
        return partial[-1]

    swapped = {name: getattr(ce, name) for name in fns}
    for name, fn in dict(fns, fused_ce_dh=dh_kept).items():
        setattr(ce, name, fn)
    before = dict(ce.vp_launches)
    try:
        loss = ce.fused_linear_ce(ht, wt, torch.from_numpy(labels).to(device),
                                  mp_group=mesh.mp_group)
        loss.backward(torch.from_numpy(g).to(device))
    finally:
        for name, fn in swapped.items():
            setattr(ce, name, fn)
    launched = {n: c - before[n] for n, c in ce.vp_launches.items()}
    return (tuple(t.detach().float().cpu().numpy()
                  for t in (loss, ht.grad, wt.grad, partial[0]))
            + (launched,))


def vp_ce(h, w, labels, g, mp=2, **kw):
    """B12 on ``mp`` spawned CPU ranks: (loss, dh, dW) with dW gathered
    over the shards; every rank's loss and dh must agree."""
    outs = run_ranks(vp_ce_program, mp, h, w, labels, g, mp)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0], outs[0][0])
        np.testing.assert_array_equal(o[1], outs[0][1])
    return outs[0][0], outs[0][1], np.concatenate([o[2] for o in outs])


def vp_loss_program(logits, labels, g, mp):
    """``vocab_parallel_token_losses`` on this rank's vocab shard of the
    global numpy ``logits`` [..., V], backward with cotangent ``g``:
    (losses, d logits of the shard) as numpy."""
    from fleetx_tpu_torch.parallel.tensor_parallel import (
        vocab_parallel_token_losses,
    )

    mesh = build_mesh(1, 1, mp)
    set_mesh(mesh)
    v_loc = logits.shape[-1] // mp
    shard = torch.from_numpy(
        logits[..., mesh.mp_rank * v_loc:(mesh.mp_rank + 1) * v_loc]
    ).requires_grad_()
    loss = vocab_parallel_token_losses(shard, torch.from_numpy(labels),
                                       mesh.mp_group)
    loss.backward(torch.from_numpy(g))
    return loss.detach().numpy(), shard.grad.numpy()


def mp_train_program(config, overrides, steps, params, device="cpu"):
    """``steps`` train steps of ``Trainer`` on this rank through the normal
    entry points (``get_config`` with the world's ranks, ``build_module``,
    ``build_dataloader``), from ``params`` (the WHOLE model's numpy state
    dict, which this rank cuts to its pipeline stage and shards for its mp
    rank; None: the seeded init). Returns the per-step losses and grad
    norms, this rank's shards of the first step's gradients after the
    data-group sum (numpy, by name), checksums of the final replicated and
    of all parameters, the first batch's tokens, the mesh coordinates
    (dp, cp, mp; the stage apart) and the launch counts of B1-B3 and
    B12."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models.gpt.convert import local_params
    from fleetx_tpu_torch.ops import ce_loss as ce
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(overrides))
    module = build_module(cfg)
    trainer = Trainer(cfg, module, device=device)
    mesh = trainer.mesh
    trainer.init_state(None if params is None else local_params(
        {n: torch.from_numpy(p) for n, p in params.items()},
        module.gpt_config, mesh.mp_rank, mesh.pp_rank))
    names = [n for n, _ in module.nets.named_parameters()]
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        if not grads:  # copies: the clip scales gs in place
            # under the ZeRO update shard the clip sees this rank's slices:
            # gathered to the whole gradients (a collective of every rank)
            whole = gs if trainer.zero is None else trainer.zero.whole(gs)
            grads.extend(g.detach().float().cpu().numpy().copy()
                         for g in whole)
        return clip(gs, norm)

    trainer.clip = capture
    loader = iter(build_dataloader(cfg, "Train"))
    counts = (fa.launches, ce.launches, ce.vp_launches)
    before = {k: v for c in counts for k, v in c.items()}
    first, outs = None, []
    for _ in range(steps):
        batch = next(loader)
        first = batch["tokens"] if first is None else first
        outs.append(trainer.train_step(trainer._to_device(batch)))

    def checksum(replicated_only):
        return float(sum(p.detach().double().sum() for n, p in
                         module.nets.named_parameters()
                         if not replicated_only or n not in trainer.mp_split))

    return {"losses": [float(o["loss"]) for o in outs],
            "grad_norms": [float(o["grad_norm"]) for o in outs],
            "grads": dict(zip(names, grads)),
            "replicated": checksum(True), "checksum": checksum(False),
            "tokens": np.asarray(first), "n_params": trainer.n_params,
            "coords": (mesh.dp_rank, mesh.cp_rank, mesh.mp_rank),
            "pp_rank": mesh.pp_rank,
            "launches": {k: v - before[k] for c in counts
                         for k, v in c.items()}}


def spawn_on_card(fn, nprocs, *args):
    """``fn(*args)`` on ``nprocs`` ranks that share the card (gloo)."""
    return spawn(fn, nprocs, args, device="cuda", timeout=RANK_TIMEOUT)


def gathered_grads(runs, cfg):
    """The whole model's first-step gradients from the ranks of the first
    mp group of ``runs`` (rank order) of the model of GPTConfig ``cfg``,
    by name, as numpy."""
    from fleetx_tpu_torch.models.gpt.convert import gather_params

    full = gather_params([{n: torch.from_numpy(g) for n, g in
                           r["grads"].items()}
                          for r in runs[:cfg.mp_degree]], cfg)
    return {n: g.numpy() for n, g in full.items()}


def check_replicas(runs, mp):
    """Every rank the same losses and grad norms; the ranks of one mp group
    the same replicated parameters, and the replicas (the same mp rank in
    every data group) the same parameters."""
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
        assert r["grad_norms"] == runs[0]["grad_norms"]
        assert r["replicated"] == runs[0]["replicated"]
    for i, r in enumerate(runs):
        assert r["checksum"] == runs[i % mp]["checksum"]


def _mesh_program(dp, cp, mp):
    """The coordinates seen from this rank, and the sum of the rank ids
    over each of its groups."""
    import torch.distributed as dist

    mesh = build_mesh(dp, cp, mp)
    set_mesh(mesh)
    sums = []
    for group in (mesh.mp_group, mesh.cp_group, mesh.data_group):
        t = torch.tensor([float(mesh.rank)])
        if group is not None:
            dist.all_reduce(t, group=group)
        sums.append(int(t))
    return (mesh.dp_rank, mesh.cp_rank, mesh.mp_rank, mesh.cp_ranks,
            tuple(sums))


# ---------------------------------------------------------------- tests

@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)



@pytest.mark.parametrize("dp,cp,mp,want", [
    # rank = (dp_rank * cp + cp_rank) * mp + mp_rank: the mp groups are
    # adjacent ranks, the cp rings stride by mp, the data group is every
    # rank of one mp rank
    (1, 2, 2, [(0, 0, 0, (0, 2), (1, 2, 2)),
               (0, 0, 1, (1, 3), (1, 4, 4)),
               (0, 1, 0, (0, 2), (5, 2, 2)),
               (0, 1, 1, (1, 3), (5, 4, 4))]),
    (2, 1, 2, [(0, 0, 0, (0,), (1, 0, 2)),
               (0, 0, 1, (1,), (1, 1, 4)),
               (1, 0, 0, (2,), (5, 2, 2)),
               (1, 0, 1, (3,), (5, 3, 4))]),
], ids=["cp2xmp2", "dp2xmp2"])
def test_mesh_lays_mp_ranks_adjacent_and_strides_the_others(dp, cp, mp,
                                                            want):
    """Over 4 gloo ranks: each rank's (dp, cp, mp) coordinates, its cp ring
    and the sums of the rank ids over its mp, cp and data groups (an
    axis of one rank has no group: its sum is the rank itself)."""
    got = run_ranks(_mesh_program, dp * cp * mp, dp, cp, mp)
    assert got == want


def test_b12_equals_the_unsharded_fused_ce():
    """B12 at mp 2 (plain versions on the CPU) equals the unsharded
    ``fused_linear_ce`` with the same per-token cotangent: loss, dh and the
    gathered dW, labels including -1 (no label logit on either shard) and
    both vocab ends."""
    from fleetx_tpu_torch.ops.ce_loss import fused_linear_ce

    rng = np.random.RandomState(3)
    n, e, v = 32, 64, 256
    h = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) * 0.3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[:3] = [-1, 0, v - 1]
    g = rng.rand(n).astype(np.float32)
    loss, dh, dw = vp_ce(h, w, labels, g)
    ht, wt = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    want = fused_linear_ce(ht, wt, torch.from_numpy(labels))
    want.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss, want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dh, ht.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dw, wt.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_shard_rows_of_b12_see_only_their_labels():
    """With every label on shard 0, shard 1's label logits are all 0: its
    dW is the softmax term alone (b's one-hot adds nothing there)."""
    rng = np.random.RandomState(4)
    n, e, v = 16, 64, 256
    h = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) * 0.3).astype(np.float32)
    labels = rng.randint(0, v // 2, n).astype(np.int32)
    g = np.ones(n, np.float32)
    outs = run_ranks(vp_ce_program, 2, h, w, labels, g, 2)
    # Σ over tokens of dl = g·(p − onehot) per column: on shard 1 no
    # one-hot, so every dW row is Σ p·h with p > 0
    hw = torch.from_numpy(h) @ torch.from_numpy(w).t()
    p = torch.softmax(hw, -1)[:, v // 2:]
    np.testing.assert_allclose(outs[1][2], (p.t() @ torch.from_numpy(h))
                               .numpy(), rtol=1e-4, atol=1e-6)


def test_b12_counts_no_launch_for_its_plain_versions():
    """On CPU tensors B12's entries run the plain versions of B4-B6, which
    launch nothing: ``vp_launches`` stays 0 on every rank."""
    rng = np.random.RandomState(5)
    h = rng.randn(8, 64).astype(np.float32)
    w = rng.randn(128, 64).astype(np.float32)
    labels = rng.randint(0, 128, 8).astype(np.int32)
    outs = run_ranks(vp_ce_program, 2, h, w, labels, np.ones(8, np.float32),
                     2)
    assert all(o[4] == {"vp_ce_fwd": 0, "vp_ce_dh": 0, "vp_ce_dw": 0}
               for o in outs)


def single_rank_steps(config_over, steps):
    """``steps`` train steps of one rank (mp 1) on the tiny config with
    ``config_over``: (losses, grad norms)."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(TINY, overrides=config_over, nranks=1)
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    loader = iter(build_dataloader(cfg, "Train"))
    outs = [trainer.train_step(trainer._to_device(next(loader)))
            for _ in range(steps)]
    return ([float(o["loss"]) for o in outs],
            [float(o["grad_norm"]) for o in outs])


def test_cp2_mp2_matches_cp1(tmp_path):
    """cp 2 x mp 2 (4 ranks: the ring over ranks of one mp rank, stride 2)
    against one rank at cp 1, mp 1: two steps at attention dropout 0.1
    (the ring's pairs key on global heads and positions; hidden dropout 0,
    whose mask follows the zig-zag order under cp) within 1e-5; every rank
    the same losses, replicated parameters equal."""
    base = overrides(tmp_path, "torch",
                     "Model.attention_probs_dropout_prob=0.1",
                     "Global.local_batch_size=2",
                     "Global.micro_batch_size=2", seq=256)
    want, norms = single_rank_steps(base, 2)
    runs = run_ranks(mp_train_program, 4, TINY,
                     base + ["Distributed.cp_degree=2",
                             "Distributed.mp_degree=2"], 2, None)
    assert [r["coords"] for r in runs] == [(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                           (0, 1, 1)]
    np.testing.assert_allclose(runs[0]["losses"], want, rtol=1e-5)
    np.testing.assert_allclose(runs[0]["grad_norms"], norms, rtol=1e-5)
    check_replicas(runs, 2)
