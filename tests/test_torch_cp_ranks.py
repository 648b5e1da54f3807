"""Rank programs of the port's data- and context-parallel tests, and the
tests that need nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
these programs in fresh processes (the ranks of one gloo group on the
CPU), which import this module and nothing of JAX. The parity tests that
hold the port against the JAX package (``test_torch_context_parallel.py``,
``test_torch_cp_ring.py``, ``test_torch_cp_training.py``) call them.
"""

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.parallel import context_parallel as cpar
from fleetx_tpu_torch.parallel.launch import spawn
from fleetx_tpu_torch.parallel.mesh import build_mesh, set_mesh

RANK_TIMEOUT = 120.0  # seconds a spawned group may take before it is killed


def run_ranks(fn, nprocs, *args):
    """``fn(*args)`` on ``nprocs`` CPU ranks of one gloo group, one intra-op
    thread each (the suite runs several files at once)."""
    return spawn(fn, nprocs, args, device="cpu", timeout=RANK_TIMEOUT,
                 threads=1)


# ------------------------------------------------------------ rank programs

def ring_program(q, k, v, do, dp, cp, causal, rate, seed, device="cpu",
                 dtype=torch.float32):
    """This rank's share of ring attention over the global ``[B, S, h, d]``
    numpy q, k, v (rows of its dp rank, its two zig-zag blocks) on
    ``device`` in ``dtype``, forward and backward with cotangent ``do``:
    ``(out, dq, dk, dv)`` of the share (fp32 numpy) and the flash launch
    counts of the run."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    mesh = build_mesh(dp, cp)
    set_mesh(mesh)
    b = q.shape[0] // dp
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)

    def share(x, grad):
        t = cpar.zigzag_slice(torch.from_numpy(x[rows]), cp, mesh.cp_rank)
        return t.to(device, dtype).requires_grad_(grad)

    ql, kl, vl = (share(x, True) for x in (q, k, v))
    before = {**fa.launches, **fa.block_launches}
    out = cpar.ring_self_attention(ql, kl, vl, causal=causal,
                                   expected_cp=cp, dropout_rate=rate,
                                   seed=seed if rate else None,
                                   batch_offset=mesh.dp_rank * b)
    out.backward(share(do, False))
    launched = {n: c - before[n] for n, c in
                {**fa.launches, **fa.block_launches}.items()}
    return tuple(t.detach().float().cpu().numpy()
                 for t in (out, ql.grad, kl.grad, vl.grad)) + (launched,)


def merge_shares(shares, dp, cp):
    """The global natural-order array from the ranks' shares (rank order
    dp_rank · cp + cp_rank)."""
    rows = [np.concatenate(shares[d * cp:(d + 1) * cp], axis=1)
            for d in range(dp)]
    z = torch.from_numpy(np.concatenate(rows, axis=0))
    return cpar.zigzag_merge(z, cp).numpy()


def ring(q, k, v, do, *, dp=1, cp=2, causal=True, rate=0.0, seed=0,
         device="cpu", dtype=torch.float32):
    """Ring attention on spawned ranks: ``(out, dq, dk, dv)`` global,
    natural order (fp32 numpy). On ``device="cuda"`` the ranks share the
    card's kernels, and a fifth item holds each rank's launch counts."""
    args = (q, k, v, do, dp, cp, causal, rate, seed, device, dtype)
    if device == "cpu":
        outs = run_ranks(ring_program, dp * cp, *args)
    else:
        outs = spawn(ring_program, dp * cp, args, device=device,
                     timeout=RANK_TIMEOUT)
    merged = tuple(merge_shares([o[i] for o in outs], dp, cp)
                   for i in range(4))
    return merged if device == "cpu" else merged + ([o[4] for o in outs],)


def train_program(config, overrides, steps, params, device="cpu"):
    """``steps`` train steps of ``Trainer`` on this rank (CPU) through the
    normal entry points (``get_config`` with the world's ranks,
    ``build_module``, ``build_dataloader``), from ``params`` (numpy state
    dict; None: the seeded init). Returns the per-step losses and grad
    norms, the first step's gradients after the world sum (numpy, by
    name), a checksum of the final parameters and the first batch's
    tokens, and the flash launch counts of the steps."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(overrides))
    module = build_module(cfg)
    trainer = Trainer(cfg, module, device=device)
    trainer.init_state(None if params is None else {
        n: torch.from_numpy(p) for n, p in params.items()})
    names = [n for n, _ in module.nets.named_parameters()]
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        if not grads:
            grads.extend(g.detach().float().cpu().numpy() for g in gs)
        return clip(gs, norm)

    trainer.clip = capture
    loader = iter(build_dataloader(cfg, "Train"))
    first, outs = None, []
    before = {**fa.launches, **fa.block_launches}
    for _ in range(steps):
        batch = next(loader)
        first = batch["tokens"] if first is None else first
        outs.append(trainer.train_step(trainer._to_device(batch)))
    checksum = float(sum(p.detach().double().sum() for p in
                         module.nets.parameters()))
    return {"losses": [float(o["loss"]) for o in outs],
            "grad_norms": [float(o["grad_norm"]) for o in outs],
            "grads": dict(zip(names, grads)), "checksum": checksum,
            "tokens": np.asarray(first),
            "launches": {n: c - before[n] for n, c in
                         {**fa.launches, **fa.block_launches}.items()}}


def _mesh_program():
    """The mesh seen from this rank, and one ring shift of its rank id."""
    mesh = build_mesh(2, 2)
    set_mesh(mesh)
    (got,) = cpar.ring_shift([torch.full((3,), float(mesh.rank))], mesh)
    return (mesh.dp_rank, mesh.cp_rank, mesh.cp_ranks, got.tolist())


# ---------------------------------------------------------------- tests

def test_mesh_lays_cp_ranks_adjacent_and_shifts_within_the_ring():
    """dp 2 x cp 2 over 4 gloo ranks: rank = dp_rank * cp + cp_rank, the
    cp rings are (0, 1) and (2, 3), and a shift brings each rank its ring
    predecessor's tensor."""
    got = run_ranks(_mesh_program, 4)
    assert [g[:3] for g in got] == [(0, 0, (0, 1)), (0, 1, (0, 1)),
                                    (1, 0, (2, 3)), (1, 1, (2, 3))]
    assert [g[3][0] for g in got] == [1.0, 0.0, 3.0, 2.0]


def test_spawn_starts_again_when_its_port_was_taken(monkeypatch):
    """A rendezvous port another process took after ``free_port`` chose it
    (EADDRINUSE) starts the ranks again on another port: the group forms
    and the program runs once."""
    import socket

    from fleetx_tpu_torch.parallel import launch

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        ports = [taken.getsockname()[1]]
        real = launch.free_port
        monkeypatch.setattr(launch, "free_port",
                            lambda: ports.pop() if ports else real())
        got = run_ranks(_mesh_program, 4)
    assert not ports  # the taken port was handed out first
    assert [g[3][0] for g in got] == [1.0, 0.0, 3.0, 2.0]


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_with_dropout_equals_single_process_attention(cp):
    """At dropout 0.2 the ring (dp 2 x cp 2, or cp 4) realizes the mask of
    the port's single-process flash attention with the same seed, keyed
    on global batch rows and positions: forward and dq, dk, dv agree
    (JAX test_cp_flash.py:98-131)."""
    from fleetx_tpu_torch.ops.flash_attention import flash_attention

    dp = 2 if cp == 2 else 1
    rng = np.random.RandomState(cp)
    b, s, h, d = 2, 2 * cp * 64, 2, 16
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))
    got = ring(q, k, v, do, dp=dp, cp=cp, rate=0.2, seed=-77)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, dropout_rate=0.2, seed=-77)
    out.backward(torch.from_numpy(do))
    want = [out.detach()] + [t.grad for t in (qt, kt, vt)]
    # JAX's limits for this comparison: the ring merges per-pair results,
    # a different summation than one softmax over all keys
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        tol = (dict(rtol=2e-4, atol=2e-5) if name == "out"
               else dict(rtol=1e-3, atol=5e-4))
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **tol)
