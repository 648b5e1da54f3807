"""Megatron sequence parallelism in the port, held against the port
without it, and the tests that need nothing but the port.

JAX-free on purpose: the rank programs come from ``test_torch_mp_ranks``
and run in spawned gloo processes. ``test_torch_sp_training.py`` holds
mp 2 × SP against the JAX ``Trainer``. Here, on the tiny config in fp32:

- mp 2 with and without ``sequence_parallel`` at dropout 0.1, fused CE
  and ``core_attn`` recompute: the first step's loss bit-equal (the hash
  masks are keyed on the global index, so the shards draw the slices of
  the unsplit masks), the losses within 1e-6 and every gathered gradient
  within 1e-6 (only the collectives' summation order differs), the
  mp-replicated parameters bit-equal on both ranks;
- pp 2 × mp 2 × SP on 4 ranks against mp 2 × SP on 2 (a stage hands on
  each mp rank's sequence shard);
- a hidden dropout's mask on a sequence shard equal to the slice of the
  unsplit mask, for the hash and for flax's threefry;
- a sequence that mp does not divide, and SP under cp, raise.
"""

import re

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.models.gpt.convert import gather_stages
from fleetx_tpu_torch.models.gpt.model import (
    GPTConfig,
    GPTForPretraining,
    sequence_shard,
)
from fleetx_tpu_torch.ops.dropout import FlaxDropout, HashDropout, Shard
from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import (
    TINY,
    check_replicas,
    gathered_grads,
    mp_train_program,
    overrides,
)

MP2 = ("Distributed.mp_degree=2", "Global.local_batch_size=2",
       "Global.micro_batch_size=1", "Engine.logging_freq=1")


@pytest.fixture(autouse=True)
def single_rank_mesh():
    set_mesh(None)
    yield
    set_mesh(None)


def test_sp_on_and_off_agree_at_mp2(tmp_path):
    """mp 2 with SP against mp 2 without, from one seeded init, at
    dropout 0.1 with fused CE and ``core_attn`` recompute over 2
    microbatches: the first loss bit-equal, the second step's within
    1e-6, every first-step gradient within 1e-6, the replicated
    parameters equal on both ranks after each run."""
    extra = MP2 + ("Model.hidden_dropout_prob=0.1",
                   "Model.attention_probs_dropout_prob=0.1",
                   "Model.fused_ce=True", "Model.use_recompute=True",
                   "Model.recompute_granularity=core_attn")
    runs = {}
    for sp in (False, True):
        over = overrides(tmp_path, "torch", *extra,
                         f"Model.sequence_parallel={sp}")
        runs[sp] = run_ranks(mp_train_program, 2, TINY, over, 2, None)
        check_replicas(runs[sp], 2)
    on, off = runs[True], runs[False]
    assert on[0]["losses"][0] == off[0]["losses"][0]
    np.testing.assert_allclose(on[0]["losses"], off[0]["losses"], rtol=0,
                               atol=1e-6)
    gcfg = GPTConfig(**_tiny(mp_degree=2))
    got, want = gathered_grads(on, gcfg), gathered_grads(off, gcfg)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-6, err_msg=n)


def test_pp2_mp2_sp_matches_mp2_sp(tmp_path):
    """pp 2 × mp 2 × SP (4 ranks; the stages exchange [mb, s/2, h]
    shards) against mp 2 × SP (2 ranks) accumulating the same 2
    microbatches at dropout 0: the losses within 1e-6 and every gradient
    of mp rank 0 joined over the stages within 1e-6."""
    extra = MP2 + ("Model.sequence_parallel=True",)
    flat = run_ranks(mp_train_program, 2, TINY,
                     overrides(tmp_path, "torch", *extra), 2, None)
    piped = run_ranks(mp_train_program, 4, TINY,
                      overrides(tmp_path, "torch", *extra,
                                "Distributed.pp_degree=2"), 2, None)
    np.testing.assert_allclose(piped[0]["losses"], flat[0]["losses"],
                               rtol=0, atol=1e-6)
    for mp_rank in (0, 1):
        joined = gather_stages([piped[mp_rank]["grads"],
                                piped[2 + mp_rank]["grads"]])
        want = flat[mp_rank]["grads"]
        assert joined.keys() == want.keys()
        for n, w in want.items():
            np.testing.assert_allclose(joined[n], w, rtol=0, atol=1e-6,
                                       err_msg=f"mp {mp_rank} {n}")


def _tiny(**kw):
    return dict(vocab_size=128, hidden_size=64, num_layers=2,
                num_attention_heads=4, ffn_hidden_size=128,
                max_position_embeddings=64, dtype=torch.float32, **kw)


@pytest.mark.parametrize("module,seed", [(HashDropout(0.3), 77),
                                         (FlaxDropout(0.3), (5, 9))],
                         ids=["hash", "threefry"])
def test_sequence_shards_draw_slices_of_the_unsplit_mask(module, seed):
    """A hidden dropout on rank r's [b, s/mp, E] shard, placed by
    ``sequence_shard``, gives the rows of the unsplit activation's mask
    at positions r·s/mp ... (r + 1)·s/mp, under dp rows as well."""
    x = torch.ones(4, 16, 8)
    whole = Shard(b0=2, batch=8, s0=0, seq=16)
    full = module(x, False, seed=seed, shard=whole)
    for mp in (2, 4):
        s_loc = 16 // mp
        for r in range(mp):
            part = module(x[:, r * s_loc:(r + 1) * s_loc], False, seed=seed,
                          shard=sequence_shard(whole, 4, s_loc, mp, r))
            assert torch.equal(part, full[:, r * s_loc:(r + 1) * s_loc])


def test_sequence_parallel_refuses_what_it_does_not_split():
    """A sequence that mp does not divide raises ``ValueError`` before any
    collective; SP under cp raises naming its ROADMAP item."""
    model = GPTForPretraining(GPTConfig(**_tiny(
        mp_degree=2, sequence_parallel=True)), device="meta")
    ids = torch.zeros(1, 33, dtype=torch.long)
    with pytest.raises(ValueError, match="does not split over mp_degree 2"):
        model.gpt.embed(ids, None)
    with pytest.raises(NotImplementedError, match=re.escape(
            'ROADMAP Queue A, "Sequence parallel under cp"')):
        GPTConfig(**_tiny(mp_degree=2, cp_degree=2, sequence_parallel=True))
