"""A pipeline's checkpoint: resumed bit for bit, refused at another layout,
and decoded from its stage files; and the stages' transport (JAX-free;
the rank programs are in ``test_torch_pp_ranks.py``).

The tiny config cut into 4 layers, 2 microbatches of 2 rows, dropout 0.1,
at pp 2 on two gloo ranks; the checkpoint holds one state file per stage
(``state-pp<p>-mp<r>.pt``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_pp_ranks import (
    PP_OVER,
    joined,
    pp_fit_program,
    transport_program,
)


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_pp2_resume_is_bit_identical_and_refused_at_another_layout(
        tmp_path):
    """An uninterrupted pp 2 run of 2 steps saving per-stage files at steps
    1 and 2; fresh processes resume a copy of step 1 alone and take step
    2: on both ranks the step-2 loss, grad norm and every parameter, AdamW
    tensor and the generator equal the uninterrupted run's bit for bit,
    and the tied embedding's copies are equal. A load of that step at pp 1
    or at virtual pp 2 raises ``ElasticMeshMismatch`` and quarantines
    nothing. Decoding from the stage files gives the greedy tokens of
    the joined stages' weights."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    base = overrides(tmp_path, "torch", *PP_OVER, "Engine.max_steps=2",
                     "Engine.logging_freq=1", "Engine.save_load.save_steps=1")
    pp = ["Distributed.pp_degree=2"]
    a = run_ranks(pp_fit_program, 2, TINY,
                  base + pp + [f"Engine.save_load.output_dir={whole}"])
    shutil.copytree(whole / "checkpoints" / "1", part / "checkpoints" / "1")
    files = sorted(os.listdir(part / "checkpoints" / "1"))
    assert files == ["meta.json", "state-pp0-mp0.pt", "state-pp1-mp0.pt"]
    out = [f"Engine.save_load.output_dir={part}"]
    b = run_ranks(pp_fit_program, 2, TINY, base + pp + out, 1)
    for x, y in zip(a, b):
        assert y["losses"] == x["losses"][1:]
        assert y["grad_norms"] == x["grad_norms"][1:]
        assert (y["step"], y["consumed"]) == (x["step"], x["consumed"]) == \
            (2, 8)
        assert y["digests"] == x["digests"]
    assert a[0]["losses"] == a[1]["losses"]
    np.testing.assert_array_equal(a[0]["params"]["gpt.word_embeddings"],
                                  a[1]["params"]["gpt.word_embeddings"])
    refused = run_ranks(pp_fit_program, 2, TINY,
                        base + pp + out + ["Model.virtual_pp_degree=2"])
    assert all("virtual_pp 1" in r["refused"] for r in refused)
    single = pp_fit_program(TINY, base + out)
    assert "pp 2->1" in single["refused"]
    assert sorted(os.listdir(part / "checkpoints")) == ["1", "2"]
    assert not (part / "quarantine").exists()

    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    gen = ["Model.module=GPTGenerationModule",
           "Generation.decode_strategy=greedy", "Generation.max_dec_len=6",
           "Generation.eos_token_id=1000", "Generation.pad_token_id=0"]
    ids = np.random.RandomState(2).randint(0, 128, (2, 5)).astype(np.int32)
    outs = []
    for state in (str(whole / "checkpoints" / "2"),
                  {n: torch.from_numpy(p) for n, p in
                   joined(a, "params").items()}):
        module = build_module(get_config(TINY, overrides=base + gen,
                                         nranks=1))
        module.set_state(state, device="cpu")
        outs.append(module.generate_ids(ids))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 11)


def test_transport_moves_every_bit_in_order_both_ways():
    """Over a pp 2 gloo group on the CPU: three tensors each way, sent back
    to back before the other side receives, arrive whole and in order."""
    (sent0, got0, on0), (sent1, got1, on1) = run_ranks(transport_program, 2)
    assert got1 == sent0 and got0 == sent1 and on0 and on1
