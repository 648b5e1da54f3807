"""ERNIE and ViT training over two gloo data ranks, held against one rank.

JAX-free on purpose: the rank programs run in processes that import this
module and nothing of JAX (:func:`fleetx_tpu_torch.parallel.launch.spawn`).
On the tiny configs of ``torch_encoder_configs`` at fp32 with every draw
on (ERNIE: hidden and attention dropout 0.1; ViT: dropout and attention
dropout 0.1, drop path 0.5, mixup 0.8), one ``Trainer.fit`` step at dp 2
(each rank loading its half of the global batch; the ZeRO weight-update
shard on, as it is by default over a data axis) equals the step at dp 1:
the loss and its terms (ERNIE's ``lm_loss``/``sop_loss``, ViT's ``acc``)
and the grad norm within 1e-5 relative, and every parameter leaf after
the step in L2 within 1e-5 of its norm plus 1e-4 of its update's. That
holds only because every draw is global: the hash dropouts key on the
global element index and row, drop path's flags are drawn over the global
batch, mixup rolls the global micro-batch and draws one λ, and ERNIE's
MLM loss divides by the global weight sum. An encoder module at an mp,
pp, cp or sharding degree above 1 refuses by name.
"""

import re

import numpy as np
import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from torch_encoder_configs import ernie_yaml, vit_yaml, write_ernie_corpus

DRAWS = {"ernie": ("Model.hidden_dropout_prob=0.1",
                   "Model.attention_probs_dropout_prob=0.1"),
         "vit": ("Model.drop_rate=0.1", "Model.attn_drop_rate=0.1",
                 "Model.drop_path_rate=0.5", "Model.mixup_alpha=0.8")}
TERMS = {"ernie": ("lm_loss", "sop_loss"), "vit": ("acc",)}
BATCH = 8


def _path(tmp_path, family):
    if family == "ernie":
        write_ernie_corpus(str(tmp_path / "er"))
        return ernie_yaml(tmp_path / "e.yaml", str(tmp_path / "er"),
                          str(tmp_path / "out"))
    return vit_yaml(tmp_path / "v.yaml", str(tmp_path / "out"))


def fit_one_step(path, over, family, device="cpu"):
    """One ``Trainer.fit`` step of the config at ``path``: the step's
    loss, terms and grad norm, and the parameters before and after."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(path, overrides=list(over) + ["Engine.max_steps=1"])
    trainer = Trainer(cfg, build_module(cfg), device=device)
    trainer.init_state()
    before = {n: p.detach().numpy().copy()
              for n, p in trainer.module.nets.named_parameters()}
    trainer.fit(build_dataloader(cfg, "Train"))
    out = trainer.history[0]
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "terms": {k: float(out[k]) for k in TERMS[family]},
            "before": before, "zero": trainer.zero is not None,
            "after": {n: p.detach().numpy().copy()
                      for n, p in trainer.module.nets.named_parameters()}}


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_dp2_step_equals_one_rank_with_every_draw_on(tmp_path, family):
    path = _path(tmp_path, family)
    over = list(DRAWS[family])
    dp2 = over + ["Distributed.dp_degree=2",
                  f"Global.local_batch_size={BATCH // 2}",
                  f"Global.micro_batch_size={BATCH // 2}"]
    ranks = run_ranks(fit_one_step, 2, path, dp2, family)
    set_mesh(None)
    one = fit_one_step(path, over + [f"Global.local_batch_size={BATCH}",
                                     f"Global.micro_batch_size={BATCH}"],
                       family)
    for r in ranks:
        assert r["zero"]  # the update shard ran
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[k], one[k], rtol=1e-5, err_msg=k)
        for k, v in one["terms"].items():
            np.testing.assert_allclose(r["terms"][k], v, rtol=1e-5,
                                       err_msg=k)
        for n, w in one["after"].items():
            np.testing.assert_array_equal(r["before"][n], one["before"][n])
            gap = np.linalg.norm(r["after"][n] - w)
            assert gap <= (1e-5 * np.linalg.norm(w) + 1e-4 * np.linalg.norm(
                w - one["before"][n])), (n, gap)
    for n in one["after"]:  # the replicas stay equal bit for bit
        np.testing.assert_array_equal(ranks[0]["after"][n],
                                      ranks[1]["after"][n])


def test_one_rank_with_the_draws_is_not_the_plain_step(tmp_path):
    """The gate above has teeth: at dp 1 the ViT step with its draws on
    and the step without them part."""
    path = _path(tmp_path, "vit")
    drawn = fit_one_step(path, DRAWS["vit"], "vit")
    plain = fit_one_step(path, (), "vit")
    assert abs(drawn["loss"] - plain["loss"]) > 1e-3


TITLE = re.escape('ROADMAP Queue A, "Encoders under mp, pp, cp or ZeRO"')


@pytest.mark.parametrize("family", ["ernie", "vit"])
@pytest.mark.parametrize("key", ["Distributed.mp_degree",
                                 "Distributed.pp_degree",
                                 "Distributed.cp_degree",
                                 "Distributed.sharding.sharding_degree"])
def test_encoders_refuse_mp_pp_cp_and_zero_by_title(tmp_path, family, key):
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(_path(tmp_path, family), overrides=[f"{key}=2"],
                     nranks=2)
    with pytest.raises(NotImplementedError, match=TITLE):
        build_module(cfg)


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_train_cli_trains_the_encoders(tmp_path, monkeypatch, family):
    """``tools/train.py`` on the tiny ERNIE and ViT configs (the trainer
    put on the CPU): 4 steps, the ViT evaluating every 2 on its Eval
    split, the log lines counting tokens for ERNIE and images for ViT."""
    import functools

    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.tools import train as cli
    from fleetx_tpu_torch.utils.log import logger

    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, device="cpu"))
    lines = []
    monkeypatch.setattr(logger, "train",
                        lambda msg, *a: lines.append(msg % a))
    evals = []
    monkeypatch.setattr(logger, "eval", lambda msg, *a: evals.append(msg % a))
    extra = (["-o", "Engine.eval_freq=2"] if family == "vit" else [])
    trainer = cli.main(["-c", _path(tmp_path, family), "-o",
                        "Engine.max_steps=4", *extra])
    assert trainer.step == 4 and len(lines) == 4
    unit = "tokens/s" if family == "ernie" else "images/s"
    assert all(unit in line for line in lines)
    assert len(evals) == (2 if family == "vit" else 0)
    assert all("acc:" in line for line in evals)
