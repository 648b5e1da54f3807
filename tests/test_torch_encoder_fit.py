"""``Trainer.fit`` of the port's ERNIE and ViT against the JAX ``Trainer``.

The tiny configs of ``torch_encoder_configs`` (fp32, dropout 0, ViT
without mixup: the model-level draws differ by design), fed by each
package's own loader over the same data: the JAX ``Trainer`` initialises
and trains 3 steps on its Pallas kernels in interpret mode
(``FLEETX_FORCE_FLASH=1``); the port's starts from the same weights
through ``params_from_jax`` and trains 3 steps on the flash kernels'
plain versions. The per-step losses agree within 1e-5 relative, and
each final parameter leaf in L2 within 1e-5 of its norm plus 1e-4 of its
three updates' (the gradients' tolerance: AdamW's step is about lr times
the sign of the gradient, so a leaf that starts at zero, a bias, is all
update; and the summation noise of a gradient element near zero turns
into a step of a sizable share of lr, so single elements may part by
more). The throughput gauge
counts the batch's ``input_ids`` (ERNIE) and the pixels of its first
array (ViT), the module's FLOPs a sample spread over them; ViT's
``evaluate`` on its Eval split gives JAX's mean loss.
"""

import numpy as np
import pytest
import torch

import jax
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.ernie import convert as ernie_convert
from fleetx_tpu_torch.models.vision import convert as vit_convert
from fleetx_tpu_torch.utils.config import get_config
from torch_encoder_configs import ernie_yaml, vit_yaml, write_ernie_corpus


def _configs(tmp_path, family):
    out = []
    for name, loader in (("torch", get_config), ("jax", jax_get_config)):
        d = tmp_path / name
        d.mkdir(parents=True)
        if family == "ernie":
            write_ernie_corpus(str(d / "er"))
            path = ernie_yaml(d / "e.yaml", str(d / "er"), str(d / "out"))
        else:
            path = vit_yaml(d / "v.yaml", str(d / "out"))
        out.append(loader(path, nranks=1))
    return out


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_fit_matches_jax_trainer(tmp_path, monkeypatch, family):
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    tcfg, jcfg = _configs(tmp_path, family)
    jmod = jax_build_module(jcfg)
    jlosses = []
    monkeypatch.setattr(jmod, "training_step_end",
                        lambda log: jlosses.append(log["loss"]))
    jloader = jax_build_dataloader(jcfg, "Train")
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(next(iter(jloader)))
    # a copy: the train step donates the state's buffers
    params = jax.tree.map(np.array, nn.meta.unbox(jtrainer.state.params))
    jtrainer.fit(jloader)

    tmod = build_module(tcfg)
    logs = []
    tmod.training_step_end = logs.append
    conv = ernie_convert if family == "ernie" else vit_convert
    pcfg = getattr(tmod, "ernie_config", None) or tmod.vit_config
    trainer = Trainer(tcfg, tmod, device="cpu")
    # the CPU trainer trains the tensors it is given in place
    start = conv.params_from_jax({"params": params}, pcfg)
    trainer.init_state({k: v.clone() for k, v in start.items()})
    trainer.fit(build_dataloader(tcfg, "Train"))
    assert trainer.step == 3 and len(jlosses) == 3
    np.testing.assert_allclose([log["loss"] for log in logs], jlosses,
                               rtol=1e-5)
    assert logs[-1]["loss"] != logs[0]["loss"]
    final = conv.params_from_jax({"params": jax.tree.map(
        np.asarray, nn.meta.unbox(jtrainer.state.params))}, pcfg)
    got = dict(tmod.nets.named_parameters())
    for name, want in final.items():
        w, w0 = want.numpy(), start[name].numpy()
        gap = np.linalg.norm(got[name].detach().numpy() - w)
        assert gap <= (1e-5 * np.linalg.norm(w)
                       + 1e-4 * np.linalg.norm(w - w0)), (name, gap)
    moved = [n for n, w in final.items() if not torch.equal(w, start[n])]
    assert len(moved) == len(final)
    # the gauge's elements: ERNIE's ids, ViT's pixels
    b = tcfg.Global.global_batch_size
    per = 64 if family == "ernie" else 32 * 32 * 3
    assert trainer._tokens_per_batch == b * per
    flops = tmod.model_flops_per_sample(trainer.n_params)
    assert trainer._flops_per_tok == pytest.approx(flops / per)
    if family == "vit":
        loss = trainer.evaluate(build_dataloader(tcfg, "Eval"))
        want = jtrainer.evaluate(jax_build_dataloader(jcfg, "Eval"))
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        assert 0.0 <= trainer.eval_metrics["acc"] <= 1.0
