"""GPTGenerationModule: the one-shot generation entry.

Port of the JAX package's ``models/language_module_generation.py``
(reference ``language_module.py:484-585``): a ``GPTModule`` whose
``Generation`` config section drives :func:`generation.generate` through
:meth:`GPTGenerationModule.generate_ids`. ``generate(text)`` — tokenize,
decode, detokenize — waits for the GPT-2 BPE files (``vocab.json``,
``merges.txt``), which the repository does not hold; ids in, ids out is
the entry until then. Decoding runs the whole model: a pipeline-trained
model's weights are mapped back to it (JAX :40-42), from a JAX
pipeline-layout tree or from a checkpoint's stage files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.convert import (
    params_from_checkpoint,
    params_from_jax,
)
from fleetx_tpu_torch.models.gpt.generation import GenerationConfig, generate
from fleetx_tpu_torch.models.gpt.model import (
    inference_params,
    refuse_moe_serving,
)
from fleetx_tpu_torch.models.language_module import GPTModule
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["GPTGenerationModule"]


class GPTGenerationModule(GPTModule):
    """Decode entry over ``GPTForPretraining`` (JAX
    ``GPTGenerationModule``): ``set_state`` installs weights on a device,
    ``generate_ids`` runs the configured strategy."""

    pipelined = False  # decoding runs the whole model, on one rank

    def __init__(self, cfg):
        super().__init__(cfg)
        refuse_moe_serving(self.gpt_config)
        self.generation_cfg = GenerationConfig.from_config(
            cfg.get("Generation"))
        self.device: Optional[torch.device] = None

    def set_state(self, params: Union[Dict[str, torch.Tensor], dict, str],
                  device=None) -> None:
        """Load the whole model's weights onto ``device`` — CUDA unless the
        caller names another; without CUDA it raises — with the dense
        weights at the compute dtype. ``params`` is a state dict
        (``init_params`` / ``params_from_jax``), a flax param tree of
        numpy arrays in the sequential or a pipeline layout (JAX
        ``set_state`` :40-42), or a ``Trainer`` checkpoint's step
        directory written under any pp and mp."""
        if isinstance(params, (str, os.PathLike)):
            params = params_from_checkpoint(params, self.gpt_config)
        elif "params" in params or "gpt" in params:
            params = params_from_jax(params, self.gpt_config)
        self.device = resolve_device(device)
        self.nets.load_state_dict(
            inference_params(self.nets, params, self.device), assign=True)
        self.nets.eval()

    def generate_ids(self, input_ids, attention_mask=None,
                     generator: Optional[torch.Generator] = None
                     ) -> np.ndarray:
        """``[b, prompt_len + max_dec_len]`` int32 tokens for the prompt
        ids ``[b, prompt_len]`` (``attention_mask`` 0 marks a left pad);
        ``generator`` (on the module's device) seeds the sampling draws,
        default seed 0."""
        if self.device is None:
            raise RuntimeError("call set_state(params) first")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64)
        mask = (None if attention_mask is None else torch.as_tensor(
            np.asarray(attention_mask), dtype=torch.int32))
        out = generate(self.nets, ids, self.generation_cfg,
                       attention_mask=mask, generator=generator)
        return out.cpu().numpy()
