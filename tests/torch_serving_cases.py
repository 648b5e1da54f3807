"""Shared cases of the port's serving parity files.

The tiny GPT (``test_torch_gpt.TINY``) in fp32, its weights drawn with
seed 6 (their greedy streams vary from token to token), bridged to the port
with ``params_from_jax``; both packages' engines are built with the same
switches, and the helpers serve one list of requests through either.
"""

import contextlib
import os

import numpy as np
import torch

from fleetx_tpu.models.gpt.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from fleetx_tpu.serving import ServingEngine as JaxServingEngine
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.serving import ServingEngine
from test_torch_gpt import TINY, tiny_jax_model, tiny_params
from test_torch_mesh_ranks import MESH_CFG, mesh_cfg

NO_EOS = 10**6
ENGINE = dict(slots=3, cache_len=48, page_size=8, prefill_bucket=4)
GREEDY = dict(decode_strategy="greedy", eos_token_id=NO_EOS)


def weights():
    """``(flax tree, port cfg, port state dict)``."""
    tree = tiny_params(seed=6)
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    return tree, cfg, params_from_jax(tree, cfg)


def engine_kw(**kw):
    """The shared engine switches with ``kw`` on top (no ``page_size``
    on the slot path)."""
    out = dict(ENGINE, **kw)
    if not out.get("paged", True):
        out.pop("page_size")
    return out


def port_engine(w, **kw):
    """A port engine on the CPU over the weights ``w``."""
    _, cfg, params = w
    gen_cfg = kw.pop("gen_cfg", GenerationConfig(**GREEDY))
    return ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                         device="cpu", gen_cfg=gen_cfg, **engine_kw(**kw))


@contextlib.contextmanager
def forced_flash(on: bool):
    """``FLEETX_FORCE_FLASH=1`` while the JAX int8 engine runs (its
    Pallas kernels in interpret mode, as the port's decode takes its
    kernels' plain versions)."""
    old = os.environ.get("FLEETX_FORCE_FLASH")
    if on:
        os.environ["FLEETX_FORCE_FLASH"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FLEETX_FORCE_FLASH", None)
        else:
            os.environ["FLEETX_FORCE_FLASH"] = old


def jax_engine(w, **kw):
    """The JAX engine with the same switches (flash on at int8 KV)."""
    tree = w[0]
    int8 = kw.get("kv_dtype") == "int8"
    gen_cfg = kw.pop("gen_cfg", JaxGenerationConfig(**GREEDY))
    kw.setdefault("paged", True)
    return JaxServingEngine(tiny_jax_model(use_flash=int8), tree,
                            gen_cfg=gen_cfg, **engine_kw(**kw))


def serve(engine, prompts, max_length=8, **submit):
    """Submit every prompt, drain, and return the results in order."""
    rids = [engine.submit(p, max_length=max_length, **submit)
            for p in prompts]
    with forced_flash(getattr(engine, "kv_dtype", None) == "int8"
                      and not isinstance(engine, ServingEngine)):
        res = engine.drain()
    return [res[r] for r in rids]


def tokens(results):
    return [r.tokens.tolist() for r in results]


def prompts(seed=7, lengths=(19, 4, 23, 9)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab_size"], n).astype(np.int32)
            for n in lengths]


def mesh_jax_model(use_flash=False):
    """The JAX model of ``tests/test_mesh_serving.py``'s config."""
    from fleetx_tpu.models.gpt.model import GPTConfig as JaxGPTConfig
    from fleetx_tpu.models.gpt.model import GPTForPretraining as JaxGPT
    import jax.numpy as jnp

    return JaxGPT(JaxGPTConfig(**MESH_CFG, dtype=jnp.float32,
                               use_flash_attention=use_flash))


def mesh_weights(seed=6, std=0.3):
    """``(flax tree, port cfg, port state dict)`` of the mesh config, the
    tree drawn as ``tiny_params`` draws it."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    shapes = jax.eval_shape(lambda: nn.meta.unbox(mesh_jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        noise = rng.normal(0.0, std, s.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return 1.0 + 0.1 * noise if name.endswith("['scale']") else noise

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    cfg = mesh_cfg()
    return tree, cfg, params_from_jax(tree, cfg)
