"""The router-facing surface of the port's serving engine against the JAX
package: ``engine_conforms`` (the port's and JAX's checks), ``submit_limit``,
the ``health()`` report moving ok → draining → dead, ``declare_dead``,
``emitted_tokens`` and the one-shot ``generate_batch``.
"""

import importlib

import numpy as np
import pytest

from fleetx_tpu.models.gpt.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from fleetx_tpu.serving.model_protocol import (
    engine_conforms as jax_engine_conforms,
)
from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
from fleetx_tpu_torch.serving import ENGINE_SURFACE, engine_conforms
from torch_serving_cases import jax_engine, port_engine, prompts, weights

jax_protocol = importlib.import_module("fleetx_tpu.serving.model_protocol")


@pytest.fixture(scope="module")
def w():
    return weights()


@pytest.fixture(scope="module")
def engines(w):
    return port_engine(w), jax_engine(w)


def test_engine_conforms_to_both_packages_contracts(engines):
    ours, _ = engines
    assert ENGINE_SURFACE == jax_protocol.ENGINE_SURFACE
    assert engine_conforms(ours) is None
    assert jax_engine_conforms(ours) is None

    class Half:
        submit = step = take_result = result = cancel = staticmethod(len)

    assert engine_conforms(Half()) == jax_engine_conforms(Half()) \
        == "emitted_tokens"


@pytest.mark.parametrize("kw", [{}, dict(paged=False), dict(cache_len=24)],
                         ids=["paged", "slot", "short"])
def test_submit_limit_equals_jax(w, kw):
    assert port_engine(w, **kw).submit_limit == jax_engine(w, **kw)\
        .submit_limit


def test_health_moves_like_jax(w):
    """ok with load, draining after a shutdown request, dead after
    ``declare_dead``: the same report as JAX's engine at each stage."""
    ours, theirs = port_engine(w), jax_engine(w)
    for eng in (ours, theirs):
        for p in prompts():
            eng.submit(p, max_length=8)
        eng.step()
    assert ours.health() == theirs.health()
    assert ours.health()["state"] == "ok"
    for eng in (ours, theirs):
        eng.request_shutdown(grace_s=60.0)
    assert ours.health() == theirs.health()
    assert ours.health()["state"] == "draining"
    for eng in (ours, theirs):
        eng.declare_dead()
    assert ours.health() == theirs.health()
    assert ours.health()["state"] == "dead"


def test_emitted_tokens_track_live_requests(engines):
    ours, theirs = engines
    rids = {}
    for eng in (ours, theirs):
        rids[eng] = [eng.submit(p, max_length=8) for p in prompts()]
        eng.step()
        eng.step()
    for i in range(len(prompts())):
        assert (ours.emitted_tokens(rids[ours][i])
                == theirs.emitted_tokens(rids[theirs][i]))
    assert ours.emitted_tokens(12345) is None
    res = ours.drain()
    theirs.drain()
    assert ours.emitted_tokens(rids[ours][0]) is None  # finished
    assert len(res) == len(prompts())


def test_generate_batch_matches_jax(w, engines):
    ours, theirs = engines
    ids = np.stack([p[:4] for p in prompts()])
    want = np.asarray(theirs.generate_batch(
        ids, JaxGenerationConfig(decode_strategy="greedy", max_length=6,
                                 eos_token_id=10**6, pad_token_id=60)))
    got = ours.generate_batch(ids, GenerationConfig(
        decode_strategy="greedy", max_length=6, eos_token_id=10**6,
        pad_token_id=60))
    assert got.dtype.is_floating_point is False
    assert (got.numpy() == want).all()
    with pytest.raises(ValueError, match="decode limit"):
        ours.generate_batch(ids, GenerationConfig(max_length=60))
