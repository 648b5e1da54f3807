"""The serving contracts: what a model must provide to be served, and what
an engine must provide to be routed.

Port of ``ModelCapabilities``, ``GPTExecutor``, ``ENGINE_SURFACE`` and
``engine_conforms`` from the JAX package's ``serving/model_protocol.py``.
``ServingEngine`` consumes only the executor for model compute — the
cached forward that serves prefill, chunks, the decode tick and the
speculative verify, per-row sampling and the shared sampling filter — and
the capability flags say which engine features the model may ride. The
engine side is the surface a router drives: :data:`ENGINE_SURFACE`'s
methods and the attributes :func:`engine_conforms` checks; ``health()``
reports the capabilities as a dict. Three engine kinds implement it: the
autoregressive ``ServingEngine`` (GPT), and the KV-free
``ErnieScoringEngine`` and ``EmbeddingEngine`` (``batch_engine``), whose
capabilities say ``has_kv_cache=False`` and ``cache_layout="none"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ENGINE_SURFACE", "GPTExecutor", "ModelCapabilities",
           "engine_conforms"]


@dataclasses.dataclass(frozen=True)
class ModelCapabilities:
    """What engine features a served model family can legally ride."""

    #: model family name, the router's grouping key ("gpt" | "ernie" |
    #: "vit" ...)
    family: str
    #: the model decodes autoregressively against a KV cache; False: the
    #: engine holds no cache and each request is one forward
    has_kv_cache: bool
    #: draft-and-verify speculative decoding is legal
    supports_spec: bool
    #: the cache layouts the engine may build ("slot+paged" | "none")
    cache_layout: str
    #: hard per-request input bound (tokens for text, flat elements for
    #: an image)
    max_input: int
    #: what the int32 output channel carries: "tokens" (token or class
    #: ids) or "floats" (a float32 vector bit-cast, the embedding wire);
    #: ``/v1/embeddings`` serves the "floats" families
    emits: str = "tokens"

    def as_dict(self) -> dict:
        """JSON-ready form for the ``health()`` report."""
        return dataclasses.asdict(self)


class GPTExecutor:
    """The GPT decode path behind the protocol: the model's cached forward
    (``generation.decode_step``), its decode cache, and the engine's shared
    sampler and sampling filter. With a ``mesh`` (mp serving) every
    forward runs under it and returns the whole vocab's logits, this
    rank's shard all-gathered over the mp group
    (``model.serving_logits``)."""

    def __init__(self, model, family: str = "gpt", mesh=None):
        self.model = model
        self.mesh = mesh
        self.capabilities = ModelCapabilities(
            family=family,
            has_kv_cache=True,
            supports_spec=True,
            cache_layout="slot+paged",
            max_input=int(model.cfg.max_position_embeddings),
        )

    def init_cache(self, batch: int, device=None):
        """A zeroed contiguous decode cache of ``batch`` rows (the slot
        path's batch-1 prefill cache; this rank's heads under mp)."""
        from fleetx_tpu_torch.models.gpt.generation import init_decode_cache

        return init_decode_cache(self.model, batch, device=device)

    def forward(self, cache, ids, positions, *, cache_positions=None,
                block_tables=None):
        """One cached forward: ``(logits, cache)``, the cache updated in
        place. ``cache_positions`` are per-row write offsets (None: at the
        contiguous cache's ``index``), ``block_tables`` the paged
        indirection (None on the slot path)."""
        from fleetx_tpu_torch.models.gpt.generation import decode_step
        from fleetx_tpu_torch.models.gpt.model import serving_logits

        with self.mesh_context():
            logits, cache = decode_step(self.model, cache, ids, positions,
                                        cache_positions=cache_positions,
                                        block_tables=block_tables)
            return serving_logits(self.model, logits), cache

    def mesh_context(self):
        """The mesh current for a device call (a no-op without one)."""
        import contextlib

        from fleetx_tpu_torch.parallel.mesh import use_mesh

        return (use_mesh(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def sample(self, logits, generators, greedy, temperature, top_k, top_p,
               *, topk_cap: int):
        from fleetx_tpu_torch.serving.engine import sample_tokens

        return sample_tokens(logits, generators, greedy, temperature, top_k,
                             top_p, topk_cap=topk_cap)

    def filter(self, logits, temperature, top_k, top_p, *, topk_cap: int):
        """The sampling filter alone (the speculative verify needs the
        filtered distribution, not a draw)."""
        from fleetx_tpu_torch.serving.engine import filter_logits

        return filter_logits(logits, temperature, top_k, top_p,
                             topk_cap=topk_cap)


#: The engine-side contract: the methods a router calls. Attributes
#: (:data:`_ENGINE_ATTRS`): ``role`` ("prefill" | "decode" | "both"),
#: ``paged``, ``page_size``, ``cache_len``, ``slots``, ``model`` (with
#: ``.cfg``), ``metrics``, ``capabilities``, ``model_family`` and
#: ``submit_limit`` (the smallest refused prompt length). ``health()``
#: returns ``state`` ok | draining | dead, ``role``, ``model``,
#: ``capabilities``, ``queue_depth``, ``queue_tokens``, ``active`` and
#: ``slots``.
ENGINE_SURFACE = (
    "submit", "step", "take_result", "result", "cancel", "emitted_tokens",
    "health", "drain", "shutdown", "request_shutdown", "declare_dead",
)

_ENGINE_ATTRS = ("role", "paged", "page_size", "cache_len", "slots",
                 "model", "metrics", "capabilities", "model_family",
                 "submit_limit")


def engine_conforms(engine, *, require_attrs: bool = True
                    ) -> Optional[str]:
    """None when ``engine`` exposes the whole router-facing contract (its
    methods, then, with ``require_attrs``, its attributes), else the name
    of the first missing member."""
    for name in ENGINE_SURFACE:
        if not callable(getattr(engine, name, None)):
            return name
    if require_attrs:
        for name in _ENGINE_ATTRS:
            if not hasattr(engine, name):
                return name
    return None
