"""The model-side serving contract: what a model must provide to be served.

Port of ``ModelCapabilities`` and ``GPTExecutor`` from the JAX package's
``serving/model_protocol.py``. ``ServingEngine`` consumes only the
executor for model compute — the cached forward that serves prefill,
chunks, the decode tick and the speculative verify, per-row sampling and
the shared sampling filter — and the capability flags say which engine
features the model may ride.
"""

from __future__ import annotations

import dataclasses

__all__ = ["GPTExecutor", "ModelCapabilities"]


@dataclasses.dataclass(frozen=True)
class ModelCapabilities:
    """What engine features a served model family can legally ride."""

    #: model family name ("gpt" | ...)
    family: str
    #: the model decodes autoregressively against a KV cache
    has_kv_cache: bool
    #: draft-and-verify speculative decoding is legal
    supports_spec: bool
    #: the cache layouts the engine may build
    cache_layout: str
    #: hard per-request input bound in tokens
    max_input: int
    #: what the int32 output channel carries
    emits: str = "tokens"


class GPTExecutor:
    """The GPT decode path behind the protocol: the model's cached forward
    (``generation.decode_step``), its decode cache, and the engine's shared
    sampler and sampling filter."""

    def __init__(self, model, family: str = "gpt"):
        self.model = model
        self.capabilities = ModelCapabilities(
            family=family,
            has_kv_cache=True,
            supports_spec=True,
            cache_layout="slot+paged",
            max_input=int(model.cfg.max_position_embeddings),
        )

    def init_cache(self, batch: int, device=None):
        """A zeroed contiguous decode cache of ``batch`` rows (the slot
        path's batch-1 prefill cache)."""
        from fleetx_tpu_torch.models.gpt.generation import init_decode_cache

        return init_decode_cache(self.model, batch, device=device)

    def forward(self, cache, ids, positions, *, cache_positions=None,
                block_tables=None):
        """One cached forward: ``(logits, cache)``, the cache updated in
        place. ``cache_positions`` are per-row write offsets (None: at the
        contiguous cache's ``index``), ``block_tables`` the paged
        indirection (None on the slot path)."""
        from fleetx_tpu_torch.models.gpt.generation import decode_step

        return decode_step(self.model, cache, ids, positions,
                           cache_positions=cache_positions,
                           block_tables=block_tables)

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
