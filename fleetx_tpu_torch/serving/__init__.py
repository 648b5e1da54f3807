"""Continuous-batching serving for GPT (the port's serving path): the paged
and slot caches, chunked prefill, speculative decoding and admission
limits."""

from fleetx_tpu_torch.serving.cache_manager import (
    PagedKVCacheManager,
    PagePool,
    SlotKVCacheManager,
)
from fleetx_tpu_torch.serving.engine import (
    QueueFull,
    ServingEngine,
    ServingResult,
    filter_logits,
    sample_tokens,
)
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import GPTExecutor, ModelCapabilities
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.serving.spec import (
    DraftModelProposer,
    NgramProposer,
    Proposer,
)

__all__ = ["QueueFull", "ServingEngine", "ServingResult", "GPTExecutor",
           "ModelCapabilities", "PagePool", "PagedKVCacheManager",
           "SlotKVCacheManager", "FIFOScheduler", "Request",
           "DraftModelProposer", "NgramProposer", "Proposer",
           "ServingMetrics", "filter_logits", "sample_tokens"]
