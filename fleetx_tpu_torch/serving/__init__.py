"""Continuous-batching serving for GPT (the port's serving path): the paged
and slot caches with the host and disk page tiers, chunked prefill,
speculative decoding, prefill/decode roles with KV shipping, crash
recovery and admission limits; and the fleet layer over it: the
multi-replica ``router`` (per-tenant QoS lanes, health-based failover,
zero-token-loss migration), the ``autoscaler``, the seeded ``workload``
traces with the SLO goodput scorer, and ``api`` (the replica RPC and the
OpenAI-compatible front door); and the KV-free engines of the encoder
families beside it: ``ErnieScoringEngine`` (ERNIE fill-in-blank and
scoring) and ``EmbeddingEngine`` (ViT embeddings and classes) over the
dynamic-batching ``BatchingEngine``, with the embedding wire's
``encode_floats``/``decode_floats``."""

from fleetx_tpu_torch.serving.autoscaler import FleetAutoscaler
from fleetx_tpu_torch.serving.batch_engine import BatchingEngine

from fleetx_tpu_torch.serving.cache_manager import (
    DiskPageStore,
    HostPageStore,
    PagedKVCacheManager,
    PagePool,
    SlotKVCacheManager,
    TieredPageStore,
)
from fleetx_tpu_torch.serving.embedding_engine import (
    EmbeddingEngine,
    decode_floats,
    encode_floats,
)
from fleetx_tpu_torch.serving.engine import (
    QueueFull,
    RecoveryExhausted,
    ServingEngine,
    ServingResult,
    ShuttingDown,
    TickTimeout,
    filter_logits,
    sample_tokens,
)
from fleetx_tpu_torch.serving.ernie_engine import ErnieScoringEngine
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import (
    ENGINE_SURFACE,
    GPTExecutor,
    ModelCapabilities,
    engine_conforms,
)
from fleetx_tpu_torch.serving.router import (
    ReplicaState,
    RouterMetrics,
    ServingRouter,
    TenantPolicy,
)
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.serving.spec import (
    DraftModelProposer,
    NgramProposer,
    Proposer,
)
from fleetx_tpu_torch.serving.workload import (
    DISTRIBUTIONS,
    RequestOutcome,
    TenantSpec,
    TraceDistribution,
    TraceRequest,
    WorkloadSpec,
    generate_trace,
    run_trace,
    score_goodput,
    trace_hash,
)

__all__ = ["QueueFull", "RecoveryExhausted", "ServingEngine",
           "ServingResult", "ShuttingDown", "TickTimeout", "BatchingEngine",
           "EmbeddingEngine", "ErnieScoringEngine", "decode_floats",
           "encode_floats", "GPTExecutor",
           "ModelCapabilities", "ENGINE_SURFACE", "engine_conforms",
           "PagePool", "PagedKVCacheManager", "SlotKVCacheManager",
           "HostPageStore", "DiskPageStore", "TieredPageStore",
           "FIFOScheduler", "Request", "DraftModelProposer", "NgramProposer",
           "Proposer", "ServingMetrics", "filter_logits", "sample_tokens",
           "FleetAutoscaler", "ReplicaState", "RouterMetrics",
           "ServingRouter", "TenantPolicy", "DISTRIBUTIONS",
           "RequestOutcome", "TenantSpec", "TraceDistribution",
           "TraceRequest", "WorkloadSpec", "generate_trace", "run_trace",
           "score_goodput", "trace_hash"]
