"""Import gate of the PyTorch port: ``fleetx_tpu_torch`` and
``chip_smoke.py`` must never need JAX, flax or the JAX package."""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "fleetx_tpu_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax():
    """A fresh interpreter with jax/flax blocked imports every module of
    the port and ``chip_smoke`` (without running it)."""
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'fleetx_tpu'):",
        "    sys.modules[name] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for mod in {_modules()!r} + ['chip_smoke']:",
        "    importlib.import_module(mod)",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
        "'fleetx_tpu.')) for m, v in sys.modules.items() if v is not None)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_gate_covers_the_training_slice():
    """The gate's module list holds every module of the training path, so
    a slice that drops one from the package fails here."""
    mods = set(_modules())
    for name in ("ops.flash_attention", "ops.dropout", "ops.attention",
                 "models.gpt.model", "models.module",
                 "models.language_module", "optims.lr_scheduler",
                 "optims.optimizer", "data.gpt_dataset", "data.sampler",
                 "data.dataloader", "core.engine", "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "flash_attention.cu").is_file()


def test_gate_covers_the_generation_slice():
    """Likewise for one-shot generation and int8 KV: the quantization
    helpers, the generation module, the decode kernels' wrapper and its
    CUDA source."""
    mods = set(_modules())
    for name in ("ops.quant", "ops.decode_attention", "models.gpt.generation",
                 "models.language_module_generation", "serving.engine",
                 "serving.cache_manager", "serving.metrics"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "decode_attention.cu").is_file()


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_names_the_jax_package(path):
    text = path.read_text()
    for needle in ("fleetx_tpu.", "import jax", "from jax", "import flax",
                   "from flax"):
        assert needle not in text, f"{path} contains {needle!r}"


def test_gate_covers_the_fused_ce_slice():
    """Likewise for the fused LM-head cross-entropy: its kernel module and
    CUDA source, and the modules its path runs through."""
    mods = set(_modules())
    for name in ("ops.ce_loss", "models.gpt.model", "models.language_module",
                 "core.engine", "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "ce_loss.cu").is_file()


def test_gate_covers_the_context_parallel_slice():
    """Likewise for data and context parallelism: the process group, the
    mesh, the ring and the launcher, and the modules the CP path runs
    through."""
    mods = set(_modules())
    for name in ("parallel.env", "parallel.mesh", "parallel.context_parallel",
                 "parallel.launch", "ops.flash_attention", "ops.dropout",
                 "models.gpt.model", "models.language_module", "core.engine",
                 "data", "utils.config", "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "flash_attention.cu").is_file()


def test_gate_covers_the_tensor_parallel_slice():
    """Likewise for tensor parallelism: the mp layers and the modules the
    mp path runs through, B12's wrapper and its CUDA source."""
    mods = set(_modules())
    for name in ("parallel.tensor_parallel", "parallel.mesh", "ops.ce_loss",
                 "models.gpt.model", "models.gpt.convert",
                 "models.language_module", "optims.optimizer", "core.engine",
                 "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "ce_loss.cu").is_file()


def test_gate_covers_the_resilience_slice():
    """Likewise for checkpoints, the step sentry and preemption: the
    checkpoint store, the fault injector, the load-time mesh contract and
    the trainer and CLI that run them."""
    mods = set(_modules())
    for name in ("core.checkpoint", "core.engine", "resilience",
                 "resilience.faults", "resilience.elastic", "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name


def test_gate_covers_the_pipeline_slice():
    """Likewise for pipeline parallelism: the remaps, placement, schedule
    and transport, and the modules the pp path runs through."""
    mods = set(_modules())
    for name in ("parallel.pipeline", "parallel.mesh", "models.gpt.model",
                 "models.gpt.convert", "models.language_module",
                 "models.language_module_generation", "core.checkpoint",
                 "core.engine", "tools.train"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "flash_attention.cu").is_file()


def test_gate_covers_the_serving_slice():
    """Likewise for the serving engine's slot cache, chunked prefill and
    speculative decoding: the proposers, the scheduler, the executor
    protocol, the caches and the metrics, and the decode kernels' wrapper
    and source."""
    mods = set(_modules())
    for name in ("serving", "serving.spec", "serving.engine",
                 "serving.scheduler", "serving.model_protocol",
                 "serving.cache_manager", "serving.metrics",
                 "ops.decode_attention", "tools.serving_check"):
        assert f"fleetx_tpu_torch.{name}" in mods, name
    assert (PKG / "ops" / "csrc" / "decode_attention.cu").is_file()


def test_gate_covers_the_serving_recovery_slice():
    """Likewise for the page tiers and their wire format, the roles, crash
    recovery and the router-facing surface; these modules import with
    ``ml_dtypes`` blocked too (the wire format's bf16 goes through torch)."""
    mods = set(_modules())
    names = ("serving", "serving.cache_manager", "serving.engine",
             "serving.scheduler", "serving.metrics", "serving.model_protocol",
             "resilience.faults", "obs.events")
    for name in names:
        assert f"fleetx_tpu_torch.{name}" in mods, name
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'fleetx_tpu', 'ml_dtypes'):",
        "    sys.modules[name] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for mod in {['fleetx_tpu_torch.' + n for n in names]!r}:",
        "    importlib.import_module(mod)",
        "from fleetx_tpu_torch.serving import (DiskPageStore, HostPageStore,",
        "    TieredPageStore, engine_conforms)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_gate_covers_the_fleet_slice():
    """Likewise for the fleet layer: the router, the autoscaler, the
    workload traces, the replica RPC and the front door, the launcher and
    the chaos scenarios; they import with JAX blocked and export the
    names the JAX package's ``serving`` exports for them."""
    mods = set(_modules())
    names = ("serving.router", "serving.workload", "serving.autoscaler",
             "serving.api", "serving.api.wire", "serving.api.server",
             "serving.api.replica_server", "serving.api.replica_client",
             "tools.serve", "tools.chaos_check", "resilience.faults")
    for name in names:
        assert f"fleetx_tpu_torch.{name}" in mods, name
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'fleetx_tpu'):",
        "    sys.modules[name] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for mod in {['fleetx_tpu_torch.' + n for n in names]!r}:",
        "    importlib.import_module(mod)",
        "from fleetx_tpu_torch.serving import (FleetAutoscaler, ReplicaState,",
        "    RouterMetrics, ServingRouter, TenantPolicy, DISTRIBUTIONS,",
        "    RequestOutcome, TenantSpec, TraceDistribution, TraceRequest,",
        "    WorkloadSpec, generate_trace, run_trace, score_goodput,",
        "    trace_hash)",
        "from fleetx_tpu_torch.serving.api import (ApiServer, ReplicaClient,",
        "    ReplicaServer)",
        "from fleetx_tpu_torch.resilience.faults import ReplicaKilled, RPCFault",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_gate_covers_the_hetero_slice():
    """Likewise for the heterogeneous fleet: the ERNIE and ViT models and
    their weight bridges, the KV-free engines and the front door; they
    import with JAX blocked and the serving package exports the names the
    JAX package's exports for them."""
    mods = set(_modules())
    names = ("models.ernie", "models.ernie.model", "models.ernie.convert",
             "models.vision", "models.vision.vit", "models.vision.convert",
             "serving.batch_engine", "serving.ernie_engine",
             "serving.embedding_engine", "serving.model_protocol",
             "serving.api.server", "tools.chaos_check")
    for name in names:
        assert f"fleetx_tpu_torch.{name}" in mods, name
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'fleetx_tpu'):",
        "    sys.modules[name] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for mod in {['fleetx_tpu_torch.' + n for n in names]!r}:",
        "    importlib.import_module(mod)",
        "from fleetx_tpu_torch.serving import (BatchingEngine,",
        "    EmbeddingEngine, ErnieScoringEngine, decode_floats,",
        "    encode_floats)",
        "from fleetx_tpu_torch.models.ernie import (ErnieConfig,",
        "    ErnieForPretraining, ErnieForSequenceClassification, ErnieModel,",
        "    ernie_pretraining_loss)",
        "from fleetx_tpu_torch.models.vision import (VIT_PRESETS, ViT,",
        "    ViTConfig, build_vision_model)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
