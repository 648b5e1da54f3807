"""Configuration system: YAML with ``_base_`` inheritance, dot-path overrides,
and batch-size/degree algebra.

Capability parity with the reference config stack
(reference ppfleetx/utils/config.py:31-374 — ``parse_config`` `_base_`
chains, ``override_config`` ``-o a.b.c=v``, ``process_dist_config`` degree
math, ``process_global_configs`` batch algebra, ``process_engine_config``
accumulate_steps). Copy of the JAX package's loader, so both packages read
the same YAML files the same way; degrees validate against the ranks of
the initialised ``torch.distributed`` world, else
``torch.cuda.device_count()``.
"""

from __future__ import annotations

import argparse
import codecs
import copy
import os
from typing import Any, List, Optional, Sequence

import yaml

from fleetx_tpu_torch.utils.log import logger, only_primary

__all__ = [
    "AttrDict",
    "parse_config",
    "parse_args",
    "override_config",
    "process_dist_config",
    "process_global_configs",
    "process_engine_config",
    "process_configs",
    "get_config",
]


class AttrDict(dict):
    """Dict with attribute-style access. Missing keys read as ``None`` so
    optional config sections can be probed without try/except."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            return None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        return AttrDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()})

    def setdefault_section(self, key: str) -> "AttrDict":
        """Return cfg[key], creating an empty AttrDict section if absent."""
        if self.get(key) is None:
            self[key] = AttrDict()
        return self[key]


def create_attr_dict(d: dict) -> AttrDict:
    """Recursively convert nested dicts into AttrDicts in place."""
    out = AttrDict()
    for k, v in d.items():
        if k == "_inherited_":  # inheritance marker, never part of the config
            continue
        out[k] = create_attr_dict(v) if isinstance(v, dict) else v
    return out


def _merge_dict(base: dict, update: dict) -> dict:
    """Recursively merge ``update`` into ``base`` (update wins). A sub-dict in
    ``update`` carrying ``_inherited_: False`` replaces the base sub-dict
    wholesale instead of merging."""
    for k, v in update.items():
        if isinstance(v, dict):
            inherit = v.pop("_inherited_", True)
            if isinstance(base.get(k), dict) and inherit is not False:
                _merge_dict(base[k], v)
            else:
                base[k] = v
        else:
            base[k] = v
    return base


def parse_config(fpath: str) -> AttrDict:
    """Load a YAML config, resolving ``_base_`` inheritance chains
    (child values override parents; relative ``_base_`` paths resolve against
    the child file's directory)."""
    with codecs.open(fpath, "r", "utf-8") as f:
        raw = yaml.safe_load(f) or {}
    base_path = raw.pop("_base_", None)
    if base_path is not None:
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(fpath), base_path)
        base = dict(parse_config(base_path))
        raw = _merge_dict(base, raw)
    return create_attr_dict(raw)


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics
    ('True'→bool, '1e-4'→float, '[1,2]'→list, bare words→str)."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        # YAML 1.1 misses '1e-4'-style floats (no dot before the exponent).
        try:
            return float(value)
        except ValueError:
            return value
    return value


def override_config(cfg: AttrDict, options: Optional[Sequence[str]] = None) -> AttrDict:
    """Apply ``-o Key.Sub.Leaf=value`` dot-path overrides in order."""
    if not options:
        return cfg
    for opt in options:
        opt = opt.strip()
        if "=" not in opt:
            raise ValueError(f"override option must look like a.b.c=value, got {opt!r}")
        path, value = opt.split("=", 1)
        keys = path.split(".")
        node = cfg
        for k in keys[:-1]:
            if not isinstance(node.get(k), dict):
                node[k] = AttrDict()
            node = node[k]
        node[keys[-1]] = _parse_scalar(value)
    return cfg


def _device_count() -> int:
    """The ranks the degrees lay out: the initialised ``torch.distributed``
    world (ranks may share one card), else the visible CUDA cards, or 1
    (the CPU) when there are none. Import of torch is deferred so pure
    config-time tooling stays light."""
    env = os.environ.get("FLEETX_FAKE_DEVICE_COUNT")
    if env:
        return int(env)
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() or 1


def process_dist_config(cfg: AttrDict, nranks: Optional[int] = None) -> AttrDict:
    """Normalize the ``Distributed`` section: fill defaults, derive
    ``dp_degree = nranks // (mp * pp * sharding)``, and validate the product.

    Degree semantics match the reference (config.py:31-93); the degrees here
    parameterize mesh axes ('dp','fsdp','mp','pp') instead of NCCL groups.
    """
    dist = cfg.setdefault_section("Distributed")
    if nranks is None:
        nranks = _device_count()
    mp = dist.mp_degree or 1
    pp = dist.pp_degree or 1
    cp = dist.cp_degree or 1
    dist.mp_degree = mp
    dist.pp_degree = pp
    dist.cp_degree = cp

    sharding = dist.setdefault_section("sharding")
    sharding.sharding_degree = sharding.sharding_degree or 1
    sharding.sharding_stage = sharding.sharding_stage or 1
    sharding.sharding_offload = bool(sharding.sharding_offload)
    if sharding.sharding_stage not in (1, 2, 3):
        raise ValueError(f"sharding_stage must be 1/2/3, got {sharding.sharding_stage}")
    sd = sharding.sharding_degree

    other = mp * pp * sd * cp
    if nranks % other != 0:
        raise ValueError(
            f"device count {nranks} not divisible by mp*pp*sharding*cp = {mp}*{pp}*{sd}*{cp}"
        )
    derived_dp = nranks // other
    if dist.dp_degree in (None, ""):
        dist.dp_degree = derived_dp
    dp = dist.dp_degree
    if dp * other != nranks:
        raise ValueError(
            f"dp({dp}) * mp({mp}) * pp({pp}) * sharding({sd}) * cp({cp}) = {dp * other} "
            f"!= device count {nranks}"
        )
    # Sequence parallel rides the mp axis (Megatron-style); flag lives in Model.
    model = cfg.get("Model") or {}
    if model.get("sequence_parallel") and mp <= 1:
        logger.warning("sequence_parallel=True with mp_degree<=1 has no effect; disabling")
        model["sequence_parallel"] = False
    # (r5) attention dropout under cp_degree>1 runs inside the ring's
    # per-hop flash kernels with position-keyed bits, so the realized mask
    # equals the cp=1 kernel's (parallel/context_parallel.py). The old
    # forcing-to-0 guard survives ONLY for configurations the flash ring
    # cannot serve (explicit FLEETX_CP_FLASH=0, or a local block below the
    # 8-row tile) — there the jnp ring path has no dropout support and
    # would raise deep inside shard_map tracing.
    if cp > 1 and (model.get("attention_probs_dropout_prob") or 0) > 0:
        seq = ((cfg.get("Data") or {}).get("Train") or {}).get(
            "dataset", {}).get("max_seq_len")
        # mirror context_parallel._cp_flash_enabled: any value but "1"
        # disables the flash ring
        flash_off = os.environ.get("FLEETX_CP_FLASH", "1") != "1"
        untileable = seq is not None and (seq // (2 * cp)) % 8 != 0
        if flash_off or untileable:
            logger.warning(
                "cp_degree>1 with attention dropout needs the flash ring "
                "path (%s); forcing attention_probs_dropout_prob=0",
                "FLEETX_CP_FLASH=0 set" if flash_off
                else f"seq {seq} / (2*cp={2 * cp}) is not 8-row tileable",
            )
            model["attention_probs_dropout_prob"] = 0.0
    return cfg


def process_global_configs(cfg: AttrDict) -> AttrDict:
    """Batch-size algebra: ``global = local * dp * sharding`` where the
    data-parallel world is dp_degree × sharding_degree. Any one of
    global/local may be omitted and is derived; both present are validated."""
    glb = cfg.setdefault_section("Global")
    dist = cfg.Distributed or AttrDict()
    dp_world = (dist.dp_degree or 1) * ((dist.sharding or AttrDict()).sharding_degree or 1)

    gbs, lbs, mbs = glb.global_batch_size, glb.local_batch_size, glb.micro_batch_size
    if gbs in (None, "") and lbs in (None, ""):
        raise ValueError("one of Global.global_batch_size / Global.local_batch_size required")
    if gbs in (None, ""):
        glb.global_batch_size = lbs * dp_world
    elif lbs in (None, ""):
        if gbs % dp_world != 0:
            raise ValueError(f"global_batch_size {gbs} not divisible by dp world {dp_world}")
        glb.local_batch_size = gbs // dp_world
    else:
        if gbs != lbs * dp_world:
            raise ValueError(
                f"global_batch_size {gbs} != local_batch_size {lbs} * dp world {dp_world}"
            )
    if mbs in (None, ""):
        glb.micro_batch_size = glb.local_batch_size
    if glb.local_batch_size % glb.micro_batch_size != 0:
        raise ValueError(
            f"local_batch_size {glb.local_batch_size} not divisible by "
            f"micro_batch_size {glb.micro_batch_size}"
        )
    if glb.seed in (None, ""):  # explicit 0 is a valid seed
        glb.seed = 1024
    return cfg


def process_engine_config(cfg: AttrDict) -> AttrDict:
    """Fill Engine defaults; ``accumulate_steps = local / micro`` unless set."""
    eng = cfg.setdefault_section("Engine")
    glb = cfg.Global or AttrDict()
    if eng.accumulate_steps in (None, ""):
        local = glb.local_batch_size or 1
        micro = glb.micro_batch_size or local
        eng.accumulate_steps = max(1, local // micro)
    eng.max_steps = eng.max_steps or 500000
    eng.num_train_epochs = eng.num_train_epochs or 1
    eng.logging_freq = eng.logging_freq or 10
    eng.eval_freq = eng.eval_freq if eng.eval_freq else 0
    eng.eval_iters = eng.eval_iters or 10

    mp_cfg = eng.setdefault_section("mix_precision")
    if mp_cfg.use_pure_fp16 is None:
        mp_cfg.use_pure_fp16 = False
    # TPU-native default: bf16 needs no loss scaling; fp16 paths keep it.
    mp_cfg.scale_loss = mp_cfg.scale_loss or 32768.0
    if mp_cfg.dtype is None:
        mp_cfg.dtype = "bfloat16" if mp_cfg.use_pure_fp16 else "float32"

    sl = eng.setdefault_section("save_load")
    sl.save_steps = sl.save_steps or 1000
    sl.output_dir = sl.output_dir or "./output"
    return cfg


def process_configs(cfg: AttrDict, nranks: Optional[int] = None) -> AttrDict:
    """Run all normalization passes (dist degrees, batch algebra, engine
    defaults) on a parsed config."""
    process_dist_config(cfg, nranks=nranks)
    process_global_configs(cfg)
    process_engine_config(cfg)
    return cfg


def get_config(
    fpath: str,
    overrides: Optional[Sequence[str]] = None,
    show: bool = False,
    nranks: Optional[int] = None,
) -> AttrDict:
    """Load + override + normalize a training config."""
    cfg = parse_config(fpath)
    override_config(cfg, overrides)
    process_configs(cfg, nranks=nranks)
    if show:
        print_config(cfg)
    return cfg


@only_primary
def print_config(cfg: dict, indent: int = 0) -> None:
    """Pretty-print the config tree via the logger."""
    for k, v in cfg.items():
        if isinstance(v, dict):
            logger.info("%s%s:", "  " * indent, k)
            print_config(v, indent + 1)
        else:
            logger.info("%s%s: %s", "  " * indent, k, v)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Standard CLI surface: -c/--config plus repeatable -o dot-path overrides
    (reference utils/config.py parse_args)."""
    parser = argparse.ArgumentParser("fleetx-tpu runner")
    parser.add_argument("-c", "--config", required=True, help="config YAML path")
    parser.add_argument(
        "-o",
        "--override",
        action="append",
        default=[],
        help="override option Key.Sub=value (repeatable)",
    )
    return parser.parse_args(argv)
