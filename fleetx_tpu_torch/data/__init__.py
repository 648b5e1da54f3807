"""Dataset and loader construction from config:
``build_dataset(section, mode)`` and ``build_dataloader(cfg, mode)`` (the
JAX package's data/__init__.py: ``GPTDataset``, ``ErnieDataset``,
``GeneralClsDataset`` and ``SyntheticClsDataset``)."""

from __future__ import annotations

__all__ = ["build_dataset", "build_dataloader"]


def build_dataset(ds_cfg, mode: str = "Train", **extra):
    """The dataset named by a ``Data.<mode>.dataset`` config node."""
    from fleetx_tpu_torch.data.ernie_dataset import ErnieDataset
    from fleetx_tpu_torch.data.gpt_dataset import GPTDataset
    from fleetx_tpu_torch.data.vision_dataset import (
        GeneralClsDataset,
        SyntheticClsDataset,
    )

    registry = {"GPTDataset": GPTDataset, "ErnieDataset": ErnieDataset,
                "GeneralClsDataset": GeneralClsDataset,
                "SyntheticClsDataset": SyntheticClsDataset}
    kwargs = dict(ds_cfg)
    name = kwargs.pop("name")
    if name not in registry:
        raise ValueError(f"unknown dataset {name!r}; the port has "
                         f"{sorted(registry)}")
    kwargs.update(extra)
    return registry[name](mode=mode, **kwargs)


def build_dataloader(cfg, mode: str = "Train", consumed_samples: int = 0):
    """Loader of the config's ``Data.<mode>`` section: each rank takes its
    data rank's slice of every global batch (dp × fsdp slices), so the
    ranks of one cp group (which split one batch's sequences) read the
    same rows."""
    from fleetx_tpu_torch.data.dataloader import (
        DataLoader,
        default_collate_fn,
    )
    from fleetx_tpu_torch.data.sampler import GPTBatchSampler
    from fleetx_tpu_torch.parallel.mesh import (
        get_data_world,
        mesh_from_config,
    )

    section = cfg.Data[mode]
    dataset = build_dataset(section.dataset, mode=mode, seed=cfg.Global.seed)
    sampler_cfg = dict(section.get("sampler") or {})
    sampler_cfg.pop("name", None)
    mesh = mesh_from_config(cfg)
    sampler = GPTBatchSampler(
        dataset_len=len(dataset),
        batch_size=cfg.Global.global_batch_size,
        consumed_samples=consumed_samples,
        seed=cfg.Global.seed,
        process_index=mesh.data_rank,
        process_count=get_data_world(mesh),
        **sampler_cfg,
    )
    loader_cfg = dict(section.get("loader") or {})
    return DataLoader(dataset, sampler, collate_fn=default_collate_fn,
                      num_workers=loader_cfg.get("num_workers", 0))
