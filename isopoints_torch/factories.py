"""Config-driven factories (port of isopoints_tpu/factories.py, for what
the warm-up slice's config names: a SIREN decoder, the combined or
implicit model with the Phong texture, the synthetic datasets)."""

from typing import Optional

import torch

from isopoints_torch.config import AttrDict
from isopoints_torch.models.combined import CombinedConfig, CombinedModel
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.implicit import ImplicitConfig, ImplicitModel
from isopoints_torch.training.scheduler import TrainerScheduler
from isopoints_torch.training.trainer import MVRTrainer, TrainerConfig


def create_decoder(cfg: AttrDict, generator: Optional[torch.Generator] = None,
                   device="cuda") -> SirenField:
    dtype = cfg.model.get("decoder_type", "siren")
    if dtype != "siren":
        raise NotImplementedError(f"decoder_type {dtype!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    return SirenField(**dict(cfg.model.get("decoder_kwargs", {})),
                      generator=generator, device=device)


def create_model(cfg: AttrDict, generator: Optional[torch.Generator] = None,
                 device="cuda"):
    """Model of `model.type` ('combined' | 'implicit'), parameters drawn
    from `generator` on `device`."""
    mtype = cfg.model.get("type", "combined")
    decoder = create_decoder(cfg, generator, device)
    icfg = ImplicitConfig(**dict(cfg.model.get("implicit_kwargs", {})))
    if mtype == "implicit":
        return ImplicitModel(decoder, icfg)
    if mtype == "combined":
        ccfg = CombinedConfig(**dict(cfg.model.get("combined_kwargs", {})))
        return CombinedModel(decoder, icfg, ccfg)
    raise NotImplementedError(f"model type {mtype!r} is not ported yet")


def create_trainer(model, cfg: AttrDict, seed: int = 0,
                   device="cuda") -> MVRTrainer:
    tkw = dict(cfg.get("training", {}))
    sched_kw = {k[len("scheduler_"):]: v for k, v in tkw.items()
                if k.startswith("scheduler_")}
    tcfg = TrainerConfig(**{k: v for k, v in tkw.items()
                            if k in TrainerConfig.__dataclass_fields__})
    scheduler = TrainerScheduler(**sched_kw) if sched_kw else None
    return MVRTrainer(model, tcfg, scheduler=scheduler, seed=seed,
                      device=device)


def create_dataset(cfg: AttrDict, device="cuda"):
    """The synthetic dataset of `data` (in-memory arrays); the MVR and DTU
    directory loaders are not ported yet (ROADMAP Queue 1 item 7)."""
    dtype = cfg.data.get("type", "MVR")
    if dtype != "synthetic":
        raise NotImplementedError(f"dataset type {dtype!r} is not ported yet")
    from isopoints_torch.data import synthetic
    name = cfg.data.get("sdf", "sphere")
    if name != "sphere":
        raise NotImplementedError(f"synthetic sdf {name!r} is not ported yet")
    return synthetic.make_synthetic_mvr(
        synthetic.sphere_sdf(),
        n_views=cfg.data.get("n_views", 24),
        image_size=cfg.data.get("image_size", 64),
        dist=cfg.data.get("camera_distance", 2.0),
        focal=cfg.data.get("focal_length", 2.0),
        seed=cfg.data.get("seed", 0), device=device)
