"""Config-driven factories (port of isopoints_tpu/factories.py, for what
the ported configs name: a SIREN or IGR (`decoder_type: sdf`) decoder, the
combined or implicit model with the Phong or the neural texture, the DSS
point model, the splat raster settings, the lights, the MVR, DTU and
synthetic datasets, and the trainer over the ranks of a process group).
A dotted `decoder_type` is a class path inside this package, resolved by
`utils.get_class_from_string`; a leading `isopoints_tpu.` is read as
`isopoints_torch.`, so a config written for the JAX package loads. An
unknown decoder or model type, or a path that names no class of the port,
raises ValueError with the reference's message."""

from typing import Optional

import torch

from isopoints_torch.config import AttrDict
from isopoints_torch.models.combined import CombinedConfig, CombinedModel
from isopoints_torch.models.fields import RenderingNetwork, SDFField, SirenField
from isopoints_torch.models.implicit import ImplicitConfig, ImplicitModel
from isopoints_torch.models.point import PointModel, PointModelConfig
from isopoints_torch.parallel.sharding import make_mesh
from isopoints_torch.rendering.lighting import DirectionalLights, PointLights
from isopoints_torch.rendering.rasterizer import RasterizationSettings
from isopoints_torch.training.scheduler import TrainerScheduler
from isopoints_torch.training.trainer import MVRTrainer, TrainerConfig
from isopoints_torch.utils import get_class_from_string


def create_decoder(cfg: AttrDict, generator: Optional[torch.Generator] = None,
                   device="cuda"):
    """The decoder of `model.decoder_type` ('siren' | 'sdf' | a dotted
    class path) with `model.decoder_kwargs` (factories.py:24-35)."""
    dtype = cfg.model.get("decoder_type", "siren")
    classes = {"siren": SirenField, "sdf": SDFField}
    if "." in dtype:
        try:
            cls = get_class_from_string(dtype)
        except ValueError:
            raise ValueError(f"unknown decoder_type {dtype}") from None
    elif dtype in classes:
        cls = classes[dtype]
    else:
        raise ValueError(f"unknown decoder_type {dtype}")
    return cls(**dict(cfg.model.get("decoder_kwargs", {})),
               generator=generator, device=device)


def create_raster_settings(cfg: AttrDict) -> RasterizationSettings:
    return RasterizationSettings(
        **dict(cfg.get("renderer", {}).get("raster_params", {})))


def create_lights(cfg: AttrDict, device=None):
    """The config's `lights` block (factories.py:43-51): `type: point`
    makes `PointLights`, anything else `DirectionalLights`, with the
    block's other keys; no block gives the default directional light."""
    lcfg = cfg.get("lights", None)
    if not lcfg:
        return DirectionalLights.create(device=device)
    kwargs = {k: v for k, v in lcfg.items() if k != "type"}
    cls = PointLights if lcfg.get("type", "directional") == "point" else DirectionalLights
    return cls.create(**kwargs, device=device)


def create_model(cfg: AttrDict, generator: Optional[torch.Generator] = None,
                 device="cuda"):
    """Model of `model.type` ('combined' | 'implicit' | 'point'),
    parameters drawn from `generator` on `device`."""
    mtype = cfg.model.get("type", "combined")
    if mtype == "point":
        # no implicit decoder or texture (factories.py:57-60)
        pcfg = PointModelConfig(**dict(cfg.model.get("point_kwargs", {})))
        return PointModel(pcfg, create_raster_settings(cfg), generator=generator,
                          device=device)
    decoder = create_decoder(cfg, generator, device)
    icfg = ImplicitConfig(**dict(cfg.model.get("implicit_kwargs", {})))
    rendering_net = None
    if icfg.texture_type == "neural":
        # no latent code feeds the texture net (c_dim 0), inputs [normals,
        # points, embedded view] (factories.py:64-71)
        tkw = {"dim": 9, "c_dim": 0}
        tkw.update(dict(cfg.model.get("texture_kwargs", {})))
        rendering_net = RenderingNetwork(**tkw, generator=generator,
                                         device=device)
    if mtype == "implicit":
        return ImplicitModel(decoder, icfg, rendering_net)
    if mtype == "combined":
        ccfg = CombinedConfig(**dict(cfg.model.get("combined_kwargs", {})))
        return CombinedModel(decoder, icfg, ccfg,
                             raster_settings=create_raster_settings(cfg),
                             rendering_net=rendering_net)
    raise ValueError(f"unknown model type {mtype}")


def create_trainer(model, cfg: AttrDict, seed: int = 0, device="cuda",
                   n_devices: int = 1, views_sharded: bool = False
                   ) -> MVRTrainer:
    """The trainer of the config's `training` block (factories.py:82-99):
    rays sharded over the ranks of `parallel.sharding.make_mesh(n_devices)`
    (1: one rank, no process group; 0: every rank of the group), and with
    `views_sharded` each rank passing only its share of the views."""
    tkw = dict(cfg.get("training", {}))
    sched_kw = {k[len("scheduler_"):]: v for k, v in tkw.items()
                if k.startswith("scheduler_")}
    tcfg = TrainerConfig(**{k: v for k, v in tkw.items()
                            if k in TrainerConfig.__dataclass_fields__})
    scheduler = TrainerScheduler(**sched_kw) if sched_kw else None
    return MVRTrainer(model, tcfg, scheduler=scheduler, seed=seed,
                      device=device, mesh=make_mesh(n_devices, device),
                      views_sharded=views_sharded)


def create_dataset(cfg: AttrDict, mode: str = "train", device="cuda"):
    """The dataset of `data.type` (factories.py:102-126): an `MVRDataset`
    or a `DTUDataset` directory, or the in-memory arrays of a synthetic
    `sphere | torus | box` rendered on `device`. `mode` is accepted and
    not read, as in the JAX function."""
    dtype = cfg.data.get("type", "MVR")
    if dtype in ("MVR", "DTU"):
        from isopoints_torch.data.dataset import DTUDataset, MVRDataset
        cls = MVRDataset if dtype == "MVR" else DTUDataset
        return cls(cfg.data.data_dir,
                   img_extension=cfg.data.get("img_extension", "png"))
    if dtype != "synthetic":
        raise ValueError(f"unknown dataset type {dtype}")
    from isopoints_torch.data import synthetic
    return synthetic.make_synthetic_mvr(
        synthetic.SDFS[cfg.data.get("sdf", "sphere")](),
        n_views=cfg.data.get("n_views", 24),
        image_size=cfg.data.get("image_size", 64),
        dist=cfg.data.get("camera_distance", 2.0),
        focal=cfg.data.get("focal_length", 2.0),
        seed=cfg.data.get("seed", 0), device=device)
