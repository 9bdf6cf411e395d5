"""MVR training step (port of isopoints_tpu/training/trainer.py:79-174,
177-318, 416-460).

`compute_loss` assembles the photoconsistency L1, the freespace /
occupancy BCE and the eikonal loss exactly as the JAX version does with
one device (n_dev = 1, so its local and global normalisers coincide).
`MVRTrainer.train_step` replaces the jitted shard_map step of
isopoints_tpu/parallel/sharding.py:85-127 on a single device: draw pixels,
eikonal points and the phase's other random numbers, forward, backward,
then clip by global norm and Adam(b1=0.9, b2=0.99, eps=1e-8) written out
with optax's formulas (optax's clip divides by the norm without the +1e-6
of `torch.nn.utils.clip_grad_norm_`). The update is applied in place to
the model's parameters.

From `warm_up_iters` on, the step is projected: at `warm_up_iters` and
every `resample_every` iterations the persistent iso-points are resampled
from the current cloud (`resample_iso_points`), and the splat spacing of
the buffer is cached in `TrainState.spacing` until the buffer's shape
changes (trainer.py:248-314).

The step takes an optional `draws` (StepDraws); without it the step draws
from its own generator chain. Tests pass the JAX step's draws to compare
the two packages on the same random numbers.
"""

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.logger import get_logger
from isopoints_torch.models.combined import CombinedModel, ProjectedDraws
from isopoints_torch.models.levelset import sample_uniform_iso_points
from isopoints_torch.ops.images import sample_random_pixels
from isopoints_torch.rendering.rasterizer import splat_spacing
from isopoints_torch.rng import GeneratorChain
from isopoints_torch.training.losses import (
    eikonal_loss,
    sdf_freespace_loss,
    sdf_occupancy_loss,
)
from isopoints_torch.training.scheduler import TrainerScheduler
from isopoints_torch.utils import check_weights


@dataclass(frozen=True)
class TrainerConfig:
    """Loss weights and cadences of trainer.py:43-64. Saliency-weighted
    resampling (`saliency_sampling`) is not ported: it raises at the
    first resample (ROADMAP Queue 1 item 8)."""
    lambda_rgb: float = 1.0
    lambda_freespace: float = 1.0
    lambda_occupied: float = 1.0
    lambda_eikonal: float = 0.01
    n_eikonal_points: int = 1024
    warm_up_iters: int = 500
    resample_every: int = 500
    n_rays: int = 1024
    grad_clip: float = 1.0
    learning_rate: float = 1e-4
    saliency_sampling: bool = False


class StepDraws(NamedTuple):
    """The random numbers of one step: the warm-up fields always, the
    projected forward's from `warm_up_iters` on, and the resample's
    subsample ranks (shaped like the seed cloud's mask) on a resample
    step whose seed is wider than the target."""
    pixels: torch.Tensor     # (B, n_rays, 2) NDC pixel samples
    eikonal: torch.Tensor    # (1, n_eikonal_points, 3) uniform in [-1, 1)
    u_minsdf: torch.Tensor   # (n_steps,) min-SDF step fractions in [0, 1)
    projected: Optional[ProjectedDraws] = None
    resample_u: Optional[torch.Tensor] = None


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    opt_state: AdamState
    points: Optional[torch.Tensor]        # (1, P, 3) persistent iso-points
    points_mask: Optional[torch.Tensor]   # (1, P)
    it: int
    # cached splat_spacing of `points`, kept while its shape matches
    spacing: Optional[torch.Tensor] = None


def compute_loss(model: CombinedModel, points, points_mask,
                 ndc_pixels: torch.Tensor, img: torch.Tensor,
                 mask_img: torch.Tensor, camera: PerspectiveCamera,
                 eikonal_points: torch.Tensor, u_minsdf: torch.Tensor,
                 hp: Dict[str, float], project: bool, training: bool = True,
                 proj_draws: Optional[ProjectedDraws] = None,
                 spacing: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                            Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Loss assembly (trainer.py:79-174 with n_dev = 1: the freespace
    set's ray rows and iso-point rows share the normaliser 1/n_px).
    Returns (total, metrics, new_points, new_points_mask)."""
    b, n_ray = ndc_pixels.shape[:2]
    out, new_pts, new_mask = model(ndc_pixels, img, mask_img, camera,
                                   u_minsdf, points=points,
                                   points_mask=points_mask, project=project,
                                   training=training, draws=proj_draws,
                                   spacing=spacing)
    n_px = float(b * n_ray)

    rgb_diff = torch.sum(torch.abs(out.iso_rgb - out.iso_rgb_gt), dim=-1)
    loss_rgb = torch.sum(torch.where(out.iso_mask, rgb_diff,
                                     torch.zeros_like(rgb_diff))) / n_px
    alpha = hp["sdf_alpha"]
    free_elems = sdf_freespace_loss(out.sdf_freespace, alpha=alpha,
                                    mask=out.freespace_mask, reduction="none")
    loss_free = torch.sum(free_elems * (1.0 / n_px))
    loss_occ = sdf_occupancy_loss(out.sdf_occupancy, alpha=alpha,
                                  mask=out.occupancy_mask,
                                  reduction="sum") / n_px
    loss_eik = eikonal_loss(model.normals_from_grad(eikonal_points))

    total = (hp["lambda_rgb"] * loss_rgb
             + hp["lambda_freespace"] * loss_free
             + hp["lambda_occupied"] * loss_occ
             + hp["lambda_eikonal"] * loss_eik)
    metrics = {"loss": total, "loss_rgb": loss_rgb,
               "loss_freespace": loss_free, "loss_occupied": loss_occ,
               "loss_eikonal": loss_eik, "n_iso": torch.sum(out.iso_mask),
               "overflow_trace": out.overflow_trace,
               "overflow_sampler": out.overflow_sampler}
    return total, metrics, new_pts, new_mask


@torch.no_grad()
def clip_and_adam(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: AdamState,
                  learning_rate: float, max_norm: float, b1: float = 0.9,
                  b2: float = 0.99, eps: float = 1e-8) -> AdamState:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps)):
    updates `params` in place and returns the new state."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    count = state.count + 1
    mu, nu = {}, {}
    for name, p in params.items():
        g = grads[name]
        g = torch.where(keep, g, (g / g_norm) * max_norm)
        mu[name] = (1 - b1) * g + b1 * state.mu[name]
        nu[name] = (1 - b2) * (g * g) + b2 * state.nu[name]
        one = torch.ones((), dtype=p.dtype, device=p.device)
        mu_hat = mu[name] / (1 - (b1 * one) ** count)
        nu_hat = nu[name] / (1 - (b2 * one) ** count)
        p.add_(-learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps)))
    return AdamState(count=count, mu=mu, nu=nu)


class MVRTrainer:
    """Single-device trainer (reference Trainer)."""

    def __init__(self, model: CombinedModel,
                 cfg: TrainerConfig = TrainerConfig(),
                 scheduler: Optional[TrainerScheduler] = None,
                 seed: int = 0, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.scheduler = scheduler or TrainerScheduler(
            init_n_rays=cfg.n_rays, init_lambda_rgb=cfg.lambda_rgb,
            init_lambda_freespace=cfg.lambda_freespace,
            init_lambda_occupied=cfg.lambda_occupied)
        self.generators = GeneratorChain(seed, device=self.device)
        self.log = get_logger()

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self) -> TrainState:
        """Zero Adam moments and the initial iso-point buffer (the
        parameters are the model's own, initialised at construction)."""
        zeros = {k: torch.zeros_like(p) for k, p in self.params().items()}
        points, mask = self.model.init_points(self.generators.next(),
                                              device=self.device)
        return TrainState(opt_state=AdamState(0, zeros, dict(zeros)),
                          points=points, points_mask=mask, it=0)

    def draw(self, n_rays: int, image_size: Tuple[int, int],
             batch_size: int, n_points: Optional[int] = None) -> StepDraws:
        """One step's random numbers; with `n_points` (the iso-point
        buffer's width) also the projected forward's."""
        g = self.generators.next()
        dev = self.device
        pixels = sample_random_pixels(g, n_rays, image_size, batch_size,
                                      device=dev)
        eik = torch.rand((1, self.cfg.n_eikonal_points, 3), generator=g,
                         device=dev) * 2.0 - 1.0
        u = torch.rand((self.model.raytrace_cfg.n_steps,), generator=g,
                       device=dev)
        proj = None
        if n_points is not None:
            m = self.model.ccfg.max_iso_per_batch
            proj = ProjectedDraws(
                sel_scores=torch.rand((1, n_points), generator=g, device=dev),
                iso_offset=torch.rand((1, m, 3), generator=g, device=dev),
                ray_uniform=torch.rand((batch_size, n_rays), generator=g,
                                       device=dev))
        return StepDraws(pixels, eik, u, proj)

    def train_step(self, state: TrainState, img: torch.Tensor,
                   mask_img: torch.Tensor, camera: PerspectiveCamera,
                   draws: Optional[StepDraws] = None
                   ) -> Tuple[TrainState, Dict[str, float]]:
        """One optimisation step (trainer.py:241-318): warm-up before
        `warm_up_iters`, projected from then on."""
        it = state.it
        hp_host = self.scheduler.at(it)
        project = it >= self.cfg.warm_up_iters
        points, points_mask = state.points, state.points_mask
        spacing = state.spacing
        if project and (it == self.cfg.warm_up_iters
                        or it % self.cfg.resample_every == 0):
            n_target = hp_host["n_points_dss"]
            self.log.info("stage: resample start it=%d n=%d iters=%d", it,
                          n_target, hp_host["proj_max_iters"])
            points, points_mask = self.resample_iso_points(
                n_target, proj_max_iters=hp_host["proj_max_iters"],
                proj_tolerance=hp_host["proj_tolerance"],
                init_points=state.points, init_mask=state.points_mask,
                subsample_u=None if draws is None else draws.resample_u)
            n_ok = int(torch.sum(points_mask))
            if n_ok < n_target // 4:
                # a collapsed resample starves the step of iso-points
                self.log.warning("resample yield LOW at it=%d: %d/%d valid",
                                 it, n_ok, n_target)
            self.log.info("stage: resample done it=%d (%d valid)", it, n_ok)
            spacing = None  # buffer replaced wholesale
        if spacing is not None and spacing.shape != points.shape[:2]:
            spacing = None  # capacity changed (e.g. first projected step)
        if project and spacing is None:
            spacing = splat_spacing(points, points_mask,
                                    self.model.raster_settings)

        hp = {k: float(hp_host[k]) for k in
              ("lambda_rgb", "lambda_freespace", "lambda_occupied",
               "sdf_alpha")}
        hp["lambda_eikonal"] = float(self.cfg.lambda_eikonal)
        if draws is None:
            draws = self.draw(hp_host["n_rays"], tuple(img.shape[1:3]),
                              img.shape[0],
                              n_points=points.shape[1] if project else None)
        total, metrics, new_pts, new_mask = compute_loss(
            self.model, points, points_mask, draws.pixels, img,
            mask_img, camera, draws.eikonal, draws.u_minsdf, hp,
            project=project, proj_draws=draws.projected, spacing=spacing)
        params = self.params()
        grads = dict(zip(params, torch.autograd.grad(total,
                                                     list(params.values()))))
        opt_state = clip_and_adam(params, grads, state.opt_state,
                                  self.cfg.learning_rate, self.cfg.grad_clip)
        names: List[str] = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        host = dict(zip(names, values.tolist()))   # one device->host copy
        # the cached spacing stays only while it matches the new buffer
        keep = spacing is not None and spacing.shape == new_pts.shape[:2]
        return (TrainState(opt_state=opt_state, points=new_pts,
                           points_mask=new_mask, it=it + 1,
                           spacing=spacing if keep else None), host)

    def resample_iso_points(self, n_points: int,
                            proj_max_iters: Optional[int] = None,
                            proj_tolerance: Optional[float] = None,
                            init_points: Optional[torch.Tensor] = None,
                            init_mask: Optional[torch.Tensor] = None,
                            subsample_u: Optional[torch.Tensor] = None):
        """A fresh uniform iso-point set seeded from the current cloud
        (trainer.py:416-460); the scheduler's projection iterations and
        tolerance override the model's. Returns (points, mask)."""
        if self.cfg.saliency_sampling:
            raise NotImplementedError(
                "saliency-weighted resampling is not ported yet (ROADMAP "
                "Queue 1 item 8)")
        g = self.generators.next()
        if (subsample_u is None and init_points is not None
                and init_points.shape[1] > n_points):
            subsample_u = torch.rand(init_points.shape[:2], generator=g,
                                     device=self.device)
        pcfg = dataclasses.replace(
            self.model.proj_cfg,
            proj_max_iters=proj_max_iters or self.model.proj_cfg.proj_max_iters,
            proj_tolerance=proj_tolerance or self.model.proj_cfg.proj_tolerance)
        res = sample_uniform_iso_points(
            self.model.trace_sdf_fn(), n_points, init_points, init_mask,
            subsample_u=subsample_u,
            bounding_sphere_radius=self.model.cfg.object_bounding_sphere,
            cfg=pcfg)
        return res.points, res.mask

    def check_state(self) -> bool:
        return check_weights(self.model)
