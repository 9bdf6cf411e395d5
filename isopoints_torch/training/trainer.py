"""MVR training step, warm-up phase (port of
isopoints_tpu/training/trainer.py:79-174, 177-318).

`compute_loss` assembles the photoconsistency L1, the freespace /
occupancy BCE and the eikonal loss exactly as the JAX version does with
one device (n_dev = 1). `MVRTrainer.train_step` replaces the jitted
shard_map step of isopoints_tpu/parallel/sharding.py:85-127 on a single
device: draw pixels, eikonal points and min-SDF step fractions, forward,
backward, then clip by global norm and Adam(b1=0.9, b2=0.99, eps=1e-8)
written out with optax's formulas (optax's clip divides by the norm
without the +1e-6 of `torch.nn.utils.clip_grad_norm_`). The update is
applied in place to the model's parameters.

The step takes an optional `draws` (StepDraws); without it the step draws
from its own generator chain. Tests pass the JAX step's draws to compare
the two packages on the same random numbers.
"""

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.logger import get_logger
from isopoints_torch.models.combined import CombinedModel
from isopoints_torch.ops.images import sample_random_pixels
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
    """Loss weights and the warm-up knobs of trainer.py:43-64 (the
    resampling and saliency knobs act only in the projected phase)."""
    lambda_rgb: float = 1.0
    lambda_freespace: float = 1.0
    lambda_occupied: float = 1.0
    lambda_eikonal: float = 0.01
    n_eikonal_points: int = 1024
    warm_up_iters: int = 500
    n_rays: int = 1024
    grad_clip: float = 1.0
    learning_rate: float = 1e-4


class StepDraws(NamedTuple):
    """The random numbers of one warm-up step."""
    pixels: torch.Tensor     # (B, n_rays, 2) NDC pixel samples
    eikonal: torch.Tensor    # (1, n_eikonal_points, 3) uniform in [-1, 1)
    u_minsdf: torch.Tensor   # (n_steps,) min-SDF step fractions in [0, 1)


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    opt_state: AdamState
    points: Optional[torch.Tensor]        # (1, P, 3) persistent iso-points
    points_mask: Optional[torch.Tensor]   # (1, P)
    it: int


def compute_loss(model: CombinedModel, points, points_mask,
                 ndc_pixels: torch.Tensor, img: torch.Tensor,
                 mask_img: torch.Tensor, camera: PerspectiveCamera,
                 eikonal_points: torch.Tensor, u_minsdf: torch.Tensor,
                 hp: Dict[str, float], project: bool, training: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                            Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Loss assembly (trainer.py:79-174 with n_dev = 1).
    Returns (total, metrics, new_points, new_points_mask)."""
    b, n_ray = ndc_pixels.shape[:2]
    out, new_pts, new_mask = model(ndc_pixels, img, mask_img, camera,
                                   u_minsdf, points=points,
                                   points_mask=points_mask, project=project,
                                   training=training)
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
    """Single-device warm-up trainer (reference Trainer)."""

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
             batch_size: int) -> StepDraws:
        g = self.generators.next()
        dev = self.device
        pixels = sample_random_pixels(g, n_rays, image_size, batch_size,
                                      device=dev)
        eik = torch.rand((1, self.cfg.n_eikonal_points, 3), generator=g,
                         device=dev) * 2.0 - 1.0
        u = torch.rand((self.model.raytrace_cfg.n_steps,), generator=g,
                       device=dev)
        return StepDraws(pixels, eik, u)

    def train_step(self, state: TrainState, img: torch.Tensor,
                   mask_img: torch.Tensor, camera: PerspectiveCamera,
                   draws: Optional[StepDraws] = None
                   ) -> Tuple[TrainState, Dict[str, float]]:
        """One warm-up optimisation step (trainer.py:241-318)."""
        it = state.it
        hp_host = self.scheduler.at(it)
        if it >= self.cfg.warm_up_iters:
            raise NotImplementedError(
                f"it={it} is past warm_up_iters={self.cfg.warm_up_iters}: the "
                "projected phase is not ported yet (ROADMAP 'Slices of the "
                "port' 3)")
        hp = {k: float(hp_host[k]) for k in
              ("lambda_rgb", "lambda_freespace", "lambda_occupied",
               "sdf_alpha")}
        hp["lambda_eikonal"] = float(self.cfg.lambda_eikonal)
        if draws is None:
            draws = self.draw(hp_host["n_rays"], tuple(img.shape[1:3]),
                              img.shape[0])
        total, metrics, new_pts, new_mask = compute_loss(
            self.model, state.points, state.points_mask, draws.pixels, img,
            mask_img, camera, draws.eikonal, draws.u_minsdf, hp,
            project=False)
        params = self.params()
        grads = dict(zip(params, torch.autograd.grad(total,
                                                     list(params.values()))))
        opt_state = clip_and_adam(params, grads, state.opt_state,
                                  self.cfg.learning_rate, self.cfg.grad_clip)
        names: List[str] = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        host = dict(zip(names, values.tolist()))   # one device->host copy
        return (TrainState(opt_state=opt_state, points=new_pts,
                           points_mask=new_mask, it=it + 1), host)

    def check_state(self) -> bool:
        return check_weights(self.model)
