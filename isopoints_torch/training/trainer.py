"""MVR training step (port of isopoints_tpu/training/trainer.py:79-174,
177-318, 321-460).

`compute_loss` assembles the photoconsistency L1, the freespace /
occupancy BCE and the eikonal loss as the JAX version does, normalised per
segment for a step sharded over `n_dev` ranks: sums over this rank's rays
divide by the local pixel count, sums over the replicated iso-points by the
global one. `MVRTrainer.train_step` runs the one step of
parallel/sharding.py `make_train_step` (the JAX `shard_map` step of
isopoints_tpu/parallel/sharding.py:53-140): draw the pixels, eikonal
points and the phase's other random numbers full width, forward and
backward on this rank's slice, average the gradients and metrics over the
ranks, then clip by global norm and Adam(b1=0.9, b2=0.99, eps=1e-8) written
out with optax's formulas (optax's clip divides by the norm without the
+1e-6 of `torch.nn.utils.clip_grad_norm_`). The update is applied in place
to the model's parameters. Without a process group (world size 1) the step
runs no collective. With `views_sharded` each rank passes its share of the
views and the step gathers them.

From `warm_up_iters` on, the step is projected: at `warm_up_iters` and
every `resample_every` iterations the persistent iso-points are resampled
from the current cloud (`resample_iso_points`), and the splat spacing of
the buffer is cached in `TrainState.spacing` until the buffer's shape
changes (trainer.py:248-314).

With `saliency_sampling` (the "lossS" arm), every projected step also
averages the per-point RGB residuals onto a reference cloud, seeded by
farthest point sampling of the first projected iso set, as a masked
running mean (`update_ref_metric`, no host read); each resample after the
first statistics inserts children around the reference points of high
residual (`levelset.insert_around_salient`), at the cost of one host read
of the gate.

The step takes an optional `draws` (StepDraws); without it the step draws
from its own generator chain. Tests pass the JAX step's draws to compare
the two packages on the same random numbers.

Evaluation on the validate cadence (trainer.py:463-529): `eval_step` scores
random rays of the pure IDR path, `eval_step_full` whole rendered images
(models/generator.py), `evaluate_mesh_vs_gt` the chamfer of the one-stage
mesh against GT samples (training/evaluation.py). Each takes a generator
from the chain where the JAX trainer takes a key, so the training draws
after an evaluation come in JAX's order.
"""

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.logger import get_logger
from isopoints_torch.models.combined import CombinedModel, ProjectedDraws
from isopoints_torch.models.levelset import (project_points,
                                             sample_uniform_iso_points)
from isopoints_torch.ops.images import sample_image_at_ndc, sample_random_pixels
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.sampling import farthest_point_sampling
from isopoints_torch.parallel.sharding import Mesh, make_train_step, replicate
from isopoints_torch.rendering.rasterizer import splat_spacing
from isopoints_torch.rng import GeneratorChain
from isopoints_torch.training.losses import (
    eikonal_loss,
    sdf_freespace_loss,
    sdf_occupancy_loss,
)
from isopoints_torch.training.scheduler import TrainerScheduler
from isopoints_torch.utils import check_weights, eps_denom
from isopoints_torch.utils.mathutils import local_coord_frames


@dataclass(frozen=True)
class TrainerConfig:
    """Loss weights and cadences of trainer.py:43-64. `saliency_sampling`
    turns on the insertion around salient reference points at each
    resample: `n_ref_points` is the reference cloud's size, and
    `saliency_mode` its metric, 'loss' (the running mean of the RGB
    residuals) or 'curvature' (the static surface variation λ0/λ2 of
    12-NN frames)."""
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
    n_ref_points: int = 2048
    saliency_mode: str = "loss"


_SALIENCY_KEYS = ("ref_points", "ref_mask", "ref_stat_mean", "ref_stat_n")


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
                 spacing: Optional[torch.Tensor] = None,
                 n_dev: int = 1, shard: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                            Optional[torch.Tensor], Optional[torch.Tensor],
                            Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Loss assembly (trainer.py:79-174) on rank `shard` of `n_dev`:
    `ndc_pixels` is this rank's slice of the rays, while `eikonal_points`
    and the projected draws' `ray_uniform` are full width and sliced here.
    The RGB term of the projected phase (over replicated iso-points) and the
    freespace set's iso-point rows divide by the global pixel count, the
    ray rows, the occupancy and the warm-up RGB by the local one, so that
    the mean of the ranks' losses is the global loss. Returns (total,
    metrics, new_points, new_points_mask, saliency): the last is the
    detached (iso_points, per-point RGB residual, iso_mask) that
    `MVRTrainer.update_ref_metric` takes."""
    b, n_ray = ndc_pixels.shape[:2]
    if proj_draws is not None:
        proj_draws = proj_draws._replace(
            ray_uniform=proj_draws.ray_uniform[:, shard * n_ray:(shard + 1) * n_ray])
    out, new_pts, new_mask = model(ndc_pixels, img, mask_img, camera,
                                   u_minsdf, points=points,
                                   points_mask=points_mask, project=project,
                                   training=training, draws=proj_draws,
                                   spacing=spacing)
    n_px_local = float(b * n_ray)
    n_px_global = n_px_local * n_dev

    rgb_diff = torch.sum(torch.abs(out.iso_rgb - out.iso_rgb_gt), dim=-1)
    loss_rgb = torch.sum(torch.where(out.iso_mask, rgb_diff,
                                     torch.zeros_like(rgb_diff))) / (
        n_px_global if project else n_px_local)
    alpha = hp["sdf_alpha"]
    free_elems = sdf_freespace_loss(out.sdf_freespace, alpha=alpha,
                                    mask=out.freespace_mask, reduction="none")
    # the freespace set is [n_ray ray rows | replicated iso-point rows]
    nf = free_elems.shape[1]
    w_free = torch.cat([
        torch.full((n_ray,), 1.0 / n_px_local, device=free_elems.device),
        torch.full((nf - n_ray,), 1.0 / n_px_global, device=free_elems.device)])
    loss_free = torch.sum(free_elems * w_free)
    loss_occ = sdf_occupancy_loss(out.sdf_occupancy, alpha=alpha,
                                  mask=out.occupancy_mask,
                                  reduction="sum") / n_px_local
    # eikonal: this rank's slice of the full-width uniform set
    n_eik = max(eikonal_points.shape[1] // n_dev, 1)
    loss_eik = eikonal_loss(model.normals_from_grad(
        eikonal_points[:, shard * n_eik:(shard + 1) * n_eik]))

    total = (hp["lambda_rgb"] * loss_rgb
             + hp["lambda_freespace"] * loss_free
             + hp["lambda_occupied"] * loss_occ
             + hp["lambda_eikonal"] * loss_eik)
    metrics = {"loss": total, "loss_rgb": loss_rgb,
               "loss_freespace": loss_free, "loss_occupied": loss_occ,
               "loss_eikonal": loss_eik,
               # counts over sharded sets are scaled so that the mean over
               # the ranks is the global count
               "n_iso": torch.sum(out.iso_mask) * (1 if project else n_dev),
               "overflow_trace": out.overflow_trace * n_dev,
               "overflow_sampler": out.overflow_sampler * n_dev}
    saliency = (out.iso_points.detach(), rgb_diff.detach(), out.iso_mask)
    return total, metrics, new_pts, new_mask, saliency


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
    """Host-side orchestration (reference Trainer) over `mesh`, the ranks
    of parallel/sharding.py (default: one, no process group). Under a
    process group the model's parameters are first taken from rank 0."""

    def __init__(self, model: CombinedModel,
                 cfg: TrainerConfig = TrainerConfig(),
                 scheduler: Optional[TrainerScheduler] = None,
                 seed: int = 0, device="cuda", mesh: Optional[Mesh] = None,
                 views_sharded: bool = False):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else Mesh()
        self.views_sharded = views_sharded
        self._steps = {}
        if model is not None:
            replicate(model, self.mesh)
        self.scheduler = scheduler or TrainerScheduler(
            init_n_rays=cfg.n_rays, init_lambda_rgb=cfg.lambda_rgb,
            init_lambda_freespace=cfg.lambda_freespace,
            init_lambda_occupied=cfg.lambda_occupied)
        self.generators = GeneratorChain(seed, device=self.device)
        self.log = get_logger()
        if cfg.saliency_mode not in ("loss", "curvature"):
            raise ValueError(f"unknown saliency_mode {cfg.saliency_mode!r}")
        # the saliency reference cloud: (1, R, 3) points, (1, R) mask, and
        # the running mean and count of its metric; None until seeded
        self.ref_points: Optional[torch.Tensor] = None
        self.ref_mask: Optional[torch.Tensor] = None
        self.ref_stat_mean: Optional[torch.Tensor] = None
        self.ref_stat_n: Optional[torch.Tensor] = None

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
             batch_size: int, n_points: Optional[int] = None,
             n_eikonal: Optional[int] = None) -> StepDraws:
        """One step's random numbers; with `n_points` (the iso-point
        buffer's width) also the projected forward's. `n_eikonal` defaults
        to the config's count."""
        g = self.generators.next()
        dev = self.device
        pixels = sample_random_pixels(g, n_rays, image_size, batch_size,
                                      device=dev)
        eik = torch.rand((1, n_eikonal or self.cfg.n_eikonal_points, 3),
                         generator=g, device=dev) * 2.0 - 1.0
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
        step = self.step_fn(project, hp_host["n_rays"])
        if draws is None:
            # full width: the batch of every rank's views, the rounded-up
            # ray and eikonal counts
            n_views = img.shape[0] * (self.mesh.size if self.views_sharded else 1)
            draws = self.draw(step.n_rays, tuple(img.shape[1:3]), n_views,
                              n_points=points.shape[1] if project else None,
                              n_eikonal=step.n_eikonal)
        opt_state, new_pts, new_mask, metrics, saliency = step(
            state.opt_state, points, points_mask, spacing, img, mask_img,
            camera, hp, draws)
        if self.cfg.saliency_sampling and project:
            self.update_ref_metric(*saliency)
        names: List[str] = list(metrics)
        values = torch.stack([metrics[k] for k in names])
        host = dict(zip(names, values.tolist()))   # one device->host copy
        # the cached spacing stays only while it matches the new buffer
        keep = spacing is not None and spacing.shape == new_pts.shape[:2]
        return (TrainState(opt_state=opt_state, points=new_pts,
                           points_mask=new_mask, it=it + 1,
                           spacing=spacing if keep else None), host)

    def step_fn(self, project: bool, n_rays: int):
        """The `make_train_step` step of this phase and ray count, built
        once (trainer.py:194-210)."""
        key = (project, n_rays)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self.mesh, project, n_rays,
                n_eikonal_points=self.cfg.n_eikonal_points,
                views_sharded=self.views_sharded,
                learning_rate=self.cfg.learning_rate,
                grad_clip=self.cfg.grad_clip)
        return self._steps[key]

    # ---- the saliency reference cloud (trainer.py:321-414)
    def saliency_state(self) -> Optional[Dict[str, np.ndarray]]:
        """The reference cloud and its statistics as numpy arrays, or None
        before seeding (trainer.py:321-332)."""
        if self.ref_points is None:
            return None
        return {k: getattr(self, k).cpu().numpy() for k in _SALIENCY_KEYS}

    def load_saliency_state(self, state) -> None:
        """Adopt a `saliency_state` on the trainer's device; raises
        ValueError when the four arrays' shapes disagree: ref_points
        (1, R, 3), the others (1, R)."""
        shapes = {k: tuple(np.shape(state[k])) for k in _SALIENCY_KEYS}
        ref = shapes["ref_points"]
        if len(ref) != 3 or ref[-1] != 3 or any(
                shapes[k] != ref[:2] for k in _SALIENCY_KEYS[1:]):
            raise ValueError(f"saliency state shapes disagree: {shapes}")
        dtypes = (torch.float32, torch.bool, torch.float32, torch.float32)
        for k, dt in zip(_SALIENCY_KEYS, dtypes):
            setattr(self, k, torch.tensor(np.asarray(state[k]), dtype=dt,
                                          device=self.device))

    def _seed_reference(self, points: torch.Tensor, mask: torch.Tensor) -> None:
        """The reference cloud: FPS of `points` (1, P, 3) under `mask`,
        min(n_ref_points, P) samples, zero statistics; the curvature
        metric in that mode."""
        idx, ok = farthest_point_sampling(
            points, min(self.cfg.n_ref_points, points.shape[1]), mask)
        self.ref_points = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
        self.ref_mask = ok
        self.ref_stat_mean = torch.zeros(ok.shape, device=points.device)
        self.ref_stat_n = torch.zeros(ok.shape, device=points.device)
        if self.cfg.saliency_mode == "curvature":
            self._seed_curvature_metric()

    def set_reference_cloud(self, points) -> None:
        """Seed the reference cloud by FPS of a ground-truth cloud (P, 3)
        (trainer.py:340-356); without one, `update_ref_metric` seeds it
        from the first projected iso set."""
        pts = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                              device=self.device)[None]
        self._seed_reference(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                             device=self.device))

    def _seed_curvature_metric(self) -> None:
        """The static metric of 'curvature' mode (trainer.py:358-374): per
        reference point λ0 / eps_denom(λ2, 1e-12) of the frame of its 12
        nearest reference points (itself included), count 1."""
        res = knn_points(self.ref_points, self.ref_points, self.ref_mask,
                         self.ref_mask, k=12)
        nn = knn_gather(self.ref_points, res.idx)
        evals, _ = local_coord_frames(self.ref_points, nn, res.mask)
        metric = evals[..., 0] / eps_denom(evals[..., -1], 1e-12)
        self.ref_stat_mean = torch.where(self.ref_mask, metric, 0.0)
        self.ref_stat_n = torch.ones_like(self.ref_stat_mean)

    @torch.no_grad()
    def update_ref_metric(self, iso_points: torch.Tensor,
                          rgb_losses: torch.Tensor,
                          iso_mask: torch.Tensor) -> None:
        """Average the per-point RGB residuals of one step onto the
        reference cloud (trainer.py:376-414): the mean over each reference
        point's 8 nearest iso-points of all views, folded into a masked
        running mean. Seeds the cloud on its first call. Device ops only."""
        if self.ref_points is None:
            self._seed_reference(iso_points[:1], iso_mask[:1])
        if self.cfg.saliency_mode == "curvature":
            return   # a static metric: nothing to accumulate
        flat_pts = iso_points.reshape(1, -1, 3)
        flat_loss = rgb_losses.reshape(1, -1, 1)
        res = knn_points(self.ref_points, flat_pts, self.ref_mask,
                         iso_mask.reshape(1, -1), k=8)
        vals = knn_gather(flat_loss, res.idx)[..., 0]
        w = torch.where(res.mask, 1.0, 0.0)
        w_sum = torch.sum(w, dim=-1)
        m = torch.sum(vals * w, dim=-1) / torch.clamp(w_sum, min=1.0)
        has = w_sum > 0
        n_new = self.ref_stat_n + has
        delta = torch.where(has, m - self.ref_stat_mean, 0.0)
        self.ref_stat_mean = self.ref_stat_mean + delta / torch.clamp(n_new, min=1.0)
        self.ref_stat_n = n_new

    def resample_iso_points(self, n_points: int,
                            proj_max_iters: Optional[int] = None,
                            proj_tolerance: Optional[float] = None,
                            init_points: Optional[torch.Tensor] = None,
                            init_mask: Optional[torch.Tensor] = None,
                            subsample_u: Optional[torch.Tensor] = None):
        """A fresh uniform iso-point set seeded from the current cloud
        (trainer.py:416-460); the scheduler's projection iterations and
        tolerance override the model's. With `saliency_sampling`, once the
        reference cloud holds statistics (one host read), children around
        its salient points are projected and appended. Returns (points,
        mask)."""
        g = self.generators.next()
        if (subsample_u is None and init_points is not None
                and init_points.shape[1] > n_points):
            subsample_u = torch.rand(init_points.shape[:2], generator=g,
                                     device=self.device)
        pcfg = dataclasses.replace(
            self.model.proj_cfg,
            proj_max_iters=proj_max_iters or self.model.proj_cfg.proj_max_iters,
            proj_tolerance=proj_tolerance or self.model.proj_cfg.proj_tolerance)
        f = self.model.trace_sdf_fn()
        res = sample_uniform_iso_points(
            f, n_points, init_points, init_mask, subsample_u=subsample_u,
            bounding_sphere_radius=self.model.cfg.object_bounding_sphere,
            cfg=pcfg, mesh=self.mesh)
        if (self.cfg.saliency_sampling and self.ref_points is not None
                and float(torch.max(self.ref_stat_n)) > 0):
            res = project_points(
                f, res.points, res.mask, pcfg, skip_resampling=True,
                skip_upsampling=False, ref_points=self.ref_points,
                ref_metric=self.ref_stat_mean,
                ref_mask=self.ref_mask & (self.ref_stat_n > 0), mesh=self.mesh)
        return res.points, res.mask

    # ---- evaluation (trainer.py:463-529)
    def eval_step(self, state: TrainState, img: torch.Tensor,
                  mask_img: torch.Tensor, camera: PerspectiveCamera,
                  n_rays: int = 4096, pixels: Optional[torch.Tensor] = None
                  ) -> Dict[str, float]:
        """Mask IoU, photometric MSE and PSNR on `n_rays` random rays a view
        of the pure IDR path with `training=False` (trainer.py:463-487).
        `pixels` (B, n_rays, 2) replaces the draw, which comes from the
        generator chain where JAX draws its key."""
        g = self.generators.next()
        if pixels is None:
            pixels = sample_random_pixels(g, n_rays, tuple(img.shape[1:3]),
                                          img.shape[0], device=self.device)
        with torch.no_grad():
            out, _, _ = self.model(pixels, img, mask_img, camera, None,
                                   points=state.points,
                                   points_mask=state.points_mask,
                                   project=False, training=False)
        gt_mask = sample_image_at_ndc(mask_img, pixels,
                                      mode="nearest")[..., 0] > 0.5
        pred = out.network_mask
        inter = torch.sum((pred & gt_mask).float())
        union = torch.sum((pred | gt_mask).float())
        iou = inter / torch.clamp(union, min=1.0)
        err = (out.iso_rgb - out.iso_rgb_gt) ** 2
        rgb_mse = torch.sum(torch.where(out.iso_mask[..., None], err, 0.0))
        rgb_mse = rgb_mse / torch.clamp(torch.sum(out.iso_mask) * 3, min=1)
        psnr = -10.0 * torch.log10(torch.clamp(rgb_mse, min=1e-10))
        iou, rgb_mse, psnr = torch.stack([iou, rgb_mse, psnr]).tolist()
        return {"iou": iou, "rgb_mse": rgb_mse, "psnr": psnr}

    def eval_step_full(self, state: TrainState, img: torch.Tensor,
                       mask_img: torch.Tensor, camera: PerspectiveCamera
                       ) -> Dict[str, float]:
        """Whole square images rendered by `Generator.raytrace_images`, with
        mask IoU, MSE and PSNR against the views (trainer.py:489-509)."""
        from isopoints_torch.models.generator import Generator, GeneratorConfig

        s = img.shape[1]
        assert img.shape[2] == s, "eval_step_full expects square images"
        gen = Generator(self.model, GeneratorConfig(image_size=s))
        self.generators.next()   # JAX draws the render's key here
        rgba = gen.raytrace_images(camera)                  # (B, s, s, 4)
        pred_mask = rgba[..., 3] > 0.5
        gt_mask = mask_img[..., 0].cpu().numpy() > 0.5
        inter = float(np.sum(pred_mask & gt_mask))
        union = float(np.sum(pred_mask | gt_mask))
        iou = inter / max(union, 1.0)
        mse = float(np.mean((rgba[..., :3] - img.cpu().numpy()) ** 2))
        psnr = -10.0 * math.log10(max(mse, 1e-10))
        return {"iou_full": iou, "psnr_full": psnr, "mse_full": mse}

    def evaluate_mesh_vs_gt(self, state: TrainState, gt_points: np.ndarray,
                            gt_normals: Optional[np.ndarray] = None,
                            resolution: int = 96) -> Dict[str, float]:
        """Chamfer of the one-stage mesh at `resolution` against GT surface
        samples (trainer.py:511-529); {"chamfer": inf} for an empty mesh."""
        from isopoints_torch.models.generator import Generator, GeneratorConfig
        from isopoints_torch.training.evaluation import evaluate_mesh

        gen = Generator(self.model, GeneratorConfig(mesh_resolution=resolution))
        verts, faces = gen.generate_mesh(two_stage=False)
        if len(verts) == 0:
            return {"chamfer": float("inf")}
        res = evaluate_mesh(verts, faces, gt_points, gt_normals,
                            n_samples=min(20_000, 4 * len(gt_points)),
                            device=self.device)
        out = {"chamfer": res["chamfer_p"]}
        if "chamfer_n" in res:
            out["chamfer_n"] = res["chamfer_n"]
        return out

    def check_state(self) -> bool:
        return check_weights(self.model)

    def debug_dump(self, out_dir: str, it: int, mesh=None) -> Optional[str]:
        """The captured per-point gradients as quiver plots (trainer.py:
        536-575): OUT_DIR/{it:010d}_grad_quiver.html, each tapped point set
        with its gradient cones (and `mesh`, a (verts, faces) pair, when
        given), and {it:010d}_mask_grad.html, the mask-image gradient pane,
        when that was tapped. None when debugging is off or nothing was
        captured; else the quiver's path (the pane's without point sets).
        The capture is cleared."""
        from isopoints_torch.debug import get_debugging_mode, get_debugging_tensor
        from isopoints_torch.misc.visualize import plot_2D_quiver, plot_3D_quiver

        dbg = get_debugging_tensor()
        if not get_debugging_mode() or (not dbg.pts_world
                                        and dbg.img_mask_grad is None):
            return None
        path = None
        if dbg.pts_world:
            path = os.path.join(out_dir, f"{it:010d}_grad_quiver.html")
            plot_3D_quiver(dbg.pts_world, dbg.pts_world_grad, path, mesh=mesh)
        if dbg.img_mask_grad is not None:
            g = dbg.img_mask_grad.detach().cpu().numpy()
            mpath = os.path.join(out_dir, f"{it:010d}_mask_grad.html")
            plot_2D_quiver(np.zeros((0, 2)), np.zeros((0, 2)),
                           np.zeros(g.shape[-3:-1] if g.ndim >= 3 else g.shape),
                           mpath, mask_grad_img=g)
            path = path or mpath
        dbg.clear()
        return path
