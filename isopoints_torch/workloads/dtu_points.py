"""Surface reconstruction from a noisy point cloud, the DTU workload (port of
isopoints_tpu/workloads/dtu_points.py).

A SIREN 3×256 (or the IGR 8×512 `sdf` field) is fitted to a noisy cloud:
warm-up steps on the surface and eikonal losses alone, then, from
`warm_up` on, persistent iso-points refreshed every `resample_every`
iterations (the previous set perturbed, Newton-projected and spread by
repulsion), the iso-points' own SDF and normal losses, the data reweighted
by the iso-points (bilateral, Laplacian or heat-kernel weights), and the
SAL distance to the iso-points off the surface; a two-stage mesh at the
end.

The order of operations and the random draws are the JAX package's. A
cloud without normals gets them from 16-NN frames: above `GRID_MIN` points
through the grid-bucketed radius search, below it through the kNN kernel.
The training step is plain PyTorch autograd with a double backward (the
eikonal term); neither package has a kernel for parameter gradients. The
refresh and the mesh evaluate the frozen field through
`ops/fused_mlp.make_fused_sdf_fn`, rebuilt at every refresh: the SIREN on
its kernel; the 8×512 `sdf` field, with its positional encoding, has no
kernel in either package and runs plain, without autograd of the
parameters. The kNN kernel runs the SAL
match, the radius searches of the weights and every kNN of a refresh.

Random numbers come from a `draws` object (`DTUDraws` by default, on the
generator chain of the device), which tests replace by one that replays
the JAX key chain.
"""

import math
import os
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isopoints_torch.logger import get_logger
from isopoints_torch.models.fields import SDFField, SirenField, sdf_and_grad
from isopoints_torch.models.levelset import ProjectionConfig, project_points
from isopoints_torch.ops.fused_mlp import make_fused_sdf_fn
from isopoints_torch.ops.knn import (GRID_MIN, dot3, knn_gather, knn_points,
                                     radius_search)
from isopoints_torch.ops.points import denoise_normals_bilateral
from isopoints_torch.rng import GeneratorChain
from isopoints_torch.training.trainer import AdamState, clip_and_adam
from isopoints_torch.utils import eps_denom, eps_sqrt, sqrt_rn
from isopoints_torch.utils.io import save_ply
from isopoints_torch.utils.mathutils import estimate_normals, pinverse
from isopoints_torch.utils.meshing import get_surface_high_res_mesh


# ---------------------------------------------------------------------------
# Iso-point data weights (dtu_points.py:45-108)
# ---------------------------------------------------------------------------

def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _avg_spacing(iso_points: torch.Tensor, iso_mask: torch.Tensor) -> torch.Tensor:
    """The iso-points' capacity over twice the largest valid radius, / 16."""
    dim = torch.amax(torch.where(iso_mask, torch.linalg.norm(iso_points, dim=-1),
                                 0.0)) * 2.0
    return iso_points.shape[1] / eps_denom(dim, 1e-12) / 16.0


def _ones_mask(iso_points: torch.Tensor) -> torch.Tensor:
    return torch.ones(iso_points.shape[:2], dtype=torch.bool,
                      device=iso_points.device)


@torch.no_grad()
def iso_bilateral_weights(points, normals, iso_points, iso_normals,
                          iso_mask=None, search_radius: float = 0.1):
    """Point-to-plane distance to the nearest iso-point within the radius
    times a normal term, exp(−((1 − cos)/(1 − cos 60°))²); 0 without an
    iso-point in range (dtu_points.py:45-65)."""
    if iso_mask is None:
        iso_mask = _ones_mask(iso_points)
    avg_spacing = _avg_spacing(iso_points, iso_mask)
    res = radius_search(points, iso_points, search_radius, points_mask=iso_mask,
                        k=1)
    nn = knn_gather(iso_points, res.idx)[:, :, 0]
    iso_n = knn_gather(_unit(iso_normals, 1e-12), res.idx)[:, :, 0]
    d_plane = torch.sum((nn - points) * iso_n, dim=-1) ** 2
    spatial_w = torch.exp(-d_plane * avg_spacing)
    cosd = 1.0 - math.cos(math.radians(60.0))
    normal_w = torch.exp(-((1.0 - torch.sum(_unit(normals, 1e-12) * iso_n, dim=-1))
                           / cosd) ** 2)
    return torch.where(res.mask[..., 0], spatial_w * normal_w, 0.0)


@torch.no_grad()
def laplacian_weights(points, normals, iso_points, iso_normals,
                      iso_mask=None, search_radius: float = 0.15):
    """Symmetric point-to-plane distance to the nearest iso-point,
    exp(−⟨p − q, n_p + n_q⟩²·avg_spacing) (dtu_points.py:68-83)."""
    if iso_mask is None:
        iso_mask = _ones_mask(iso_points)
    avg_spacing = _avg_spacing(iso_points, iso_mask)
    res = radius_search(points, iso_points, search_radius, points_mask=iso_mask,
                        k=1)
    nn = knn_gather(iso_points, res.idx)[:, :, 0]
    nn_n = knn_gather(iso_normals, res.idx)[:, :, 0]
    d = torch.sum((points - nn) * (normals + nn_n), dim=-1) ** 2
    return torch.where(res.mask[..., 0], torch.exp(-d * avg_spacing), 0.0)


@torch.no_grad()
def heat_kernel_weights(points, normals, iso_points, iso_normals,
                        iso_mask=None, neighborhood_size: int = 8,
                        sigma_p: float = 0.4, sigma_n: float = 0.7,
                        search_radius: float = 0.15):
    """Kernel regression on the features [p/σp, n/σn] of the iso-points
    within the radius: kᵀ K⁺ k with k the Gaussian kernel to each neighbour
    and K the neighbours' Gram matrix (`pinverse`), clipped above at 1
    (dtu_points.py:86-108)."""
    if iso_mask is None:
        iso_mask = _ones_mask(iso_points)
    res = radius_search(points, iso_points, search_radius, points_mask=iso_mask,
                        k=neighborhood_size)
    feats = torch.cat([points / sigma_p, _unit(normals, 1e-15) / sigma_n], -1)
    feats_iso = torch.cat([iso_points / sigma_p,
                           _unit(iso_normals, 1e-15) / sigma_n], -1)
    fnb = knn_gather(feats_iso, res.idx)                       # (B, P, K, 6)
    fd = torch.sum((feats[:, :, None, :] - fnb) ** 2, dim=-1)
    kern = torch.where(res.mask, torch.exp(-fd), 0.0)           # (B, P, K)
    fd_ij = torch.sum((fnb[:, :, :, None, :] - fnb[:, :, None, :, :]) ** 2, -1)
    km = torch.where(res.mask[:, :, :, None] & res.mask[:, :, None, :],
                     torch.exp(-fd_ij), 0.0)
    km_inv = pinverse(km.reshape(-1, *km.shape[-2:])).reshape(km.shape)
    w = torch.einsum("bpk,bpkl,bpl->bp", kern, km_inv, kern)
    return torch.clamp(w, max=1.0)


WEIGHT_FNS = {1: iso_bilateral_weights, 2: laplacian_weights,
              3: heat_kernel_weights}


# ---------------------------------------------------------------------------
# Config, decoder, draws
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DTUPointsConfig:
    """The workload's knobs (dtu_points.py:115-139)."""
    decoder_type: str = "siren"          # 'siren' (3x256) | 'sdf' (8x512)
    total_iters: int = 2000
    batch_size: int = 5000
    warm_up: int = 200
    resample_every: int = 500
    n_iso_points: int = 4000
    weight_mode: int = 1                 # -1 off, 1 bilateral, 2 laplacian, 3 heat
    ear: bool = False
    denoise_normal: bool = True
    use_sal_loss: bool = True
    use_off_normal_loss: bool = False
    lambda_surface_sdf: float = 1.0
    lambda_surface_normal: float = 0.1
    lambda_iso_sdf: float = 1e2
    lambda_iso_normal: float = 10.0
    lambda_eikonal: float = 1e2
    lambda_inter_sal: float = 1e2
    lambda_inter_sdf: float = 1e2
    learning_rate: float = 1e-4
    lr_milestones: Tuple[int, ...] = (1000, 1500)
    lr_gamma: float = 0.5
    mesh_resolution: int = 128


def make_decoder(cfg: DTUPointsConfig,
                 generator: Optional[torch.Generator] = None, device=None):
    """SIREN 3×256, or the IGR `SDFField(512, 8)` for `decoder_type="sdf"`."""
    if cfg.decoder_type == "siren":
        return SirenField(hidden_size=256, n_layers=3, generator=generator,
                          device=device)
    if cfg.decoder_type == "sdf":
        return SDFField(hidden_size=512, n_layers=8, generator=generator,
                        device=device)
    raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}")


def projection_config(cfg: DTUPointsConfig) -> ProjectionConfig:
    """The refresh's projection (dtu_points.py:197-199)."""
    return ProjectionConfig(proj_max_iters=10, proj_tolerance=1e-5, knn_k=16,
                            sample_iters=2 if cfg.ear else 5,
                            repulsion_mu=0.4, sharpness_angle=20.0)


def learning_rate(cfg: DTUPointsConfig, count: int) -> float:
    """optax.piecewise_constant_schedule at Adam's count before the
    update: scaled by `lr_gamma` from each milestone on."""
    lr = cfg.learning_rate
    for m in cfg.lr_milestones:
        if count >= m:
            lr *= cfg.lr_gamma
    return lr


class DTUStepDraws(NamedTuple):
    idx: torch.Tensor       # (batch,) indices of the surface batch
    space_u: torch.Tensor   # (1, batch // 2, 3) uniform in [-1, 1)
    space_n: torch.Tensor   # (1, batch // 2, 3) standard normal
    iso_idx: torch.Tensor   # (min(batch, capacity),) iso-point indices


class DTUDraws:
    """The workload's random numbers from a `GeneratorChain` on `device`:
    one generator for the iso-point seeds, one for each refresh's
    perturbation, one for each step."""

    def __init__(self, seed: int, device):
        self.chain = GeneratorChain(seed, device=device)
        self.device = torch.device(device)

    def iso_seed(self, p: int, n: int) -> torch.Tensor:
        """n indices into P points, without replacement when n <= P."""
        g = self.chain.next()
        if n > p:
            return torch.randint(0, p, (n,), generator=g, device=self.device)
        return torch.randperm(p, generator=g, device=self.device)[:n]

    def perturb(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.chain.next(), device=self.device)

    def step(self, batch: int, p: int, capacity: int) -> DTUStepDraws:
        g = self.chain.next()
        half = (1, batch // 2, 3)
        kw = dict(generator=g, device=self.device)
        return DTUStepDraws(
            idx=torch.randint(0, p, (batch,), **kw),
            space_u=torch.rand(half, **kw) * 2.0 - 1.0,
            space_n=torch.randn(half, **kw),
            iso_idx=torch.randint(0, capacity, (min(batch, capacity),), **kw))


# ---------------------------------------------------------------------------
# The pieces of a run
# ---------------------------------------------------------------------------

def tracing_sdf(decoder):
    """The callable the refresh and the mesh evaluate, both without
    autograd of the parameters: the fused kernel's (its plain version on
    CPU tensors) where `make_fused_sdf_fn` has one, else the plain field."""
    fused = make_fused_sdf_fn(decoder)
    return decoder.sdf if fused is None else fused


@torch.no_grad()
def data_normals(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unit normals of a (1, P, 3) cloud from its 16-NN frames, away from
    the origin (dtu_points.py:168-184): above `GRID_MIN` points the grid
    search with the radius sqrt(diag/P)·16 and 128 slots a cell, else the
    kNN."""
    p_total = points.shape[1]
    if p_total > GRID_MIN:
        ext = torch.amax(points[0], dim=0) - torch.amin(points[0], dim=0)
        diag = float(sqrt_rn(dot3(ext, ext)))
        r = math.sqrt(diag / p_total) * 16.0
        res = radius_search(points, points, r, mask, mask, k=16, method="grid",
                            max_per_cell=128)
    else:
        res = knn_points(points, points, mask, mask, k=16)
    nn = knn_gather(points, res.idx)
    return estimate_normals(points, nn, res.mask)


class IsoPoints(NamedTuple):
    points: torch.Tensor    # (1, C, 3)
    grads: torch.Tensor     # (1, C, 3) raw SDF gradients
    normals: torch.Tensor   # (1, C, 3) unit normals of 8-NN frames
    mask: torch.Tensor      # (1, C)


@torch.no_grad()
def refresh_iso(sdf_fn, iso_points: torch.Tensor, iso_mask: torch.Tensor,
                u: torch.Tensor, cfg: DTUPointsConfig) -> IsoPoints:
    """The iso-point refresh (dtu_points.py:202-216): the whole capacity
    perturbed by 0.1·(u − 0.5), projected with repulsion, normals from
    8-NN frames (self included), bilaterally denoised."""
    perturbed = iso_points + 0.1 * (u - 0.5)
    res = project_points(sdf_fn, perturbed, iso_mask, projection_config(cfg),
                         skip_resampling=False, skip_upsampling=True,
                         edge_aware=cfg.ear)
    nn_res = knn_points(res.points, res.points, res.mask, res.mask, k=8)
    nn = knn_gather(res.points, nn_res.idx)
    normals = estimate_normals(res.points, nn, nn_res.mask)
    if cfg.denoise_normal:
        normals = denoise_normals_bilateral(res.points, normals, res.mask)
    return IsoPoints(res.points, res.normals, normals, res.mask)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1) / torch.clamp(
        torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1), min=1e-12)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(mask, x, 0.0)) / torch.clamp(
        torch.sum(mask.float()), min=1.0)


def compute_losses(decoder, data: Tuple[torch.Tensor, torch.Tensor],
                   iso: IsoPoints, draws: DTUStepDraws, it: int, warm: bool,
                   cfg: DTUPointsConfig) -> Dict[str, torch.Tensor]:
    """The step's loss terms (dtu_points.py:222-315), in the JAX package's
    order, differentiable in the decoder's parameters."""
    pts, nrm = data
    surf = pts[0][draws.idx][None]
    surf_n = nrm[0][draws.idx][None]
    f = decoder.sdf
    surf_sdf, surf_grad = sdf_and_grad(f, surf)
    # space samples: the uniform cube ∪ N(surface, 0.1)
    sub = surf[:, :cfg.batch_size // 2]
    space = torch.cat([draws.space_u, sub + 0.1 * draws.space_n], dim=1)
    space_sdf, space_grad = sdf_and_grad(f, space)

    lam_s = 1e3 if warm else cfg.lambda_surface_sdf
    lam_n = 1e2 if warm else cfg.lambda_surface_normal
    losses = {}
    eik = (torch.mean((torch.linalg.norm(surf_grad, dim=-1) - 1.0) ** 2)
           + torch.mean((torch.linalg.norm(space_grad, dim=-1) - 1.0) ** 2))
    losses["eikonal"] = eik * cfg.lambda_eikonal

    if warm or cfg.weight_mode == -1:
        weights = torch.ones_like(surf_sdf)
    else:
        weights = WEIGHT_FNS[cfg.weight_mode](surf, surf_n, iso.points,
                                              iso.grads, iso.mask)
    n_surf = float(cfg.batch_size)
    n_iso = float(iso.points.shape[1])
    share = n_surf / (n_surf + n_iso) if not warm else 1.0
    losses["sdf"] = torch.mean(weights * torch.abs(surf_sdf)) * lam_s * share
    losses["normals"] = torch.mean(weights * (1.0 - _cos(surf_n, surf_grad))) \
        * lam_n * share

    if not warm:
        iso_share = n_iso / (n_iso + 8000.0)
        iso_s = iso.points[0][draws.iso_idx][None]
        iso_ns = iso.normals[0][draws.iso_idx][None]
        iso_ms = iso.mask[0][draws.iso_idx][None]
        iso_sdf, iso_gs = sdf_and_grad(f, iso_s)
        losses["sdf_iso"] = _masked_mean(torch.abs(iso_sdf), iso_ms) \
            * cfg.lambda_iso_sdf * iso_share
        losses["normal_iso"] = _masked_mean(1.0 - torch.abs(_cos(iso_ns, iso_gs)),
                                            iso_ms) \
            * cfg.lambda_iso_normal * iso_share

    if cfg.use_sal_loss and not warm:
        d = knn_points(space, iso.points, None, iso.mask, k=1).dists[..., 0]
        losses["inter"] = torch.mean(
            (torch.sqrt(eps_sqrt(d)) - torch.abs(space_sdf)) ** 2) \
            * cfg.lambda_inter_sal
    else:
        it_f = torch.tensor(float(it), dtype=torch.float32, device=pts.device)
        alpha = (it_f / cfg.total_iters + 1.0) * 100.0
        losses["inter"] = torch.mean(torch.exp(-alpha * torch.abs(space_sdf))) \
            * cfg.lambda_inter_sdf

    if cfg.use_off_normal_loss:
        # SALD off-normal for open surfaces
        dres = knn_points(space, surf, k=1)
        knn_n = knn_gather(surf_n, dres.idx)[:, :, 0]
        dc = torch.clamp(-_cos(knn_n, space_grad), min=0.0)
        losses["sald"] = torch.mean(dc * torch.exp(-2.0 * dres.dists[..., 0])) * 2.0
    return losses


def train_step(decoder, opt_state: AdamState,
               data: Tuple[torch.Tensor, torch.Tensor], iso: IsoPoints,
               draws: DTUStepDraws, it: int, warm: bool,
               cfg: DTUPointsConfig
               ) -> Tuple[AdamState, torch.Tensor, Dict[str, torch.Tensor]]:
    """One step: the losses, their parameter gradients, then
    clip_by_global_norm(1.0) and Adam with optax's defaults (b2 0.999) at
    the schedule's rate. Updates the decoder in place; returns (the new
    Adam state, the total, the terms), detached."""
    losses = compute_losses(decoder, data, iso, draws, it, warm, cfg)
    total = sum(losses.values())
    params = dict(decoder.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    opt_state = clip_and_adam(params, dict(zip(params, grads)), opt_state,
                              learning_rate(cfg, opt_state.count), 1.0,
                              b2=0.999)
    return (opt_state, total.detach(),
            {k: v.detach() for k, v in losses.items()})


def init_adam(decoder) -> AdamState:
    zeros = {k: torch.zeros_like(p) for k, p in decoder.named_parameters()}
    return AdamState(0, zeros, {k: v.clone() for k, v in zeros.items()})


def is_refresh(it: int, cfg: DTUPointsConfig) -> bool:
    """A refresh at `warm_up` and every `resample_every` after it."""
    return it >= cfg.warm_up and (
        it == cfg.warm_up or (cfg.resample_every > 0
                              and (it - cfg.warm_up) % cfg.resample_every == 0))


def fit_point_cloud(points: np.ndarray, normals: Optional[np.ndarray],
                    cfg: DTUPointsConfig = DTUPointsConfig(), seed: int = 0,
                    out_dir: Optional[str] = None, log_every: int = 100,
                    denormalize: Optional[Tuple[np.ndarray, float]] = None,
                    device="cuda", draws=None, decoder=None):
    """Run the workload (dtu_points.py:149-371).

    points: (P, 3), normalised to about the unit box; normals (P, 3) or
    None (estimated). `draws` replaces the default `DTUDraws(seed,
    device)`; `decoder` replaces `make_decoder(cfg)` seeded by `seed`.
    With `out_dir`: `{it:010d}_iso.ply` at each refresh (raw gradients as
    normals) and `final.ply`, the mesh at `mesh_resolution`, its vertices
    mapped back by `denormalize` = (center, scale). Returns (decoder, info)
    with info's `history` [(it, total, terms)] every `log_every`,
    `iso_points`, `iso_mask`, `mesh` (with `out_dir`), and the run's last
    state: `iso` (IsoPoints), `opt_state`, `data` (points, normals)."""
    log = get_logger()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_point_cloud: no CUDA device; pass device='cpu' "
                           "to run on the CPU")
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None]
    p_total = pts.shape[1]
    mask = torch.ones((1, p_total), dtype=torch.bool, device=dev)
    if normals is None:
        nrm = data_normals(pts, mask)
    else:
        nrm = torch.as_tensor(np.asarray(normals, np.float32), device=dev)[None]
    data = (pts, nrm)

    if draws is None:
        draws = DTUDraws(seed, dev)
    if decoder is None:
        decoder = make_decoder(cfg, torch.Generator(device=dev).manual_seed(seed),
                               dev)
    opt_state = init_adam(decoder)

    cap = cfg.n_iso_points
    sel = draws.iso_seed(p_total, cap)
    iso_pts = pts[0][sel][None]
    zeros = torch.zeros_like(iso_pts)
    iso = IsoPoints(iso_pts, zeros, zeros, torch.ones((1, cap), dtype=torch.bool,
                                                      device=dev))
    history = []
    for it in range(cfg.total_iters):
        warm = it < cfg.warm_up
        if is_refresh(it, cfg):
            iso = refresh_iso(tracing_sdf(decoder), iso.points, iso.mask,
                              draws.perturb(iso.points.shape), cfg)
            if out_dir is not None:
                m = iso.mask[0].cpu().numpy()
                save_ply(os.path.join(out_dir, f"{it:010d}_iso.ply"),
                         iso.points[0].cpu().numpy()[m],
                         normals=iso.grads[0].cpu().numpy()[m])
        opt_state, total, losses = train_step(
            decoder, opt_state, data, iso, draws.step(cfg.batch_size, p_total, cap),
            it, warm, cfg)
        if it % log_every == 0:
            vals = {k: float(v) for k, v in losses.items()}
            history.append((it, float(total), vals))
            log.info("iter %05d loss=%.4f %s", it, float(total),
                     " ".join(f"{k}={v:.4g}" for k, v in vals.items()))

    info = {"history": history, "iso_points": iso.points.cpu().numpy(),
            "iso_mask": iso.mask.cpu().numpy(), "iso": iso,
            "opt_state": opt_state, "data": data}
    if out_dir is not None:
        with torch.no_grad():
            verts, faces = get_surface_high_res_mesh(
                tracing_sdf(decoder), resolution=cfg.mesh_resolution, device=dev)
        if denormalize is not None and len(verts):
            # undo normalize_to_box (the reference's scale_mat_inv at export)
            center, scale = denormalize
            verts = verts * float(scale) + np.asarray(center).reshape(1, 3)
        save_ply(os.path.join(out_dir, "final.ply"), verts, faces=faces)
        info["mesh"] = (verts, faces)
    return decoder, info
