"""Level-set sampling: Newton projection, repulsion resampling, the
seeded uniform resample, and the implicit-differentiation sample
networks (port of isopoints_tpu/models/levelset.py:38-213, 408-455,
484-598).

The projection and resampling run without autograd on the tracing SDF
(the fused CUDA MLP with `use_fused_mlp`), on full-width padded buffers
with masks as in the JAX package. The Newton loop's early exit is one
`any(active)` host synchronisation per iteration, the counterpart of the
JAX `lax.while_loop` condition.

`project_points_newton` carries the hybrid coarse/fine precision schedule.
Not ported yet (ROADMAP Queue 1 item 8): the mesh-sharded projection,
saliency insertion, edge-aware upsampling, and the unseeded (WLOP)
bootstrap of `sample_uniform_iso_points`; those branches raise.

Frozen surface points are re-attached to the parameters θ with
`p0 − (f − sg f)·...`: the value is the frozen point, the θ-gradient is
the implicit one (paper Eq. 13 / IDR Eq. 3). `sg` is `.detach()`.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.points import bbox_diag, midpoint_upsample, num_valid
from isopoints_torch.utils import eps_denom

SDFFn = Callable[[torch.Tensor], torch.Tensor]

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 8)"


class ProjectionResult(NamedTuple):
    points: torch.Tensor    # (B, P, 3)
    normals: torch.Tensor   # (B, P, 3) raw SDF gradients (not normalised)
    mask: torch.Tensor      # (B, P) converged & valid


@dataclass(frozen=True)
class ProjectionConfig:
    """The projection knobs of levelset.py:44-55 that the ported branches
    read."""
    proj_max_iters: int = 10
    proj_tolerance: float = 5e-5
    knn_k: int = 8
    sample_iters: int = 1


# ---------------------------------------------------------------------------
# Newton projection (levelset.py:66-134)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _newton_loop(sdf_fn: SDFFn, points: torch.Tensor, mask: torch.Tensor,
                 max_iters: int, tolerance: float, step_clip: float):
    """Masked Newton iterations p ← p − f·∇f/|∇f|² (move norm-clamped to
    `step_clip`) while any valid point has |f| > tolerance."""
    pts = points
    sdf, grad = sdf_and_grad(sdf_fn, pts)
    for _ in range(max_iters):
        active = (torch.abs(sdf) > tolerance) & mask
        if not bool(torch.any(active)):
            break
        ssg = torch.sum(grad * grad, dim=-1, keepdim=True)
        move = sdf[..., None] * grad / eps_denom(ssg, 1e-17)
        mnorm = torch.linalg.norm(move, dim=-1, keepdim=True)
        move = move / torch.clamp(mnorm, min=1e-15) * torch.clamp(mnorm, max=step_clip)
        # non-finite moves (e.g. at a kink of the SDF) -> no-op
        move = torch.where(torch.isfinite(move), move, 0.0)
        pts = torch.where(active[..., None], pts - move, pts)
        sdf, grad = sdf_and_grad(sdf_fn, pts)
    return pts, sdf, grad


def project_points_newton(sdf_fn: SDFFn, points: torch.Tensor,
                          mask: torch.Tensor, max_iters: int = 10,
                          tolerance: float = 5e-5, step_clip: float = 0.1,
                          sdf_fn_coarse: Optional[SDFFn] = None,
                          coarse_iters: int = 0,
                          coarse_tolerance: float = 1e-3
                          ) -> ProjectionResult:
    """Project points onto the zero level set (levelset.py:92-134, without
    the mesh). Hybrid schedule: with `sdf_fn_coarse` and `coarse_iters`
    > 0, up to `coarse_iters` Newton steps run on the coarse fn to
    max(coarse_tolerance, tolerance), then the fine loop runs from there;
    the result's mask always comes from fine values."""
    if coarse_iters > 0 and sdf_fn_coarse is not None:
        points, _, _ = _newton_loop(sdf_fn_coarse, points, mask, coarse_iters,
                                    max(coarse_tolerance, tolerance),
                                    step_clip)
    pts, sdf, grad = _newton_loop(sdf_fn, points, mask, max_iters, tolerance,
                                  step_clip)
    valid = (torch.abs(sdf) <= tolerance) & mask
    return ProjectionResult(points=pts, normals=grad, mask=valid)


# ---------------------------------------------------------------------------
# Repulsion resampling (levelset.py:180-213)
# ---------------------------------------------------------------------------

@torch.no_grad()
def resample_repulsion(sdf_fn: SDFFn, points: torch.Tensor,
                       normals: torch.Tensor, mask: torch.Tensor,
                       cfg: ProjectionConfig) -> ProjectionResult:
    """Uniformise iso-points: a density-weighted tangential repulsion move
    followed by a 3-iteration re-projection, `sample_iters` times."""
    if cfg.sample_iters == 0:
        return ProjectionResult(points, normals, mask)
    diag = bbox_diag(points, mask)
    inv_sigma = (num_valid(mask).float() / eps_denom(diag, 1e-12))[:, None, None]
    pts, nrm, m = points, normals, mask
    valid = mask
    for _ in range(cfg.sample_iters):
        unit_n = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                   min=1e-15)
        res = knn_points(pts, pts, m, m, k=cfg.knn_k, exclude_self=True)
        nn = knn_gather(pts, res.idx)
        nn_n = knn_gather(unit_n, res.idx)
        diff = pts[:, :, None, :] - nn
        d2 = torch.sum(diff * diff, dim=-1)
        w = torch.where(res.mask, torch.exp(-d2 * inv_sigma), 0.0)
        density = torch.sum(w, dim=-1, keepdim=True) + 1.0
        # tangential component of the neighbour offsets
        diff_proj = diff - torch.sum(diff * nn_n, dim=-1, keepdim=True) * nn_n
        move = density * torch.sum(w[..., None] * diff_proj, dim=-2) / \
            eps_denom(torch.sum(w, dim=-1, keepdim=True), 1e-17)
        pts = torch.where(m[..., None], pts + move, pts)
        proj = project_points_newton(sdf_fn, pts, m, max_iters=3,
                                     tolerance=cfg.proj_tolerance)
        pts, nrm, valid = proj
    return ProjectionResult(pts, nrm, valid)


def project_points(sdf_fn: SDFFn, points: torch.Tensor, mask: torch.Tensor,
                   cfg: ProjectionConfig = ProjectionConfig(),
                   skip_resampling: bool = False,
                   skip_upsampling: bool = True) -> ProjectionResult:
    """Newton projection with the config's iterations and tolerance
    (levelset.py:408-455), the branch every caller of the training path
    takes (skip_resampling and skip_upsampling). The resampling and
    upsampling branches raise."""
    if not (skip_resampling and skip_upsampling):
        raise NotImplementedError(
            f"project_points' resampling and upsampling branches {_NOT_PORTED}")
    return project_points_newton(sdf_fn, points, mask,
                                 max_iters=cfg.proj_max_iters,
                                 tolerance=cfg.proj_tolerance)


# ---------------------------------------------------------------------------
# Seeded uniform resample (levelset.py:520-588)
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_uniform_iso_points(sdf_fn: SDFFn, n_points: int,
                              init_points: Optional[torch.Tensor],
                              init_mask: Optional[torch.Tensor] = None,
                              subsample_u: Optional[torch.Tensor] = None,
                              bounding_sphere_radius: float = 1.0,
                              cfg: ProjectionConfig = ProjectionConfig()
                              ) -> ProjectionResult:
    """Uniform iso-point set seeded from the current cloud: project →
    repulsion (3 iterations when `cfg.sample_iters` is 0) → uniform random
    subsample when the seed is wider than `n_points` → midpoint-upsample
    to `n_points` → final projection.

    `subsample_u`: uniform [0, 1) draws shaped like `init_mask`, which rank
    the valid seeds for the shrinking subsample (the JAX package draws them
    from its key's second half); needed only when the seed is wider.
    """
    if init_points is None:
        raise NotImplementedError(
            f"the unseeded (WLOP) bootstrap of sample_uniform_iso_points {_NOT_PORTED}")
    mask0 = (torch.ones(init_points.shape[:2], dtype=torch.bool,
                        device=init_points.device)
             if init_mask is None else init_mask)
    proj = project_points_newton(sdf_fn, init_points, mask0,
                                 max_iters=cfg.proj_max_iters,
                                 tolerance=cfg.proj_tolerance)
    inside = torch.linalg.norm(proj.points, dim=-1) < bounding_sphere_radius
    valid = proj.mask & inside
    rcfg = cfg if cfg.sample_iters > 0 else dataclasses.replace(cfg, sample_iters=3)
    pts, _, valid = resample_repulsion(sdf_fn, proj.points, proj.normals,
                                       valid, rcfg)
    if pts.shape[1] > n_points:
        if subsample_u is None:
            raise ValueError("a seed wider than n_points needs subsample_u")
        order = torch.argsort(torch.where(valid, subsample_u, 2.0), dim=-1,
                              stable=True)[:, :n_points]
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
        valid = torch.gather(valid, 1, order)
    up, up_mask = midpoint_upsample(pts, valid, n_points, neighborhood_size=16)
    return project_points_newton(sdf_fn, up, up_mask, max_iters=10,
                                 tolerance=cfg.proj_tolerance)


# ---------------------------------------------------------------------------
# Implicit-differentiation sample networks (levelset.py:484-513)
# ---------------------------------------------------------------------------

def _frozen_grad(sdf_fn: SDFFn, p0: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return sdf_and_grad(sdf_fn, p0)[1]


def sample_network(sdf_fn: SDFFn, iso_points: torch.Tensor) -> torch.Tensor:
    """Value == iso_points; d/dθ == −∇f/|∇f|² · ∂f/∂θ. `sdf_fn` must
    use the parameters being differentiated."""
    p0 = iso_points.detach()
    f = sdf_fn(p0)
    grad = _frozen_grad(sdf_fn, p0)
    ssg = torch.sum(grad * grad, dim=-1, keepdim=True)
    return p0 - (f - f.detach())[..., None] * grad / eps_denom(ssg, 1e-17)


def directional_sample_network(sdf_fn: SDFFn, iso_points: torch.Tensor,
                               rays: torch.Tensor,
                               cam_pos: torch.Tensor) -> torch.Tensor:
    """Differentiable depth along fixed rays:
    t(θ) = t0 − (f − sg f)/⟨sg ∇f, ray⟩; x = cam + t·ray."""
    p0 = iso_points.detach()
    f = sdf_fn(p0)
    grad = _frozen_grad(sdf_fn, p0)
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-15)
    ray0 = rays.detach()
    t0 = torch.linalg.norm(p0 - cam_pos, dim=-1, keepdim=True)
    dot = torch.sum(grad * ray0, dim=-1, keepdim=True)
    t = t0 - (f - f.detach())[..., None] / eps_denom(dot, 1e-10)
    return cam_pos + t * rays
