"""Level-set sampling: Newton projection, repulsion resampling, the
seeded uniform resample, saliency-guided insertion, and the
implicit-differentiation sample networks (port of
isopoints_tpu/models/levelset.py:38-213, 224-268, 408-478, 484-598).

The projection and resampling run without autograd on the tracing SDF
(the fused CUDA MLP with `use_fused_mlp`), on full-width padded buffers
with masks as in the JAX package. The Newton loop's early exit is one
`any(active)` host synchronisation per iteration, the counterpart of the
JAX `lax.while_loop` condition.

`project_points_newton` carries the hybrid coarse/fine precision schedule.
`project_points` runs the repulsion resampling (the DTU workload's
refresh) and the saliency insertion. Not ported, because no workload of
either package reaches them (ROADMAP Queue 1 item 14): `project_points`'
upsampling without a reference cloud (midpoint or edge-aware) and the
unseeded (WLOP) bootstrap of `sample_uniform_iso_points`; those branches
raise.

With a `mesh` (parallel/sharding.py) of more than one rank, the Newton
projection splits the points over the ranks and all-gathers the result
(`_project_points_newton_sharded`); the callers pass the mesh down.

Frozen surface points are re-attached to the parameters θ with
`p0 − (f − sg f)·...`: the value is the frozen point, the θ-gradient is
the implicit one (paper Eq. 13 / IDR Eq. 3). `sg` is `.detach()`.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.points import bbox_diag, midpoint_upsample, num_valid
from isopoints_torch.utils import eps_denom, nanmedian_mid, top_k

SDFFn = Callable[[torch.Tensor], torch.Tensor]

_NOT_PORTED = ("is not ported: no workload of either package reaches it "
               "(ROADMAP Queue 1 item 14)")


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
                          mesh=None, sdf_fn_coarse: Optional[SDFFn] = None,
                          coarse_iters: int = 0,
                          coarse_tolerance: float = 1e-3
                          ) -> ProjectionResult:
    """Project points onto the zero level set (levelset.py:92-134). Hybrid
    schedule: with `sdf_fn_coarse` and `coarse_iters` > 0, up to
    `coarse_iters` Newton steps run on the coarse fn to
    max(coarse_tolerance, tolerance), then the fine loop runs from there;
    the result's mask always comes from fine values. With a `mesh` of more
    than one rank the points are split over the ranks; each point's
    updates are masked, so the split changes no point's trajectory."""
    if mesh is not None and mesh.size > 1:
        return _project_points_newton_sharded(
            sdf_fn, points, mask, mesh, max_iters=max_iters,
            tolerance=tolerance, step_clip=step_clip,
            sdf_fn_coarse=sdf_fn_coarse, coarse_iters=coarse_iters,
            coarse_tolerance=coarse_tolerance)
    if coarse_iters > 0 and sdf_fn_coarse is not None:
        points, _, _ = _newton_loop(sdf_fn_coarse, points, mask, coarse_iters,
                                    max(coarse_tolerance, tolerance),
                                    step_clip)
    pts, sdf, grad = _newton_loop(sdf_fn, points, mask, max_iters, tolerance,
                                  step_clip)
    valid = (torch.abs(sdf) <= tolerance) & mask
    return ProjectionResult(points=pts, normals=grad, mask=valid)


def _project_points_newton_sharded(sdf_fn: SDFFn, points: torch.Tensor,
                                   mask: torch.Tensor, mesh, **kw
                                   ) -> ProjectionResult:
    """The point axis split over the ranks (levelset.py:137-174): the
    capacity padded to a multiple of the world size with masked points,
    each rank projecting its contiguous slice (its loop stops on its own
    points), the slices all-gathered in rank order and the padding cut."""
    b, p, _ = points.shape
    per = -(-p // mesh.size)
    pad = per * mesh.size - p
    if pad:
        points = torch.cat([points, points.new_zeros((b, pad, 3))], 1)
        mask = torch.cat([mask, mask.new_zeros((b, pad))], 1)
    lo = mesh.rank * per
    res = project_points_newton(sdf_fn, points[:, lo:lo + per].contiguous(),
                                mask[:, lo:lo + per].contiguous(), **kw)

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts, 1)[:, :p]
    return ProjectionResult(gather(res.points), gather(res.normals),
                            gather(res.mask.to(torch.uint8)).bool())


# ---------------------------------------------------------------------------
# Repulsion resampling (levelset.py:180-213)
# ---------------------------------------------------------------------------

@torch.no_grad()
def resample_repulsion(sdf_fn: SDFFn, points: torch.Tensor,
                       normals: torch.Tensor, mask: torch.Tensor,
                       cfg: ProjectionConfig, mesh=None) -> ProjectionResult:
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
                                     tolerance=cfg.proj_tolerance, mesh=mesh)
        pts, nrm, valid = proj
    return ProjectionResult(pts, nrm, valid)


# ---------------------------------------------------------------------------
# Saliency-guided insertion (levelset.py:224-268)
# ---------------------------------------------------------------------------

@torch.no_grad()
def insert_around_salient(points: torch.Tensor, mask: torch.Tensor,
                          ref_points: torch.Tensor, ref_metric: torch.Tensor,
                          ref_mask: torch.Tensor, patch_size: int = 8,
                          max_parents: int = 64):
    """Children 2·father/3 + mother/3 around the reference points of high
    metric. Hot reference points: metric above min(2·median, max/2), the
    hottest max(min(50, n_ref/20), 1) kept; fathers: the cloud's points
    within 2·avg_spacing of a hot one (the nearest `max_parents`); mothers:
    each father's `patch_size` nearest points of the cloud.

    As in the JAX package, a kept slot past the hot points holds the next
    valid reference point in index order (its metric, not the hot-masked
    one, decides the slot's validity).

    Returns (children (B, F·patch_size, 3), child_mask), F = min(max_parents,
    P)."""
    b, p, _ = points.shape
    n_ref = torch.clamp(num_valid(ref_mask).float(), min=1.0)
    avg_spacing = torch.sqrt(bbox_diag(points, mask) / n_ref)       # (B,)

    metric = torch.where(ref_mask, ref_metric, float("-inf"))
    med = nanmedian_mid(torch.where(ref_mask, ref_metric, float("nan")))
    thresh = torch.minimum(2.0 * med, 0.5 * torch.amax(metric, dim=-1))
    hot = metric > thresh[:, None]
    n_keep = torch.clamp(torch.clamp((n_ref / 20.0).int(), max=50), min=1)
    k_cap = min(50, ref_points.shape[1])
    _, hot_idx = top_k(torch.where(hot, metric, float("-inf")), k_cap)
    hot_sel = torch.gather(metric, 1, hot_idx) > float("-inf")
    hot_sel = hot_sel & (torch.arange(k_cap, device=points.device)[None]
                         < n_keep[:, None])
    hot_pts = torch.gather(ref_points, 1, hot_idx[..., None].expand(-1, -1, 3))

    res_ref = knn_points(points, hot_pts, mask, hot_sel, k=1)
    d_ref = res_ref.dists[..., 0]
    father = ((d_ref < 4.0 * (avg_spacing * avg_spacing)[:, None])
              & (d_ref > 0) & mask & res_ref.mask[..., 0])
    score = torch.where(father, -d_ref, float("-inf"))
    f_score, f_idx = top_k(score, min(max_parents, p))
    f_ok = f_score > float("-inf")
    f_pts = torch.gather(points, 1, f_idx[..., None].expand(-1, -1, 3))

    res_nn = knn_points(f_pts, points, f_ok, mask, k=patch_size)
    mothers = knn_gather(points, res_nn.idx)                     # (B,F,K,3)
    children = 2.0 * f_pts[:, :, None, :] / 3.0 + mothers / 3.0
    child_mask = f_ok[:, :, None] & res_nn.mask
    f = f_pts.shape[1]
    return (children.reshape(b, f * patch_size, 3),
            child_mask.reshape(b, f * patch_size))


def _front_compact(mask: torch.Tensor, *rows: torch.Tensor):
    """Valid entries first, in their order (a stable sort of ~mask)."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    return (torch.gather(mask, 1, order),) + tuple(
        torch.gather(r, 1, order[..., None].expand(-1, -1, r.shape[-1]))
        for r in rows)


def _append_into_capacity(pts, mask, nrm, new_pts, new_mask, new_nrm):
    """Both sides front-compacted, then the new valid entries written into
    the free slots from each cloud's count on; what does not fit is
    dropped (levelset.py:458-478). Returns (points, mask, normals)."""
    b, cap, _ = pts.shape
    mask, pts, nrm = _front_compact(mask, pts, nrm)
    new_mask, new_pts, new_nrm = _front_compact(new_mask, new_pts, new_nrm)
    counts = num_valid(mask)
    j = torch.arange(new_pts.shape[1], device=pts.device)[None, :]
    # the row past the capacity takes every entry that is dropped
    slots = torch.clamp(torch.where(new_mask, counts[:, None] + j, cap), max=cap)
    pad = lambda t, fill: torch.cat([t, torch.full_like(t[:, :1], fill)], 1)
    idx3 = slots[..., None].expand(-1, -1, 3)
    pts = pad(pts, 0.0).scatter(1, idx3, new_pts)[:, :cap]
    nrm = pad(nrm, 0.0).scatter(1, idx3, new_nrm)[:, :cap]
    mask = pad(mask, False).scatter(1, slots, True)[:, :cap]
    return pts, mask, nrm


def project_points(sdf_fn: SDFFn, points: torch.Tensor, mask: torch.Tensor,
                   cfg: ProjectionConfig = ProjectionConfig(),
                   skip_resampling: bool = False,
                   skip_upsampling: bool = True,
                   ref_points: Optional[torch.Tensor] = None,
                   ref_metric: Optional[torch.Tensor] = None,
                   ref_mask: Optional[torch.Tensor] = None,
                   mesh=None) -> ProjectionResult:
    """Newton projection with the config's iterations and tolerance
    (levelset.py:408-455); with `skip_resampling=False` the repulsion
    resampling (`cfg.sample_iters` rounds); then, with
    `skip_upsampling=False` and `ref_points`, the saliency insertion:
    children around the hot reference points, projected (10 iterations)
    and appended into the free capacity. The upsampling without
    `ref_points` raises (JAX's `edge_aware` option comes with it)."""
    if not skip_upsampling and ref_points is None:
        raise NotImplementedError(
            f"project_points' upsampling without a reference cloud (midpoint "
            f"or edge-aware) {_NOT_PORTED}")
    proj = project_points_newton(sdf_fn, points, mask,
                                 max_iters=cfg.proj_max_iters,
                                 tolerance=cfg.proj_tolerance, mesh=mesh)
    if not skip_resampling:
        proj = resample_repulsion(sdf_fn, *proj, cfg, mesh=mesh)
    if skip_upsampling:
        return proj
    children, cmask = insert_around_salient(proj.points, proj.mask, ref_points,
                                            ref_metric, ref_mask)
    cproj = project_points_newton(sdf_fn, children, cmask, max_iters=10,
                                  tolerance=cfg.proj_tolerance, mesh=mesh)
    pts, valid, nrm = _append_into_capacity(proj.points, proj.mask,
                                            proj.normals, cproj.points,
                                            cproj.mask, cproj.normals)
    return ProjectionResult(pts, nrm, valid)


# ---------------------------------------------------------------------------
# Seeded uniform resample (levelset.py:520-588)
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_uniform_iso_points(sdf_fn: SDFFn, n_points: int,
                              init_points: Optional[torch.Tensor],
                              init_mask: Optional[torch.Tensor] = None,
                              subsample_u: Optional[torch.Tensor] = None,
                              bounding_sphere_radius: float = 1.0,
                              cfg: ProjectionConfig = ProjectionConfig(),
                              mesh=None) -> ProjectionResult:
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
                                 tolerance=cfg.proj_tolerance, mesh=mesh)
    inside = torch.linalg.norm(proj.points, dim=-1) < bounding_sphere_radius
    valid = proj.mask & inside
    rcfg = cfg if cfg.sample_iters > 0 else dataclasses.replace(cfg, sample_iters=3)
    pts, _, valid = resample_repulsion(sdf_fn, proj.points, proj.normals,
                                       valid, rcfg, mesh=mesh)
    if pts.shape[1] > n_points:
        if subsample_u is None:
            raise ValueError("a seed wider than n_points needs subsample_u")
        order = torch.argsort(torch.where(valid, subsample_u, 2.0), dim=-1,
                              stable=True)[:, :n_points]
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
        valid = torch.gather(valid, 1, order)
    up, up_mask = midpoint_upsample(pts, valid, n_points, neighborhood_size=16)
    return project_points_newton(sdf_fn, up, up_mask, max_iters=10,
                                 tolerance=cfg.proj_tolerance, mesh=mesh)


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
