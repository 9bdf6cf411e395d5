"""Level-set sampling: Newton projection, repulsion resampling, the
uniform resample (seeded, or bootstrapped from cube points through WLOP),
saliency-guided insertion, midpoint and edge-aware upsampling, and the
implicit-differentiation sample networks (port of
isopoints_tpu/models/levelset.py).

The projection and resampling run without autograd on the tracing SDF
(the fused CUDA MLP with `use_fused_mlp`), on full-width padded buffers
with masks as in the JAX package. The Newton loop's early exit is one
`any(active)` host synchronisation per iteration, the counterpart of the
JAX `lax.while_loop` condition.

`project_points_newton` carries the hybrid coarse/fine precision schedule.
`project_points` runs the repulsion resampling (the DTU workload's
refresh), then the saliency insertion, or the midpoint or edge-aware
upsampling back to the input's count. The random draws of the unseeded
bootstrap (its cube points and WLOP's jitter) are explicit tensors or come
from a `torch.Generator`.

With a `mesh` (parallel/sharding.py) of more than one rank, the Newton
projection splits the points over the ranks and all-gathers the result
(`_project_points_newton_sharded`); the callers pass the mesh down.

Frozen surface points are re-attached to the parameters θ with
`p0 − (f − sg f)·...`: the value is the frozen point, the θ-gradient is
the implicit one (paper Eq. 13 / IDR Eq. 3). `sg` is `.detach()`.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.points import bbox_diag, midpoint_upsample, wlop
from isopoints_torch.utils import (eps_denom, eps_sqrt, nanmedian_mid,
                                   num_valid, top_k)

SDFFn = Callable[[torch.Tensor], torch.Tensor]


class ProjectionResult(NamedTuple):
    points: torch.Tensor    # (B, P, 3)
    normals: torch.Tensor   # (B, P, 3) raw SDF gradients (not normalised)
    mask: torch.Tensor      # (B, P) converged & valid


@dataclass(frozen=True)
class ProjectionConfig:
    """The projection knobs (levelset.py:44-60); the last four are the
    edge-aware upsampling's."""
    proj_max_iters: int = 10
    proj_tolerance: float = 5e-5
    knn_k: int = 8
    sample_iters: int = 1
    sharpness_angle: float = 15.0
    edge_sensitivity: float = 1.0
    repulsion_mu: float = 0.5
    upsample_ratio: float = 1.5

    @property
    def sharpness_sigma(self) -> float:
        return 1.0 - math.cos(self.sharpness_angle / 180.0 * math.pi)


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


# ---------------------------------------------------------------------------
# Edge-aware upsampling (levelset.py:278-401)
# ---------------------------------------------------------------------------

def _unit_normals(sdf_fn: SDFFn, pts: torch.Tensor) -> torch.Tensor:
    """Unit SDF gradients; non-finite ones (a kink of the field) zero."""
    g = sdf_and_grad(sdf_fn, pts)[1]
    g = torch.where(torch.isfinite(g), g, 0.0)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-15)


@torch.no_grad()
def edge_aware_upsample(sdf_fn: SDFFn, points: torch.Tensor,
                        mask: torch.Tensor, target_capacity: int,
                        cfg: ProjectionConfig,
                        n_target: Optional[torch.Tensor] = None):
    """EAR upsampling (levelset.py:278-401): one kNN (k = cfg.knn_k, self
    excluded) for a bilateral denoise of the field's normals and a LOP move
    (point-to-plane data term and density repulsion, each clipped to the
    mean nearest-neighbour spacing); then rounds of edge-weighted midpoint
    insertion, priority (2 − ⟨n, nᵢ⟩)^edge_sensitivity · tangential
    clearance, the `capacity // 10` best a round into the next free slots,
    until every cloud holds `n_target` (default ceil(n·upsample_ratio),
    at most the capacity), a round inserts nothing, or 4·ceil(cap /
    max_new) + 4 rounds have run. The stop is read on the host once a
    round (the JAX `lax.while_loop` condition). Returns (points (B, cap,
    3), mask)."""
    b, p, _ = points.shape
    cap = target_capacity
    dev = points.device
    if n_target is None:
        n_target = torch.clamp(torch.ceil(num_valid(mask) * cfg.upsample_ratio)
                               .long(), max=cap)
    k = cfg.knn_k
    n_valid = num_valid(mask).float()
    inv_sigma = (n_valid / 2.0)[:, None, None]
    spatial_cut = 16.0 / torch.clamp(inv_sigma, min=1e-12)

    # --- LOP relaxation of the input points
    normals = _unit_normals(sdf_fn, points)
    res = knn_points(points, points, mask, mask, k=k, exclude_self=True)
    nn = knn_gather(points, res.idx)
    nn_norm = knn_gather(normals, res.idx)
    # bilateral denoise of the normals
    wn = torch.exp(-(((1.0 - torch.sum(nn_norm * normals[:, :, None, :], dim=-1))
                      / cfg.sharpness_sigma) ** 2))
    d2 = torch.sum((nn - points[:, :, None, :]) ** 2, dim=-1)
    wp = torch.where(d2 > spatial_cut, 0.0, torch.exp(-d2 * inv_sigma))
    w = torch.where(res.mask, wn * wp, 0.0)
    normals = torch.sum(nn_norm * w[..., None], dim=-2) / \
        eps_denom(torch.sum(w, dim=-1, keepdim=True), 1e-17)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                                    min=1e-15)
    move_clip = torch.sqrt(torch.clamp(
        torch.sum(torch.where(res.mask[..., 0], res.dists[..., 0], 0.0), dim=-1)
        / torch.clamp(n_valid, min=1.0), min=0.0))[:, None, None]
    pdiff = points[:, :, None, :] - nn
    cut = (res.dists > spatial_cut) | ~res.mask
    w_lop = torch.exp(-torch.sum(normals[:, :, None, :] * pdiff, dim=-1) ** 2
                      * inv_sigma)
    w_lop = torch.where(cut, 0.0, w_lop)
    sw = torch.where(cut, 0.0, torch.exp(-res.dists * inv_sigma))
    density = torch.sum(sw, dim=-1) + 1.0
    move_data = torch.sum(w_lop[..., None] * pdiff, dim=-2) / \
        eps_denom(torch.sum(w_lop, dim=-1, keepdim=True), 1e-17)
    move_repul = cfg.repulsion_mu * density[..., None] * \
        torch.sum(sw[..., None] * (-pdiff), dim=-2) / \
        eps_denom(torch.sum(sw, dim=-1, keepdim=True), 1e-17)

    def clip(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v / torch.clamp(n, min=1e-15) * torch.minimum(n, move_clip)

    points = torch.where(mask[..., None], points - clip(move_data) - clip(move_repul),
                         points)

    # --- edge-weighted midpoint insertion rounds, appending at slot `count`
    mask, points = _front_compact(mask, points)
    buf = torch.zeros((b, cap + 1, 3), dtype=points.dtype, device=dev)
    bmask = torch.zeros((b, cap + 1), dtype=torch.bool, device=dev)
    buf[:, :p] = points
    bmask[:, :p] = mask
    max_new = max(cap // 10, 1)
    max_rounds = 4 * -(-cap // max_new) + 4
    j = torch.arange(max_new, device=dev)[None, :]
    for _ in range(max_rounds):
        pts, m = buf[:, :cap], bmask[:, :cap]
        counts = num_valid(m)
        if not bool(torch.any(counts < n_target)):
            break
        nrm = _unit_normals(sdf_fn, pts)
        r = knn_points(pts, pts, m, m, k=k, exclude_self=True)
        knn_pts = knn_gather(pts, r.idx)
        knn_nrm = knn_gather(nrm, r.idx)
        mid = (knn_pts + 2.0 * pts[:, :, None, :]) / 3.0
        diff = mid[:, :, :, None, :] - knn_pts[:, :, None, :, :]    # (B,C,K,K,3)
        dot = (2.0 - torch.sum(nrm[:, :, None, :] * knn_nrm, dim=-1)) ** cfg.edge_sensitivity
        dist = torch.linalg.norm(diff, dim=-1)
        # less the normal component (the edge-aware tangential clearance)
        dist = dist - torch.sum((diff * knn_nrm[:, :, None, :, :]) ** 2, dim=-1)
        dist = torch.where(r.mask[:, :, None, :], dist, float("inf"))
        clearance = torch.sqrt(eps_sqrt(torch.amin(dist, dim=-1), 1e-17))
        clearance = torch.where(r.mask, clearance, float("-inf"))
        priority = dot * clearance
        sparsity = torch.amax(priority, dim=-1)
        father_nb = torch.argmax(priority, dim=-1)
        sparsity = torch.where(m & torch.isfinite(sparsity), sparsity, float("-inf"))
        chosen = torch.gather(
            mid, 2, father_nb[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]
        top_val, top_idx = top_k(sparsity, max_new)
        new_pts = torch.gather(chosen, 1, top_idx[..., None].expand(-1, -1, 3))
        top_ok = top_val > float("-inf")
        n_new = torch.minimum(torch.clamp(n_target - counts, max=max_new),
                              torch.sum(top_ok.long(), dim=-1))
        # the slot past the capacity takes every insert that is dropped
        slots = torch.where((j < n_new[:, None]) & top_ok, counts[:, None] + j, cap)
        buf = buf.scatter(1, slots[..., None].expand(-1, -1, 3), new_pts)
        bmask = bmask.scatter(1, slots, True)
        if int(num_valid(bmask[:, :cap]).sum()) == int(counts.sum()):
            break   # stalled: the round inserted nothing
    return buf[:, :cap], bmask[:, :cap]


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
                   edge_aware: bool = False,
                   ref_points: Optional[torch.Tensor] = None,
                   ref_metric: Optional[torch.Tensor] = None,
                   ref_mask: Optional[torch.Tensor] = None,
                   mesh=None) -> ProjectionResult:
    """Newton projection with the config's iterations and tolerance
    (levelset.py:408-455); with `skip_resampling=False` the repulsion
    resampling (`cfg.sample_iters` rounds); then, with
    `skip_upsampling=False`: with `ref_points`, the saliency insertion
    (children around the hot reference points, projected with 10
    iterations and appended into the free capacity); else the upsampling
    back to the input's valid count in the input's capacity, edge-aware
    (`edge_aware_upsample`) or by midpoints (`midpoint_upsample`, 31
    neighbours), followed by a 10-iteration projection."""
    proj = project_points_newton(sdf_fn, points, mask,
                                 max_iters=cfg.proj_max_iters,
                                 tolerance=cfg.proj_tolerance, mesh=mesh)
    if not skip_resampling:
        proj = resample_repulsion(sdf_fn, *proj, cfg, mesh=mesh)
    if skip_upsampling:
        return proj
    if ref_points is None:
        if edge_aware:
            up, m_up = edge_aware_upsample(sdf_fn, proj.points, proj.mask,
                                           points.shape[1], cfg,
                                           n_target=num_valid(mask))
        else:
            up, m_up = midpoint_upsample(proj.points, proj.mask, points.shape[1],
                                         n_target=num_valid(mask),
                                         neighborhood_size=31)
        return project_points_newton(sdf_fn, up, m_up, max_iters=10,
                                     tolerance=cfg.proj_tolerance, mesh=mesh)
    children, cmask = insert_around_salient(proj.points, proj.mask, ref_points,
                                            ref_metric, ref_mask)
    cproj = project_points_newton(sdf_fn, children, cmask, max_iters=10,
                                  tolerance=cfg.proj_tolerance, mesh=mesh)
    pts, valid, nrm = _append_into_capacity(proj.points, proj.mask,
                                            proj.normals, cproj.points,
                                            cproj.mask, cproj.normals)
    return ProjectionResult(pts, nrm, valid)


# ---------------------------------------------------------------------------
# Uniform resample (levelset.py:520-598)
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_uniform_iso_points(sdf_fn: SDFFn, n_points: int,
                              init_points: Optional[torch.Tensor],
                              init_mask: Optional[torch.Tensor] = None,
                              subsample_u: Optional[torch.Tensor] = None,
                              bounding_sphere_radius: float = 1.0,
                              cfg: ProjectionConfig = ProjectionConfig(),
                              mesh=None, cube_u: Optional[torch.Tensor] = None,
                              wlop_noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> ProjectionResult:
    """Uniform iso-point set. Seeded from the current cloud: project →
    repulsion (3 iterations when `cfg.sample_iters` is 0) → uniform random
    subsample when the seed is wider than `n_points` → midpoint-upsample
    to `n_points` → final projection. Unseeded (`init_points` None): 4·n
    points uniform in the cube of half-side `bounding_sphere_radius` →
    project → WLOP at ratio max(min(0.5, n/4n), 1e-3) → project (10
    iterations) → midpoint-upsample to n → final projection.

    The draws the JAX package takes from its key, each a tensor or else
    drawn from `generator` (on its device): `subsample_u`, uniform [0, 1)
    shaped like `init_mask`, ranks the valid seeds for the shrinking
    subsample; `cube_u`, uniform [0, 1) (1, 4n, 3), places the unseeded
    cube points; `wlop_noise`, standard normal, WLOP's jitter (see
    `ops.points.wlop`).
    """
    if init_points is None:
        if cube_u is None:
            if generator is None:
                raise ValueError("the unseeded bootstrap needs cube_u or a "
                                 "generator")
            cube_u = torch.rand((1, n_points * 4, 3), generator=generator,
                                device=generator.device)
        init_points = (cube_u - 0.5) * 2.0 * bounding_sphere_radius
        init_mask = None
        seeded = False
    else:
        seeded = True
    mask0 = (torch.ones(init_points.shape[:2], dtype=torch.bool,
                        device=init_points.device)
             if init_mask is None else init_mask)
    proj = project_points_newton(sdf_fn, init_points, mask0,
                                 max_iters=cfg.proj_max_iters,
                                 tolerance=cfg.proj_tolerance, mesh=mesh)
    inside = torch.linalg.norm(proj.points, dim=-1) < bounding_sphere_radius
    valid = proj.mask & inside
    if not seeded:
        ratio = max(min(0.5, n_points / init_points.shape[1]), 1e-3)
        x, x_mask = wlop(proj.points, valid, wlop_noise, ratio=ratio,
                         generator=generator)
        proj2 = project_points_newton(sdf_fn, x, x_mask, max_iters=10,
                                      tolerance=cfg.proj_tolerance, mesh=mesh)
        up, up_mask = midpoint_upsample(proj2.points, proj2.mask, n_points,
                                        neighborhood_size=16)
        return project_points_newton(sdf_fn, up, up_mask, max_iters=10,
                                     tolerance=cfg.proj_tolerance, mesh=mesh)
    rcfg = cfg if cfg.sample_iters > 0 else dataclasses.replace(cfg, sample_iters=3)
    pts, _, valid = resample_repulsion(sdf_fn, proj.points, proj.normals,
                                       valid, rcfg, mesh=mesh)
    if pts.shape[1] > n_points:
        if subsample_u is None:
            if generator is None:
                raise ValueError("a seed wider than n_points needs subsample_u "
                                 "or a generator")
            subsample_u = torch.rand(valid.shape, generator=generator,
                                     device=valid.device)
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
