"""Differentiable EWA surface-splatting rasterizer (port of
isopoints_tpu/rendering/rasterizer.py).

Per-point EWA splat setup (`compute_splat_params`: isotropic, global and
anisotropic Vrk) and the tiled forward rasterization: per tile, the front-most
candidate splats (coarse stage, rendering/select.py), then per pixel the
K nearest by depth with the depth-merging cut (fine stage,
rendering/splat.py). With `use_pallas` the two stages run as the CUDA
kernels on CUDA tensors (`use_pallas_selection=False` keeps the plain
selection), as the JAX switches run the Pallas kernels; without it the
plain versions of both stages run, the counterpart of the JAX XLA path.

`rasterize_splats` is a `torch.autograd.Function` when a gradient is
needed (the JAX package's custom VJP, :582-692): gradients reach only
`pts_ndc`. Its z part is the zbuf cotangent summed per tile into the fine
stage's candidate slots and added to the candidates' points
(rendering/splat.py `zbuf_backward_points`, one kernel with `use_pallas`);
its xy part is the DSS occupancy
backward (rendering/occ_bwd.py; `use_pallas_backward`). Without a
gradient it runs the forward alone and keeps nothing for a backward: the
combined model's visibility rasters stay graph-free. `visible_point_mask`
marks the points a fragment map shows.
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.rendering.occ_bwd import occ_backward, occ_backward_plain
from isopoints_torch.rendering.select import (select_candidates,
                                              select_candidates_plain)
from isopoints_torch.rendering.splat import (rasterize_fine,
                                             rasterize_fine_plain,
                                             zbuf_backward_points,
                                             zbuf_backward_points_plain)
from isopoints_torch.utils import eps_denom, eps_sqrt
from isopoints_torch.utils.mathutils import local_coord_frames


@dataclass(frozen=True)
class RasterizationSettings:
    """The JAX RasterizationSettings (rasterizer.py:56-96).
    `use_pallas_backward`: None runs the occupancy backward's kernel on
    CUDA tensors and its plain version on CPU ones; False the plain version
    on either. The zbuf backward's tile route and the kNN of the splat
    spacing follow `use_pallas`."""
    image_size: int = 256
    points_per_pixel: int = 5
    cutoff_threshold: float = 1.0
    depth_merging_threshold: float = 0.05
    Vrk_invariant: bool = False
    Vrk_isotropic: bool = True
    radii_backward_scaler: float = 10.0
    backward_patch_pixels: int = 64
    antialiasing_sigma: float = 1.0
    backface_culling: bool = True
    clip_pts_grad: float = -1.0
    tile_size: int = 16
    max_points_per_tile: int = 256
    max_points_per_strip: int = 2048
    knn_k: int = 7
    use_pallas: bool = False
    use_pallas_selection: Optional[bool] = None
    use_pallas_backward: Optional[bool] = None


class Fragments(NamedTuple):
    idx: torch.Tensor          # (B, S, S, K) int64, -1 empty
    zbuf: torch.Tensor         # (B, S, S, K) view depth, -1 empty
    qvalue: torch.Tensor       # (B, S, S, K) conic value, -1 empty
    occupancy: torch.Tensor    # (B, S, S) 0/1
    visibility: torch.Tensor   # (B, P) points that produced fragments
    tile_overflow: torch.Tensor  # (B,) candidates dropped by the capacities


class SplatParams(NamedTuple):
    pts_ndc: torch.Tensor   # (B, P, 3) [x_ndc, y_ndc, view depth]
    ellipse: torch.Tensor   # (B, P, 3) conic (a, b, c)
    radii: torch.Tensor     # (B, P, 2) axis-aligned NDC radii
    cutoff: torch.Tensor    # (B, P)
    scaler: torch.Tensor    # (B, P) EWA normalisation
    mask: torch.Tensor      # (B, P) renderable after depth/backface filters


def _tangent_basis(normals: torch.Tensor) -> torch.Tensor:
    """Deterministic orthonormal (u0, u1) ⊥ n, stacked (..., 2, 3)
    (rasterizer.py:125-139)."""
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                              min=1e-12)
    ez = torch.tensor([0.0, 0.0, 1.0], device=n.device).expand(n.shape)
    ex = torch.tensor([1.0, 0.0, 0.0], device=n.device).expand(n.shape)
    a = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    u0 = torch.linalg.cross(n, a)
    u0 = u0 / torch.clamp(torch.linalg.norm(u0, dim=-1, keepdim=True), min=1e-12)
    u1 = torch.linalg.cross(n, u0)
    return torch.stack([u0, u1], dim=-2)


def _spacing_knn(points: torch.Tensor, mask: torch.Tensor,
                 s: RasterizationSettings):
    """The knn_k − 1 nearest others of each point (the reference's K = 7
    with self); the kernel on CUDA tensors with `use_pallas`."""
    return knn_points(points, points, mask, mask, k=max(s.knn_k - 1, 1),
                      exclude_self=True, method="auto" if s.use_pallas else "dense")


@torch.no_grad()
def splat_spacing(points: torch.Tensor, mask: torch.Tensor,
                  settings: RasterizationSettings) -> torch.Tensor:
    """Per-point splat spacing h_k = ½·max squared distance to the
    knn_k − 1 nearest others (rasterizer.py:142-161); 5e-4 for clouds with
    fewer than knn_k points. The kNN is the kernel's on CUDA tensors with
    `use_pallas`, else its plain version."""
    s = settings
    res = _spacing_knn(points, mask, s)
    sq = torch.where(res.mask, res.dists, 0.0)
    h_k = 0.5 * torch.amax(sq, dim=-1)
    enough = torch.sum(mask.long(), dim=-1, keepdim=True) >= s.knn_k
    return torch.where(enough, h_k, 5e-4)


def compute_splat_params(points: torch.Tensor, normals: torch.Tensor,
                         mask: torch.Tensor, camera: PerspectiveCamera,
                         settings: RasterizationSettings,
                         cutoff_scale: Optional[torch.Tensor] = None,
                         spacing: Optional[torch.Tensor] = None) -> SplatParams:
    """Per-point EWA parameters and the depth/backface filters
    (rasterizer.py:164-280); the depth filter keeps view depths in
    [camera.znear, camera.zfar]. Vrk: isotropic (h_k from the spacing on the
    tangent plane), global (`Vrk_invariant`: the renderable points' mean
    h_k), or anisotropic (`Vrk_isotropic=False`: the two tangent axes of
    `local_coord_frames` on the knn_k − 1 nearest others, scaled by their
    eigenvalues, Sk the same axes; :220-230). `cutoff_scale`: a global
    splat-size scale on the cutoff, entering detached (:267-270).
    `spacing`: a precomputed `splat_spacing` (B, P) or (1, P), else it is
    computed here (the anisotropic Vrk reads its kNN and no spacing).
    Everything but `pts_ndc` is detached, as in the JAX package."""
    s = settings
    anisotropic = not (s.Vrk_isotropic or s.Vrk_invariant)
    b, p, _ = points.shape
    view = camera.world_to_view(points)
    z = view[..., 2]
    rmask = mask & (z >= camera.znear) & (z <= camera.zfar)
    if s.backface_culling:
        normals_view = torch.einsum("bpi,bij->bpj", normals, camera.R)
        rmask = rmask & (normals_view[..., 2] < 0)
    pts_ndc = camera.project_ndc(points)

    with torch.no_grad():
        if anisotropic:
            # curvature-scaled tangent variance (rasterizer.py:220-230)
            points_d = points.detach()
            res = _spacing_knn(points_d, mask, s)
            evals, frames = local_coord_frames(
                points_d, knn_gather(points_d, res.idx), res.mask)
            tang = frames[..., 1:]                      # (B, P, 3, 2), ascending
            Vrk = torch.einsum("bpik,bpk,bpjk->bpij", tang, evals[..., 1:], tang)
            Sk = tang.transpose(-1, -2)                 # (B, P, 2, 3)
        else:
            if spacing is None:
                spacing = splat_spacing(points.detach(), mask, s)
            h_k = torch.broadcast_to(spacing.detach(), (b, p))
            if s.Vrk_invariant:
                denom = torch.clamp(torch.sum(rmask.long(), dim=-1, keepdim=True),
                                    min=1)
                h_k = torch.sum(torch.where(rmask, h_k, 0.0), dim=-1,
                                keepdim=True) / denom
                h_k = torch.clamp(h_k, 5e-5, 1e-3) * torch.ones_like(z)
            else:
                h_k = torch.clamp(h_k, 5e-5, 0.01)
            Sk = _tangent_basis(normals.detach())                   # (B, P, 2, 3)
            Vrk = h_k[..., None, None] * torch.einsum("bpki,bpkj->bpij", Sk, Sk)

        # projection Jacobian Mk = d ndc_xy / d p_world (rasterizer.py:232-248)
        view_d = view.detach()
        zd = eps_denom(view_d[..., 2], 1e-10)
        fl = camera.focal_length[:, None, :]
        j00 = fl[..., 0] / zd
        j11 = fl[..., 1] / zd
        j20 = -fl[..., 0] * view_d[..., 0] / (zd * zd)
        j21 = -fl[..., 1] * view_d[..., 1] / (zd * zd)
        zero = torch.zeros_like(j00)
        Jv = torch.stack([torch.stack([j00, zero], -1),
                          torch.stack([zero, j11], -1),
                          torch.stack([j20, j21], -1)], dim=-2)      # (B, P, 3, 2)
        Mk = torch.einsum("bij,bpjk->bpik", camera.R, Jv)

        # screen variance GV = Mkᵀ Vrk Mk + σ_aa·I·px² (rasterizer.py:250-262)
        Vk = torch.einsum("bpij,bpik,bpkl->bpjl", Mk, Vrk, Mk)
        pixel_size = 2.0 / s.image_size
        GV = Vk + s.antialiasing_sigma * (pixel_size ** 2) * torch.eye(
            2, device=points.device)
        detMk = torch.linalg.det(torch.einsum("bpki,bpij->bpkj", Sk, Mk))
        detGV = GV[..., 0, 0] * GV[..., 1, 1] - GV[..., 0, 1] * GV[..., 1, 0]
        inv_det = 1.0 / eps_denom(detGV, 1e-12)
        ellipse = torch.stack([GV[..., 1, 1] * inv_det,
                               -GV[..., 0, 1] * inv_det - GV[..., 1, 0] * inv_det,
                               GV[..., 0, 0] * inv_det], dim=-1)

        # axis-aligned radii (rasterizer.py:264-274)
        a, bb, c = ellipse[..., 0], ellipse[..., 1], ellipse[..., 2]
        cut = torch.full_like(a, s.cutoff_threshold)
        if cutoff_scale is not None:
            cut = cut * cutoff_scale.detach()
        denom = eps_denom(4.0 * a * c - bb * bb, 1e-12)
        ry = torch.sqrt(eps_sqrt(4.0 * a * cut / denom))
        rx = torch.sqrt(eps_sqrt(4.0 * c * cut / denom))
        radii = torch.stack([rx, ry], dim=-1)
        scaler = torch.abs(detMk) / eps_denom(
            torch.sqrt(eps_sqrt(detGV * 4.0 * math.pi * math.pi)),
            1e-12)
    return SplatParams(pts_ndc=pts_ndc, ellipse=ellipse, radii=radii,
                       cutoff=cut, scaler=scaler, mask=rmask)


def _untile(x: torch.Tensor, S: int, T: int) -> torch.Tensor:
    """(B, nt², T², C) tiled -> (B, S, S, C) image layout."""
    b, c, nt = x.shape[0], x.shape[-1], S // T
    return (x.reshape(b, nt, nt, T, T, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, S, S, c))


def stage_inputs(pts_ndc, ellipse, radii, cutoff, mask,
                 settings: RasterizationSettings):
    """The two stages' inputs: the selection's arguments (px, py, z, rx,
    ry, valid (B, P) as views of the splat parameters, S, T, strip and tile
    capacity) and the fine stage's (B, P, 9) per-splat table."""
    s = settings
    S, T = s.image_size, s.tile_size
    if S % T != 0:
        raise ValueError("image_size must be a multiple of tile_size")
    px, py, z = pts_ndc[..., 0], pts_ndc[..., 1], pts_ndc[..., 2]
    rx, ry = radii[..., 0], radii[..., 1]
    valid = mask & (z >= 0)  # behind-camera skip (rasterize_points.cu:88-89)
    M = min(s.max_points_per_tile, pts_ndc.shape[1])
    sel = (px, py, z, rx, ry, valid, S, T, s.max_points_per_strip, M)
    table = torch.stack([px, py, z, ellipse[..., 0], ellipse[..., 1],
                         ellipse[..., 2], rx, ry, cutoff], dim=-1)   # (B, P, 9)
    return sel, table


@torch.no_grad()
def _rasterize_forward(pts_ndc, ellipse, radii, cutoff, mask,
                       settings: RasterizationSettings):
    """(Fragments, slots (B, n_tiles, T², K), cand_idx (B, n_tiles, M)):
    the maps and what the backward reads of the fine stage."""
    s = settings
    S, T, K = s.image_size, s.tile_size, s.points_per_pixel
    b, p, _ = pts_ndc.shape
    sel, table = stage_inputs(pts_ndc, ellipse, radii, cutoff, mask, s)
    kernels = s.use_pallas
    if kernels and s.use_pallas_selection in (None, True):
        cand_idx, cand_ok, overflow = select_candidates(*sel)
    else:
        cand_idx, cand_ok, overflow = select_candidates_plain(*sel)
    fine = rasterize_fine if kernels else rasterize_fine_plain
    res = fine(table, cand_idx, cand_ok, S, T, K, s.depth_merging_threshold)
    # visibility at candidate level: the candidates some pixel picked
    flat = torch.where(res.used, cand_idx, p).reshape(b, -1)
    vis = torch.zeros((b, p + 1), dtype=torch.bool, device=pts_ndc.device)
    vis = vis.scatter(1, flat, True)[:, :p]
    frags = Fragments(idx=_untile(res.idx, S, T), zbuf=_untile(res.zbuf, S, T),
                      qvalue=_untile(res.qvalue, S, T),
                      occupancy=_untile(res.occ[..., None], S, T)[..., 0],
                      visibility=vis, tile_overflow=overflow)
    return frags, res.slots, cand_idx


def _rasterize_backward(pts_ndc, radii, mask, visibility, slots, cand_idx,
                        g_zbuf, g_occ, settings: RasterizationSettings
                        ) -> torch.Tensor:
    """The gradient of `pts_ndc` (rasterizer.py:607-683): z from the zbuf
    cotangent (B, S, S, K), summed per tile into the candidate slots and
    added to the candidates' points (`splat.zbuf_backward_points`: with
    `use_pallas` one kernel on CUDA tensors, which reads the cotangent in
    image layout and adds each hit slot's sum with an atomic, so the sums
    to the points run in another order than on the CPU; else the plain
    tile sums and `index_add_`); xy from the occupancy backward of the
    clouds' visible, renderable points (one call for all clouds)."""
    s = settings
    p = pts_ndc.shape[1]
    zbuf_bwd = zbuf_backward_points if s.use_pallas else zbuf_backward_points_plain
    gz = zbuf_bwd(slots, g_zbuf, cand_idx, p)
    occ_bwd = occ_backward_plain if s.use_pallas_backward is False else occ_backward
    gxy = occ_bwd(pts_ndc, radii, visibility & mask, g_occ, s)
    grad = torch.cat([gxy, gz[..., None]], dim=-1).to(pts_ndc.dtype)
    if s.clip_pts_grad > 0:
        n = torch.linalg.norm(grad, dim=-1, keepdim=True)
        grad = grad / torch.clamp(n, min=1e-12) * torch.clamp(n, max=s.clip_pts_grad)
    return grad


class _RasterizeSplats(torch.autograd.Function):
    """Forward maps, backward to `pts_ndc` only (rasterizer.py:582-692):
    ellipse, radii and cutoff get zeros, the mask none; the idx,
    visibility and overflow outputs are not differentiable and the qvalue
    cotangent is dropped (colour gradients reach the features through the
    compositor's weights instead)."""

    @staticmethod
    def forward(ctx, pts_ndc, ellipse, radii, cutoff, mask, settings):
        frags, slots, cand_idx = _rasterize_forward(pts_ndc, ellipse, radii,
                                                    cutoff, mask, settings)
        ctx.settings = settings
        ctx.shapes = (ellipse.shape, cutoff.shape)
        ctx.save_for_backward(pts_ndc, radii, mask, frags.visibility, slots,
                              cand_idx)
        ctx.mark_non_differentiable(frags.idx, frags.visibility,
                                    frags.tile_overflow)
        return tuple(frags)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _g_idx, g_zbuf, _g_qvalue, g_occ, _g_vis, _g_ovf):
        pts_ndc, radii, mask, vis, slots, cand_idx = ctx.saved_tensors
        grad = _rasterize_backward(pts_ndc, radii, mask, vis, slots, cand_idx,
                                   g_zbuf, g_occ, ctx.settings)
        need = ctx.needs_input_grad
        zeros = lambda i, shape: (torch.zeros(shape, dtype=pts_ndc.dtype,
                                              device=pts_ndc.device)
                                  if need[i] else None)
        return (grad if need[0] else None, zeros(1, ctx.shapes[0]),
                zeros(2, radii.shape), zeros(3, ctx.shapes[1]), None, None)


def rasterize_splats(pts_ndc, ellipse, radii, cutoff, mask,
                     settings: RasterizationSettings) -> Fragments:
    """Splat rasterization of B clouds (rasterizer.py:582-593),
    differentiable in `pts_ndc` (see `_RasterizeSplats`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pts_ndc, ellipse, radii, cutoff)):
        return Fragments(*_RasterizeSplats.apply(pts_ndc, ellipse, radii,
                                                 cutoff, mask, settings))
    return _rasterize_forward(pts_ndc, ellipse, radii, cutoff, mask,
                              settings)[0]


def visible_point_mask(idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """(B, num_points) bool: the points that appear in the fragment maps
    idx (B, ...) (rasterizer.py:695-702; −1 is empty)."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    safe = torch.where(flat >= 0, flat, num_points)
    vis = torch.zeros((b, num_points + 1), dtype=torch.bool, device=idx.device)
    return vis.scatter(1, safe, True)[:, :num_points]
