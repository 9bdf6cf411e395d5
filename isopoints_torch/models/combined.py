"""Combined model: implicit SDF + persistent iso-point cloud (port of
isopoints_tpu/models/combined.py:40-342).

Without projection (`project=False`, or no iso-points yet) the forward is
the pure IDR path of ImplicitModel and the iso-point buffers pass through.
With projection it samples via the iso-points: visibility rasters of the
cloud from the view and from behind (at `visibility_image_size`), a
visible subset capped and midpoint-upsampled to `max_iso_per_batch`,
jittered and Newton-projected; on-surface points re-attached by the
sample network, freespace samples on out-of-mask rays and out-of-mask
iso-points, and the min-SDF point between the front and back iso-point
bounds of each in-mask ray.

The persistent buffer `(points, mask)` is explicit: the forward takes and
returns it. The projected phase's random numbers come in `ProjectedDraws`
(the trainer draws them, or tests hand in the JAX package's).
"""

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.debug import tap_grad
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.models.implicit import (ImplicitConfig, ImplicitModel,
                                             ModelOutput)
from isopoints_torch.models.levelset import (directional_sample_network,
                                             project_points, sample_network)
from isopoints_torch.models.raytracing import intersection_with_unit_cube
from isopoints_torch.ops.images import sample_image_at_ndc
from isopoints_torch.ops.points import midpoint_upsample
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  compute_splat_params,
                                                  rasterize_splats,
                                                  splat_spacing)
from isopoints_torch.utils import fma, linspace01, top_k


@dataclass(frozen=True)
class CombinedConfig:
    max_iso_per_batch: int = 1000
    n_points_per_cloud: int = 5000
    n_insurface_points_per_ray: int = 64
    visibility_image_size: int = 256


class ProjectedDraws(NamedTuple):
    """The random numbers of one projected forward, uniform in [0, 1)."""
    sel_scores: torch.Tensor   # (1, P) visible-point selection scores
    iso_offset: torch.Tensor   # (1, max_iso_per_batch, 3) jitter, used as u − 0.5
    ray_uniform: torch.Tensor  # (B, N) freespace depth fractions


def back_camera(camera: PerspectiveCamera) -> PerspectiveCamera:
    """The camera turned 180° about its y axis, same center
    (combined.py:48-55)."""
    R = camera.R.clone()
    R[:, :, 0] *= -1.0
    R[:, :, 2] *= -1.0
    center = camera.camera_center()
    T = -torch.einsum("bi,bij->bj", center, R)
    pp = camera.principal_point.clone()
    pp[:, 1] *= -1.0
    return dataclasses.replace(camera, R=R, T=T, principal_point=pp)


class CombinedModel(ImplicitModel):
    """Implicit model + persistent iso-points (combined_modeling.Model)."""

    def __init__(self, decoder, cfg: ImplicitConfig = ImplicitConfig(),
                 combined_cfg: CombinedConfig = CombinedConfig(),
                 raster_settings: Optional[RasterizationSettings] = None,
                 rendering_net=None):
        super().__init__(decoder, cfg, rendering_net)
        self.ccfg = combined_cfg
        # the visibility rasters run at visibility_image_size, not the
        # renderer's size (combined.py:67-78)
        self.raster_settings = dataclasses.replace(
            raster_settings or RasterizationSettings(),
            image_size=combined_cfg.visibility_image_size)

    def init_points(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Initial iso-point buffer: random cube points (1, n, 3) and an
        all-true mask (combined.py:80-85)."""
        n = self.ccfg.n_points_per_cloud
        pts = (torch.rand((1, n, 3), generator=generator, device=device)
               - 0.5) * 1.5
        return pts, torch.ones((1, n), dtype=torch.bool, device=device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def visible_points_mask(self, points, mask, normals,
                            camera: PerspectiveCamera, spacing=None):
        """(1, P): points that produce fragments in some view of `camera`
        (combined.py:88-102)."""
        b = camera.batch_size
        tile = lambda x: x.expand((b,) + x.shape[1:])
        sp = compute_splat_params(tile(points), tile(normals), tile(mask),
                                  camera, self.raster_settings,
                                  spacing=spacing)
        frags = rasterize_splats(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff,
                                 sp.mask, self.raster_settings)
        return torch.any(frags.visibility, dim=0, keepdim=True)

    @torch.no_grad()
    def get_visible_iso_points(self, f_trace, points, mask, sel_scores,
                               iso_offset, vis):
        """Cap the visible points to a random `max_iso_per_batch` subset,
        midpoint-upsample to that capacity, jitter by ±0.025 and project
        (combined.py:104-142). Returns (points (1, M, 3), normals, mask)."""
        m = self.ccfg.max_iso_per_batch
        scores = torch.where(vis, sel_scores, -1.0)
        top_val, top_idx = top_k(scores, min(m, points.shape[1]))
        # unselected slots carry the -1 sentinel (draws lie in [0, 1))
        sel_ok = top_val > -0.5
        sel = torch.gather(points, 1, top_idx[..., None].expand(-1, -1, 3))
        if sel.shape[1] < m:
            pad = m - sel.shape[1]
            sel = torch.nn.functional.pad(sel, (0, 0, 0, pad))
            sel_ok = torch.nn.functional.pad(sel_ok, (0, pad), value=False)
        up, up_mask = midpoint_upsample(sel, sel_ok, m, neighborhood_size=8)
        up = fma(torch.full_like(iso_offset, 0.05), iso_offset - 0.5, up)
        res = project_points(f_trace, up, up_mask, self.proj_cfg,
                             skip_resampling=True, skip_upsampling=True)
        return res.points, res.normals, res.mask

    # ------------------------------------------------------------------
    def sample_onsurface_using_isopoints(self, iso_points, iso_mask, mask_img,
                                         camera: PerspectiveCamera,
                                         training: bool = True):
        """In-mask visible iso-points, differentiably re-attached
        (combined.py:145-166): by the sample network with the Phong
        texture, along the camera rays by the directional sample network
        otherwise. Returns (points, mask)."""
        b = camera.batch_size
        pts = iso_points.expand((b,) + iso_points.shape[1:])
        msk = iso_mask.expand((b,) + iso_mask.shape[1:])
        pix = camera.project_ndc(pts)[..., :2]
        in_gt = sample_image_at_ndc(mask_img, torch.clamp(pix, -1.0, 1.0),
                                    mode="nearest")[..., 0] > 0.5
        if training:
            if self.cfg.texture_type == "lighting":
                pts = sample_network(self.sdf_fn(), pts)
            else:
                cam_pos = camera.camera_center()[:, None, :]
                pts = directional_sample_network(self.sdf_fn(), pts,
                                                 pts.detach() - cam_pos, cam_pos)
        return pts, in_gt & msk

    @torch.no_grad()
    def sample_offsurface_using_isopoints(self, f_trace, ndc_pixels, mask_img,
                                          iso_points, iso_mask, points, mask,
                                          camera: PerspectiveCamera,
                                          ray_uniform, normals, frontal,
                                          spacing=None):
        """Freespace and occluded in-surface candidates
        (combined.py:168-252). Returns (p_free (B, N + M, 3), free_mask,
        p_ins (B, N, 3), ins_mask)."""
        b = camera.batch_size
        cam_pos = camera.camera_center()[:, None, :]
        _, dirs = camera.ndc_to_rays(ndc_pixels)
        in_gt = sample_image_at_ndc(mask_img, ndc_pixels,
                                    mode="nearest")[..., 0] > 0.5

        # freespace on out-of-mask rays: a random depth inside the cube
        entry, exit_, hit = intersection_with_unit_cube(
            cam_pos, dirs, side_length=self.cfg.object_bounding_sphere * 2)
        seg_len = torch.linalg.norm(exit_ - entry, dim=-1)
        t = ray_uniform * seg_len
        p_free_rays = fma(t[..., None], dirs, entry)
        free_rays_mask = (~in_gt) & hit
        # + out-of-mask iso-points
        iso_b = iso_points.expand((b,) + iso_points.shape[1:])
        iso_mb = iso_mask.expand((b,) + iso_mask.shape[1:])
        iso_pix = camera.project_ndc(iso_b)[..., :2]
        iso_in_gt = sample_image_at_ndc(mask_img, torch.clamp(iso_pix, -1, 1),
                                        mode="nearest")[..., 0] > 0.5
        p_free = torch.cat([p_free_rays, iso_b], dim=1)
        free_mask = torch.cat([free_rays_mask, (~iso_in_gt) & iso_mb], dim=1)

        # occluded in-surface points on in-mask rays, between the closest
        # frontal and back-visible iso-point bounds
        occluded = self.visible_points_mask(points, mask, normals,
                                            back_camera(camera),
                                            spacing=spacing) & mask
        pc = (points - cam_pos).expand(b, -1, -1)

        def ray_bound(vis_mask):
            # closest visible point to each ray -> its along-ray length;
            # (B, N, P) in one product, as the JAX package does
            along = torch.einsum("bpd,bnd->bnp", pc, dirs)
            d2 = torch.sum(pc * pc, dim=-1)[:, None, :] - along ** 2
            d2 = torch.where(vis_mask.expand(b, -1)[:, None, :], d2, 1e10)
            nn = torch.argmin(d2, dim=-1)
            t_sq = torch.gather(along, -1, nn[..., None])[..., 0] ** 2
            return torch.sqrt(torch.clamp(t_sq, min=1e-17))

        t0 = ray_bound(frontal)
        t1 = ray_bound(occluded)
        ins_mask = in_gt & (t0 < t1)
        steps = linspace01(self.ccfg.n_insurface_points_per_ray + 2,
                           ndc_pixels.device)[1:-1]
        ts = fma(steps, (t1 - t0)[..., None], t0[..., None])
        cand = fma(ts[..., None], dirs[..., None, :], cam_pos[..., None, :])
        sdf = f_trace(cand)                                       # (B, N, n)
        imin = torch.argmin(sdf, dim=-1)
        p_ins = torch.gather(cand, 2, imin[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
        return p_free, free_mask, p_ins, ins_mask

    # ------------------------------------------------------------------
    def forward(self, ndc_pixels, img, mask_img, camera: PerspectiveCamera,
                u: Optional[torch.Tensor], points=None, points_mask=None,
                lights=None, project: bool = True,
                sample_iso_offsurface: bool = True, training: bool = True,
                draws: Optional[ProjectedDraws] = None, spacing=None):
        """Returns (ModelOutput, new_points, new_points_mask).

        `u`: the warm-up path's min-SDF step fractions; `draws`: the
        projected path's random numbers; `spacing`: a cached
        `splat_spacing` of `points` (computed here when None). Without
        `sample_iso_offsurface` the off-surface samples are skipped: the
        free-space and occupancy points are the on-surface ones, both masks
        False (combined.py:304-314)."""
        if not project or points is None:
            # warm-up / no iso-points: the pure IDR path (combined.py:272-276)
            out = super().forward(ndc_pixels, img, mask_img, camera, u,
                                  lights=lights, training=training)
            return out, points, points_mask
        if draws is None:
            raise ValueError("the projected forward needs its ProjectedDraws")

        # per-point state shared by the visibility rasters and the bounds
        f_trace = self.trace_sdf_fn()
        with torch.no_grad():
            pts_normals = sdf_and_grad(f_trace, points)[1]
            if spacing is None:
                spacing = splat_spacing(points, points_mask, self.raster_settings)
            frontal = self.visible_points_mask(points, points_mask, pts_normals,
                                               camera, spacing=spacing) & points_mask
            iso_pts, _, iso_mask = self.get_visible_iso_points(
                f_trace, points, points_mask, draws.sel_scores,
                draws.iso_offset, frontal)
        ons_pts, ons_mask = self.sample_onsurface_using_isopoints(
            iso_pts, iso_mask, mask_img, camera, training=training)
        # the pixel-gradient tap (isopoints_tpu/models/combined.py:300-302)
        ons_pts = tap_grad("iso", ons_pts)
        if sample_iso_offsurface:
            p_free, free_mask, p_ins, ins_mask = \
                self.sample_offsurface_using_isopoints(
                    f_trace, ndc_pixels, mask_img, iso_pts, iso_mask, points,
                    points_mask, camera, draws.ray_uniform, pts_normals,
                    frontal, spacing=spacing)
        else:
            p_free = p_ins = ons_pts.detach()
            free_mask = ins_mask = torch.zeros_like(ons_mask)

        normals = self.normals_from_grad(ons_pts)
        rgb = self.decode_color(ons_pts, normals, camera, lights)
        pix_pred = camera.project_ndc(ons_pts)[..., :2]
        rgb_gt = sample_image_at_ndc(img, pix_pred.detach())
        sdf_free = self.decoder.sdf(p_free)
        sdf_occ = self.decoder.sdf(p_ins)
        zero = torch.zeros((), dtype=torch.long, device=ndc_pixels.device)
        out = ModelOutput(
            iso_points=ons_pts, iso_mask=ons_mask, network_mask=ons_mask,
            iso_normals=normals, iso_rgb=rgb, iso_rgb_gt=rgb_gt,
            iso_pixels=pix_pred, p_freespace=p_free, freespace_mask=free_mask,
            sdf_freespace=sdf_free, p_occupancy=p_ins,
            occupancy_mask=ins_mask, sdf_occupancy=sdf_occ,
            # the iso-point path runs no ray tracer: no compaction overflow
            overflow_trace=zero, overflow_sampler=zero)
        # the persistent buffer becomes the visible iso-points
        return out, iso_pts, iso_mask
