"""Implicit scene model: SDF decoder + texture + ray engine (port of
isopoints_tpu/models/implicit.py:66-341: the IDR training forward, the
DVR-style `pixels_to_world`, the min-SDF `sample_world_points` and
`get_point_clouds`).

The decoder is an `nn.Module`; the model's methods take tensors and an
explicit camera. Tracing is no-grad by design: `trace_sdf_fn` returns the
fused CUDA MLP on detached weights (with `use_fused_mlp`, for a SIREN or an
IGR decoder), `trace_sdf_fn_coarse` its bf16 variant for the coarse phase
of the trace precision schedule, and the ray trace runs under
`torch.no_grad()`. Loss-path evaluations use the plain decoder, so
θ-gradients reach the parameters only through the sample network, the
normals, the texture and the SDF losses. With `texture_type: neural` the
model holds the `RenderingNetwork` as its submodule `texture`, so its
parameters sit beside the decoder's in `named_parameters()` (JAX's
`params["texture"]`).
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.debug import tap_grad
from isopoints_torch.models.fields import (FieldOutput, RenderingNetwork,
                                           sdf_and_grad)
from isopoints_torch.models.levelset import (ProjectionConfig,
                                             directional_sample_network,
                                             project_points, sample_network)
from isopoints_torch.models.raytracing import (
    RayTracingConfig, find_zero_crossing_between_point_pairs,
    intersection_with_unit_cube, ray_trace, sphere_trace_along_rays)
from isopoints_torch.ops.fused_mlp import make_fused_sdf_fn
from isopoints_torch.ops.images import sample_image_at_ndc
from isopoints_torch.rendering.lighting import DirectionalLights
from isopoints_torch.rendering.texture import lighting_texture, neural_texture
from isopoints_torch.utils import linspace01


class ModelOutput(NamedTuple):
    """Padded analogue of the reference forward dict."""
    iso_points: torch.Tensor      # (B, N, 3) differentiable surface points
    iso_mask: torch.Tensor        # (B, N) on-surface & in-mask
    network_mask: torch.Tensor    # (B, N) predicted surface hit
    iso_normals: torch.Tensor     # (B, N, 3)
    iso_rgb: torch.Tensor         # (B, N, 3)
    iso_rgb_gt: torch.Tensor      # (B, N, 3)
    iso_pixels: torch.Tensor      # (B, N, 2) NDC projections
    p_freespace: torch.Tensor     # (B, Nf, 3)
    freespace_mask: torch.Tensor
    sdf_freespace: torch.Tensor   # (B, Nf)
    p_occupancy: torch.Tensor     # (B, No, 3)
    occupancy_mask: torch.Tensor
    sdf_occupancy: torch.Tensor   # (B, No)
    overflow_trace: torch.Tensor
    overflow_sampler: torch.Tensor


@dataclass(frozen=True)
class ImplicitConfig:
    """Knobs of implicit_modeling.Model (implicit.py:66-91)."""
    object_bounding_sphere: float = 1.0
    n_points_per_ray: int = 100
    proj_max_iters: int = 10
    proj_tolerance: float = 5e-5
    texture_type: str = "lighting"
    shininess: float = 64.0
    use_fused_mlp: bool = False
    coarse_trace_iters: int = 0
    raytrace: Optional[dict] = None


class ImplicitModel(nn.Module):
    """SDF decoder + texture (Phong, or the neural `RenderingNetwork`) + IDR
    ray tracing. `rendering_net` serves `texture_type: neural`; without one
    the model makes `RenderingNetwork(dim=9, c_dim=0)`, as the JAX model
    does (implicit.py:104-105)."""

    def __init__(self, decoder: nn.Module, cfg: ImplicitConfig = ImplicitConfig(),
                 rendering_net: Optional[RenderingNetwork] = None):
        super().__init__()
        if cfg.texture_type not in ("lighting", "neural"):
            raise ValueError(f"texture_type must be 'lighting' or 'neural', got "
                             f"{cfg.texture_type!r}")
        self.decoder = decoder
        self.cfg = cfg
        if cfg.texture_type == "neural" and rendering_net is None:
            rendering_net = RenderingNetwork(dim=9, c_dim=0, device=next(
                decoder.parameters()).device)
        self.texture = rendering_net
        rt = RayTracingConfig(object_bounding_sphere=cfg.object_bounding_sphere,
                              sdf_threshold=cfg.proj_tolerance,
                              sphere_tracing_iters=cfg.proj_max_iters,
                              coarse_trace_iters=cfg.coarse_trace_iters)
        if cfg.raytrace:
            rt = dataclasses.replace(rt, **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in dict(cfg.raytrace).items()})
        self.raytrace_cfg = rt
        self.proj_cfg = ProjectionConfig(proj_max_iters=cfg.proj_max_iters,
                                         proj_tolerance=cfg.proj_tolerance)

    def sdf_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.decoder.sdf

    def trace_sdf_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """SDF callable for the no-grad tracing (implicit.py:136-154): the
        fused CUDA MLP on detached weights when `use_fused_mlp` and the
        decoder has one (it carries `.sdf_and_grad`, `.fused_ray_sampler`
        and `.fused_trace_stepper`), else the plain decoder."""
        if self.cfg.use_fused_mlp:
            fused = make_fused_sdf_fn(self.decoder)
            if fused is not None:
                return fused
        return self.sdf_fn()

    def trace_sdf_fn_coarse(self) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """The bf16 fused MLP for the coarse phase of the trace precision
        schedule, or None when `use_fused_mlp` is off or the effective
        `coarse_trace_iters` is 0 (implicit.py:156-167)."""
        if not (self.cfg.use_fused_mlp
                and self.raytrace_cfg.coarse_trace_iters > 0):
            return None
        return make_fused_sdf_fn(self.decoder, precision="bf16")

    def decode(self, x: torch.Tensor) -> FieldOutput:
        """The decoder's full output, every head (implicit.py:169-170)."""
        return self.decoder.heads(x)

    def normals_from_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Raw SDF gradients, differentiable in θ and x."""
        return sdf_and_grad(self.sdf_fn(), x)[1]

    def decode_color(self, points, normals, camera: PerspectiveCamera,
                     lights: Optional[DirectionalLights] = None):
        """Per-point RGB by the neural texture or Phong (implicit.py:
        178-191)."""
        if self.cfg.texture_type == "neural":
            return neural_texture(self.texture, points, normals,
                                  camera.view_direction(points))
        if lights is None:
            lights = DirectionalLights.create(device=points.device)
        return lighting_texture(points, normals, lights,
                                camera.camera_center(),
                                shininess=self.cfg.shininess)

    def pixels_to_world(self, ndc_pixels: torch.Tensor,
                        camera: PerspectiveCamera, training: bool = True):
        """DVR-style surface points (implicit.py:193-233): the cube
        interval, a sphere trace forward from the entry and one backward
        from the exit on `trace_sdf_fn()` (the fused kernel with
        `use_fused_mlp`), the secant between the forward point and the
        backward one where the forward trace did not converge, and the
        grazing-angle filter. In training the points are re-attached to the
        plain field along their rays (`directional_sample_network`), so
        θ-gradients reach the decoder. Returns (points (B, N, 3), mask
        (B, N))."""
        f = self.trace_sdf_fn()
        cam_pos = camera.camera_center()[:, None, :]
        _, dirs = camera.ndc_to_rays(ndc_pixels)
        with torch.no_grad():
            entry, exit_, hit = intersection_with_unit_cube(
                cam_pos, dirs, side_length=self.cfg.object_bounding_sphere * 2)
            kw = dict(max_iters=self.cfg.proj_max_iters,
                      tolerance=self.cfg.proj_tolerance)
            fwd = sphere_trace_along_rays(f, entry, dirs, **kw)
            mask_pred = fwd.mask & hit
            p_world = torch.where(mask_pred[..., None], fwd.points, entry)
            bwd = sphere_trace_along_rays(f, exit_, -dirs, **kw)
            p_secant, m_secant = find_zero_crossing_between_point_pairs(
                f, p_world, bwd.points)
            m_secant = ~mask_pred & m_secant
            p_world = torch.where(m_secant[..., None], p_secant, p_world)
            mask_pred = mask_pred | m_secant
            # grazing-angle filter (implicit.py:221-226)
            grad = sdf_and_grad(f, p_world)[1]
            gn = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                                    min=1e-12)
            mask_pred = mask_pred & (torch.sum(gn * dirs, dim=-1) < -1e-2)
        if training:
            p_world = directional_sample_network(self.sdf_fn(), p_world, dirs,
                                                 cam_pos)
        return p_world, mask_pred

    def sample_from_pixels(self, ndc_pixels: torch.Tensor,
                           camera: PerspectiveCamera, mask_gt: torch.Tensor,
                           u: Optional[torch.Tensor], training: bool = True):
        """IDR ray tracing wrapper (implicit.py:231-253). `u`: the min-SDF
        step fractions (n_steps,). Returns (iso_points, mask_pred,
        free_mask, occ_mask, trace result)."""
        f = self.trace_sdf_fn()
        cam_pos = camera.camera_center()[:, None, :]
        _, dirs = camera.ndc_to_rays(ndc_pixels)
        with torch.no_grad():
            res = ray_trace(f, cam_pos, dirs, mask_gt, u, self.raytrace_cfg,
                            training=training,
                            sdf_fn_coarse=self.trace_sdf_fn_coarse())
        iso_points = res.points
        if training:
            iso_points = directional_sample_network(self.sdf_fn(), res.points,
                                                    dirs, cam_pos)
        free_mask = ~mask_gt
        occ_mask = (~res.network_object_mask) & mask_gt
        return iso_points, res.network_object_mask, free_mask, occ_mask, res

    def sample_world_points(self, ndc_pixels: torch.Tensor,
                            camera: PerspectiveCamera, mask_gt: torch.Tensor,
                            mask_pred: Optional[torch.Tensor] = None):
        """The min-SDF candidate a ray (implicit.py:255-280): the
        `n_points_per_ray` evenly spaced points from the entry to the exit of
        the padded cube, evaluated by `trace_sdf_fn()` (the fused MLP with
        `use_fused_mlp`), the first of the lowest values picked. The pick
        carries no gradient, so the SDF runs under no_grad; the picked point
        stays differentiable in the camera. Returns (points (B, N, 3),
        free_mask, occ_mask): outside the mask and inside it, both only for
        rays in the image that hit the cube, and occupancy only where
        `mask_pred` (when given) is False."""
        f = self.trace_sdf_fn()
        cam_pos = camera.camera_center()[:, None, :]
        _, dirs = camera.ndc_to_rays(ndc_pixels)
        entry, exit_, hit = intersection_with_unit_cube(
            cam_pos, dirs, side_length=self.cfg.object_bounding_sphere * 2)
        in_camera = torch.all(torch.abs(ndc_pixels) <= 1.0, dim=-1)
        steps = linspace01(self.cfg.n_points_per_ray, ndc_pixels.device)
        pts = entry[..., None, :] + steps[:, None] * (exit_ - entry)[..., None, :]
        with torch.no_grad():
            imin = torch.argmin(f(pts), dim=-1)
        world = torch.gather(pts, 2, imin[..., None, None].expand(
            -1, -1, 1, 3))[..., 0, :]
        free_mask = ~mask_gt & in_camera & hit
        occ_mask = mask_gt & in_camera & hit
        if mask_pred is not None:
            occ_mask = occ_mask & ~mask_pred
        return world, free_mask, occ_mask

    def forward(self, ndc_pixels: torch.Tensor, img: torch.Tensor,
                mask_img: torch.Tensor, camera: PerspectiveCamera,
                u: Optional[torch.Tensor], lights=None,
                training: bool = True) -> ModelOutput:
        """IDR training forward (implicit.py:283-325). ndc_pixels (B, N, 2);
        img (B, H, W, 3); mask_img (B, H, W, 1); u (n_steps,)."""
        mask_gt = sample_image_at_ndc(mask_img, ndc_pixels,
                                      mode="nearest")[..., 0] > 0.5
        iso_points, mask_pred, free_mask, occ_mask, res = \
            self.sample_from_pixels(ndc_pixels, camera, mask_gt, u,
                                    training=training)
        # the pixel-gradient tap (isopoints_tpu/models/implicit.py:300-303)
        iso_points = tap_grad("iso", iso_points)
        ray_points = res.points.detach()
        normals = self.normals_from_grad(iso_points)
        rgb = self.decode_color(iso_points, normals, camera, lights)
        pix_pred = camera.project_ndc(iso_points)[..., :2]
        rgb_gt = sample_image_at_ndc(img, pix_pred.detach())
        # positions detached: the SDF-mask losses reach the decoder only
        sdf_free = self.decoder.sdf(ray_points)
        return ModelOutput(
            iso_points=iso_points, iso_mask=mask_gt & mask_pred,
            network_mask=mask_pred, iso_normals=normals, iso_rgb=rgb,
            iso_rgb_gt=rgb_gt, iso_pixels=pix_pred,
            p_freespace=ray_points, freespace_mask=free_mask,
            sdf_freespace=sdf_free, p_occupancy=ray_points,
            occupancy_mask=occ_mask, sdf_occupancy=sdf_free,
            overflow_trace=res.trace_overflow,
            overflow_sampler=res.sampler_overflow)

    def get_point_clouds(self, points: torch.Tensor, mask: torch.Tensor,
                         do_project: bool = False, attach_gradient: bool = True):
        """Points, their SDF gradients and mask (implicit.py:328-341): with
        `do_project` first projected onto the zero set of the plain field
        (Newton only, no resampling or upsampling) and, with
        `attach_gradient`, re-attached by `sample_network` so θ-gradients
        reach the decoder. Returns (points, normals, mask)."""
        f = self.sdf_fn()
        if do_project:
            res = project_points(f, points, mask, self.proj_cfg,
                                 skip_resampling=True, skip_upsampling=True)
            points, mask = res.points, res.mask
            if attach_gradient:
                points = sample_network(f, points)
        return points, self.normals_from_grad(points), mask
