"""Implicit scene model: SDF decoder + texture + ray engine (port of
isopoints_tpu/models/implicit.py:66-325, the IDR training forward).

The decoder is an `nn.Module`; the model's methods take tensors and an
explicit camera. Tracing is no-grad by design: `trace_sdf_fn` returns the
fused CUDA MLP on detached weights (with `use_fused_mlp`), and the ray
trace runs under `torch.no_grad()`. Loss-path evaluations use the plain
decoder, so θ-gradients reach the parameters only through the sample
network, the normals, the texture and the SDF losses.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.models.levelset import directional_sample_network
from isopoints_torch.models.raytracing import RayTracingConfig, ray_trace
from isopoints_torch.ops.fused_mlp import make_fused_siren_sdf
from isopoints_torch.ops.images import sample_image_at_ndc
from isopoints_torch.rendering.lighting import DirectionalLights
from isopoints_torch.rendering.texture import lighting_texture


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
    proj_max_iters: int = 10
    proj_tolerance: float = 5e-5
    texture_type: str = "lighting"
    shininess: float = 64.0
    use_fused_mlp: bool = False
    coarse_trace_iters: int = 0
    raytrace: Optional[dict] = None


class ImplicitModel(nn.Module):
    """SDF decoder + Phong texture + IDR ray tracing."""

    def __init__(self, decoder: nn.Module, cfg: ImplicitConfig = ImplicitConfig()):
        super().__init__()
        if cfg.texture_type != "lighting":
            raise NotImplementedError(
                "texture_type 'neural' needs RenderingNetwork, not ported yet "
                "(ROADMAP Queue 1 item 3)")
        self.decoder = decoder
        self.cfg = cfg
        rt = RayTracingConfig(object_bounding_sphere=cfg.object_bounding_sphere,
                              sdf_threshold=cfg.proj_tolerance,
                              sphere_tracing_iters=cfg.proj_max_iters,
                              coarse_trace_iters=cfg.coarse_trace_iters)
        if cfg.raytrace:
            rt = dataclasses.replace(rt, **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in dict(cfg.raytrace).items()})
        self.raytrace_cfg = rt

    def sdf_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.decoder.sdf

    def trace_sdf_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """SDF callable for the no-grad tracing: the fused CUDA MLP on
        detached weights when `use_fused_mlp` (it carries `.sdf_and_grad`
        and `.fused_ray_sampler`), else the plain decoder."""
        if self.cfg.use_fused_mlp:
            return make_fused_siren_sdf(self.decoder)
        return self.sdf_fn()

    def normals_from_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Raw SDF gradients, differentiable in θ and x."""
        return sdf_and_grad(self.sdf_fn(), x)[1]

    def decode_color(self, points, normals, camera: PerspectiveCamera,
                     lights: Optional[DirectionalLights] = None):
        if lights is None:
            lights = DirectionalLights.create(device=points.device)
        return lighting_texture(points, normals, lights,
                                camera.camera_center(),
                                shininess=self.cfg.shininess)

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
                            training=training)
        iso_points = res.points
        if training:
            iso_points = directional_sample_network(self.sdf_fn(), res.points,
                                                    dirs, cam_pos)
        free_mask = ~mask_gt
        occ_mask = (~res.network_object_mask) & mask_gt
        return iso_points, res.network_object_mask, free_mask, occ_mask, res

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
