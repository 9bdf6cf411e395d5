"""Explicit point-cloud scene model, DSS (port of
isopoints_tpu/models/point.py): learnable point positions, normals stored
as azimuth/elevation angles, per-point colours and a global splat-size
scale, rendered by surface splatting with the in-mask filter.

Its parameters are those of the JAX pytree, under the same names:
`points` (1, P, 3), `normals_azim` and `normals_elev` (1, P), `colors`
(1, P, 3) and `log_size` (). `exp(log_size)` enters the rasterizer's cutoff
detached, so its gradient is zero, as in the JAX package.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.core.cloud import PointCloud
from isopoints_torch.debug import get_debugging_mode, tap_image_grad
from isopoints_torch.ops.images import sample_image_at_ndc
from isopoints_torch.rendering.lighting import DirectionalLights
from isopoints_torch.rendering.rasterizer import RasterizationSettings
from isopoints_torch.rendering.renderer import render_pointcloud
from isopoints_torch.rendering.texture import lighting_texture
from isopoints_torch.utils.mathutils import angles_to_vectors, vectors_to_angles


class PointModelOutput(NamedTuple):
    rgba: torch.Tensor        # (B, S, S, 4)
    visibility: torch.Tensor  # (B, P)
    inmask: torch.Tensor      # (B, P) projected inside the gt 2D mask


@dataclass(frozen=True)
class PointModelConfig:
    n_points_per_cloud: int = 5000
    learn_normals: bool = True
    learn_colors: bool = True
    learn_size: bool = True
    shininess: float = 64.0


class PointModel(nn.Module):
    """Learnable splat cloud (point.py:42-148)."""

    def __init__(self, cfg: PointModelConfig = PointModelConfig(),
                 raster_settings: RasterizationSettings = RasterizationSettings(),
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.raster_settings = raster_settings
        self.init(generator, device=device)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None,
             points: Optional[torch.Tensor] = None,
             normals: Optional[torch.Tensor] = None,
             colors: Optional[torch.Tensor] = None, device=None) -> "PointModel":
        """(Re)set the parameters (point.py:50-74): points uniform in a
        1.5-side cube drawn from `generator` unless given, normals radial
        unless given, white colours, log_size 0."""
        if device is None:
            device = self.points.device
        if points is None:
            n = self.cfg.n_points_per_cloud
            points = (torch.rand((1, n, 3), generator=generator, device=device)
                      - 0.5) * 1.5
        lift = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        points = lift(points)
        if points.dim() == 2:
            points = points[None]
        if normals is None:
            normals = points / torch.clamp(
                torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-12)
        normals = lift(normals).reshape(points.shape)
        azim, elev = vectors_to_angles(normals)
        colors = (torch.ones_like(points) if colors is None
                  else lift(colors).reshape(points.shape))
        self.points = nn.Parameter(points.clone())
        self.normals_azim = nn.Parameter(azim)
        self.normals_elev = nn.Parameter(elev)
        self.colors = nn.Parameter(colors.clone())
        self.log_size = nn.Parameter(torch.zeros((), device=device))
        return self

    def normals(self) -> torch.Tensor:
        return angles_to_vectors(self.normals_azim, self.normals_elev)

    def cloud(self, mask: Optional[torch.Tensor] = None) -> PointCloud:
        if mask is None:
            mask = torch.ones(self.points.shape[:2], dtype=torch.bool,
                              device=self.points.device)
        return PointCloud(points=self.points, mask=mask, normals=self.normals(),
                          features=self.colors)

    def forward(self, camera: PerspectiveCamera,
                mask_img: Optional[torch.Tensor] = None,
                lights: Optional[DirectionalLights] = None,
                activation_mask: Optional[torch.Tensor] = None
                ) -> PointModelOutput:
        """Render RGBA and compute the in-mask filter (point.py:86-126).
        `mask_img` (B, S, S, 1); without it every point is in the mask."""
        pc = self.cloud(activation_mask)
        b = camera.batch_size
        if pc.batch_size == 1 and b > 1:
            tile = lambda x: x.expand((b,) + x.shape[1:])
            pc = PointCloud(points=tile(pc.points), mask=tile(pc.mask),
                            normals=tile(pc.normals), features=tile(pc.features))
        if lights is None:
            lights = DirectionalLights.create(device=self.points.device)
        shaded = lighting_texture(pc.points, pc.normals, lights,
                                  camera.camera_center(), pc.features,
                                  shininess=self.cfg.shininess)
        scale = torch.exp(self.log_size) if self.cfg.learn_size else None
        out = render_pointcloud(pc.with_features(shaded), camera,
                                self.raster_settings, cutoff_scale=scale)
        if get_debugging_mode():
            # the mask-image gradient tap (isopoints_tpu/models/point.py:111-117)
            out = out._replace(rgba=torch.cat(
                [out.rgba[..., :3], tap_image_grad(out.rgba[..., 3:])], dim=-1))
        if mask_img is not None:
            pix = camera.project_ndc(pc.points)[..., :2].detach()
            inmask = sample_image_at_ndc(mask_img, pix, mode="nearest")[..., 0] > 0.5
        else:
            inmask = torch.ones(pc.mask.shape, dtype=torch.bool,
                                device=pc.mask.device)
        return PointModelOutput(rgba=out.rgba, visibility=out.visibility,
                                inmask=inmask)

    @staticmethod
    def prune_points(grad_points: torch.Tensor,
                     activation_mask: torch.Tensor) -> torch.Tensor:
        """The activation mask without the points whose silhouette-loss
        gradient is exactly zero (point.py:128-133)."""
        return activation_mask & ~torch.all(grad_points == 0.0, dim=-1)

    @torch.no_grad()
    def generate_mesh(self, resolution: int = 128,
                      activation_mask: Optional[torch.Tensor] = None):
        """Mesh the active points of the cloud by IMLS and marching
        tetrahedra on the points' device (point.py:135-148; the reference's
        Poisson reconstruction replaced as in the JAX package). Returns
        (verts (V, 3) float32, faces (F, 3) int64)."""
        from isopoints_torch.ops.imls import pointcloud_to_mesh

        pc = self.cloud(activation_mask)
        m = pc.mask[0].cpu().numpy()
        return pointcloud_to_mesh(pc.points[0].cpu().numpy()[m],
                                  pc.normals[0].cpu().numpy()[m],
                                  resolution=resolution,
                                  device=self.points.device)
