"""Surface-splatting renderer: point cloud + camera -> RGBA (port of
isopoints_tpu/rendering/renderer.py): rasterize, fragment weights
exp(−0.5·q)·scaler, the normalised (or plain) weighted-sum composite, and
the occupancy map as alpha."""

from typing import NamedTuple, Optional

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.core.cloud import PointCloud
from isopoints_torch.rendering.compositor import (gather_fragments,
                                                  norm_weighted_sum_composite,
                                                  weighted_sum_composite)
from isopoints_torch.rendering.rasterizer import (Fragments,
                                                  RasterizationSettings,
                                                  compute_splat_params,
                                                  rasterize_splats)


class RenderOutput(NamedTuple):
    rgba: torch.Tensor        # (B, S, S, 4)
    fragments: Fragments
    visibility: torch.Tensor  # (B, P) points that produced fragments


def render_pointcloud(cloud: PointCloud, camera: PerspectiveCamera,
                      settings: RasterizationSettings,
                      features: Optional[torch.Tensor] = None,
                      normalize_weights: bool = True,
                      cutoff_scale: Optional[torch.Tensor] = None,
                      spacing: Optional[torch.Tensor] = None) -> RenderOutput:
    """The splat-render pipeline (renderer.py:33-78). `features[..., :3]`
    are RGB (default the cloud's, else white); `normalize_weights=False`
    composites the plain weighted sum; `cutoff_scale` a global
    splat-size scale (entering detached); `spacing` a cached
    `splat_spacing`. Gradients reach the points through the occupancy
    (alpha) and the colours through the features: q and the EWA scaler
    enter the weights detached."""
    if features is None:
        features = cloud.features
    if features is None:
        features = torch.ones_like(cloud.points)
    params = compute_splat_params(cloud.points, cloud.normals, cloud.mask,
                                  camera, settings, cutoff_scale=cutoff_scale,
                                  spacing=spacing)
    frags = rasterize_splats(params.pts_ndc, params.ellipse, params.radii,
                             params.cutoff, params.mask, settings)
    # scaler and RGB of every fragment in one gather (renderer.py:58-67)
    table = torch.cat([params.scaler[..., None].detach(), features[..., :3]],
                      dim=-1)                                   # (B, P, 4)
    gathered = gather_fragments(table, frags.idx)               # (B, S, S, K, 4)
    weights = torch.where(frags.idx >= 0,
                          torch.exp(-0.5 * frags.qvalue.detach())
                          * gathered[..., 0].detach(), 0.0)
    composite = (norm_weighted_sum_composite if normalize_weights
                 else weighted_sum_composite)
    rgb = composite(frags.idx, weights, features[..., :3],
                    gathered_features=gathered[..., 1:])
    rgba = torch.cat([rgb, frags.occupancy[..., None]], dim=-1)
    return RenderOutput(rgba=rgba, fragments=frags, visibility=frags.visibility)
