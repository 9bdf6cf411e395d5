"""Per-point Phong texturing (port of isopoints_tpu/rendering/texture.py
`lighting_texture`; the neural texture waits for RenderingNetwork)."""

from typing import Optional

import torch

from isopoints_torch.rendering.lighting import DirectionalLights, apply_lighting


def lighting_texture(points: torch.Tensor, normals: torch.Tensor,
                     lights: DirectionalLights, camera_position: torch.Tensor,
                     points_rgb: Optional[torch.Tensor] = None,
                     shininess: float = 64.0) -> torch.Tensor:
    """rgb·(ambient + diffuse) + specular."""
    if points_rgb is None:
        points_rgb = torch.ones_like(points)
    ambient, diff, spec = apply_lighting(points, normals, lights,
                                         camera_position, shininess)
    return points_rgb * (ambient[:, None, :] + diff) + spec
