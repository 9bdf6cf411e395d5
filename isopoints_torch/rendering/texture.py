"""Per-point texturing (port of isopoints_tpu/rendering/texture.py):
Phong shading from the normals (`lighting_texture`) and the neural colour
field on [normals, points, embedded view direction] (`neural_texture`)."""

from typing import Optional

import torch

from isopoints_torch.models.fields import RenderingNetwork
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


def neural_texture(net: RenderingNetwork, points: torch.Tensor,
                   normals: torch.Tensor, view_dirs: torch.Tensor,
                   latent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Colour decoder on [normals, points, embed(view)] (texture.py:31-37;
    reference NeuralTexture, texture.py:130-162); `latent` (..., c_dim) is
    the network's conditional code, put in front of the features."""
    return net.apply_with_view(normals, points, view_dirs, c=latent)
