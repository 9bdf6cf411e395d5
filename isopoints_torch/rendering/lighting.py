"""Multi-source Phong lighting (port of isopoints_tpu/rendering/lighting.py,
directional lights). Batched (B, L, 3) light arrays against (B, P, 3)
points."""

from dataclasses import dataclass

import torch


def _unit(v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _as_bl3(v, device) -> torch.Tensor:
    """(3,) | (L, 3) | (B, L, 3) -> (B, L, 3)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    while v.dim() < 3:
        v = v[None]
    return v


def diffuse(normals: torch.Tensor, color: torch.Tensor,
            direction: torch.Tensor) -> torch.Tensor:
    """Lambertian sum over L sources; `direction` points toward the light.
    normals (B, P, 3), color/direction (B, L, 3) -> (B, P, 3)."""
    n = _unit(normals)[:, None]
    d = _unit(direction)[:, :, None]
    angle = torch.relu(torch.sum(n * d, dim=-1))
    return torch.sum(color[:, :, None, :] * angle[..., None], dim=1)


def specular(points: torch.Tensor, normals: torch.Tensor, color: torch.Tensor,
             direction: torch.Tensor, camera_position: torch.Tensor,
             shininess: float = 64.0) -> torch.Tensor:
    """Phong specular sum over L sources."""
    n = _unit(normals)[:, None]
    d = _unit(direction)[:, :, None]
    cos_angle = torch.sum(n * d, dim=-1)
    reflect = 2.0 * cos_angle[..., None] * n - d
    view = _unit(camera_position[:, None, None, :] - points[:, None])
    alpha = torch.relu(torch.sum(view * reflect, dim=-1)) ** shininess
    alpha = torch.where(cos_angle > 0, alpha, torch.zeros_like(alpha))
    return torch.sum(color[:, :, None, :] * alpha[..., None], dim=1)


@dataclass(frozen=True)
class DirectionalLights:
    """L directional sources per batch."""
    ambient_color: torch.Tensor   # (B, L, 3)
    diffuse_color: torch.Tensor   # (B, L, 3)
    specular_color: torch.Tensor  # (B, L, 3)
    direction: torch.Tensor       # (B, L, 3) toward the light

    @classmethod
    def create(cls, ambient_color=((0.5, 0.5, 0.5),),
               diffuse_color=((0.3, 0.3, 0.3),),
               specular_color=((0.2, 0.2, 0.2),),
               direction=((0.0, 1.0, 0.0),), device=None) -> "DirectionalLights":
        return cls(ambient_color=_as_bl3(ambient_color, device),
                   diffuse_color=_as_bl3(diffuse_color, device),
                   specular_color=_as_bl3(specular_color, device),
                   direction=_as_bl3(direction, device))

    def ambient(self) -> torch.Tensor:
        """(B, 3) summed over sources."""
        return torch.sum(self.ambient_color, dim=1)


def apply_lighting(points: torch.Tensor, normals: torch.Tensor,
                   lights: DirectionalLights, camera_position: torch.Tensor,
                   shininess: float = 64.0):
    """(ambient (B, 3), diffuse (B, P, 3), specular (B, P, 3))."""
    diff = diffuse(normals, lights.diffuse_color, lights.direction)
    spec = specular(points, normals, lights.specular_color, lights.direction,
                    camera_position, shininess)
    return lights.ambient(), diff, spec
