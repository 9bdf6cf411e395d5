"""Math helpers (port of isopoints_tpu/utils/mathutils.py, the angle
conversions the point model stores its normals in; the 3×3 `eigh` frames
wait for the anisotropic splats, ROADMAP Queue 1 item 8)."""

from typing import Tuple

import torch


def vectors_to_angles(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit vectors -> (azimuth, elevation) (mathutils.py:100-105)."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    return torch.atan2(y, x), torch.asin(torch.clamp(z, -1.0, 1.0))


def angles_to_vectors(azim: torch.Tensor, elev: torch.Tensor) -> torch.Tensor:
    """(azimuth, elevation) -> unit vectors (mathutils.py:108-111)."""
    ce = torch.cos(elev)
    return torch.stack([ce * torch.cos(azim), ce * torch.sin(azim),
                        torch.sin(elev)], dim=-1)
