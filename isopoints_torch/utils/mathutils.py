"""Math helpers (port of isopoints_tpu/utils/mathutils.py: the local
frames of 3×3 covariances by `eigh`, normals and the curvature proxy, and
the angle conversions the point model stores its normals in; `pinverse`
waits for its caller, ROADMAP Queue 1 item 11)."""

from typing import Optional, Tuple

import torch

from isopoints_torch.utils import eps_denom


def local_coord_frames(points: torch.Tensor, nn: torch.Tensor,
                       nn_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvector columns [normal, tangent,
    tangent] of the masked covariance of each point's K neighbours
    (mathutils.py:29-60). points (..., P, 3), nn (..., P, K, 3), nn_mask
    (..., P, K). Returns ((..., P, 3), (..., P, 3, 3))."""
    if nn_mask is None:
        w = torch.ones(nn.shape[:-1], dtype=nn.dtype, device=nn.device)
    else:
        w = nn_mask.to(nn.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    centroid = torch.sum(nn * w[..., None], dim=-2) / wsum
    centered = (nn - centroid[..., None, :]) * w[..., None]
    cov = torch.einsum("...ki,...kj->...ij", centered, centered) / wsum[..., None]
    return torch.linalg.eigh(cov)


def disambiguate_normals(normals: torch.Tensor, points: torch.Tensor,
                         viewpoint: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Flip each normal to point away from the origin, or towards
    `viewpoint` (mathutils.py:63-76)."""
    ref_dir = points if viewpoint is None else viewpoint - points
    sign = torch.sign(torch.sum(normals * ref_dir, dim=-1, keepdim=True))
    return normals * torch.where(sign == 0, 1.0, sign)


def estimate_normals(points: torch.Tensor, nn: torch.Tensor,
                     nn_mask: Optional[torch.Tensor] = None,
                     disambiguate: bool = True) -> torch.Tensor:
    """The smallest eigenvalue's eigenvector (mathutils.py:79-87)."""
    normals = local_coord_frames(points, nn, nn_mask)[1][..., :, 0]
    return disambiguate_normals(normals, points) if disambiguate else normals


def curvature_proxy(evals: torch.Tensor) -> torch.Tensor:
    """Surface variation l0/(l0+l1+l2), in [0, 1/3] (mathutils.py:90-92)."""
    return evals[..., 0] / eps_denom(torch.sum(evals, dim=-1), 1e-12)


def vectors_to_angles(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit vectors -> (azimuth, elevation) (mathutils.py:100-105)."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    return torch.atan2(y, x), torch.asin(torch.clamp(z, -1.0, 1.0))


def angles_to_vectors(azim: torch.Tensor, elev: torch.Tensor) -> torch.Tensor:
    """(azimuth, elevation) -> unit vectors (mathutils.py:108-111)."""
    ce = torch.cos(elev)
    return torch.stack([ce * torch.cos(azim), ce * torch.sin(azim),
                        torch.sin(elev)], dim=-1)
