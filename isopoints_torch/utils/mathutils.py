"""Math helpers (port of isopoints_tpu/utils/mathutils.py: the local
frames of 3×3 covariances by `eigh`, normals and the curvature proxy, and
the angle conversions the point model stores its normals in, the SVD
`pinverse` of the DTU workload's heat-kernel weights, `to_homogen` and the
masked Welford `RunningStat`). JAX's `ndc_to_pix` / `pix_to_ndc` are
ops/images.py's `ndc_to_pix_coords` / `pix_to_ndc_coords`."""

from typing import Optional, Tuple

import torch

from isopoints_torch.utils import eps_denom


# 3×3 matrices a torch.linalg.eigh call: cuSOLVER's batched syev (PyTorch
# 2.11, CUDA 12.8, on an H100) refuses 32,768 and more in one call with
# CUSOLVER_STATUS_INVALID_VALUE, and takes 16,384
EIGH_CHUNK = 1 << 14


def pinverse(mat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Batched pseudo-inverse by SVD with the relative cutoff eps·max(s)
    (mathutils.py:17-26): singular values at or below it invert to 0, so an
    all-zero matrix gives all zeros. Written out rather than
    `torch.linalg.pinv`, whose cutoff keeps a value equal to it."""
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    cutoff = eps * torch.amax(s, dim=-1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / torch.clamp(s, min=1e-30), 0.0)
    # A = U S Vh  =>  A+ = Vh^T S^-1 U^T
    return torch.einsum("...ji,...j,...kj->...ik", vh, s_inv, u)


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
    flat = cov.reshape(-1, 3, 3)
    if flat.shape[0] <= EIGH_CHUNK:
        return torch.linalg.eigh(cov)
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_CHUNK)]
    return (torch.cat([p[0] for p in parts]).reshape(cov.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(cov.shape))


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


def to_homogen(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with a trailing 1 (mathutils.py:95-97)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


class RunningStat:
    """Masked Welford running mean and variance over per-point scalars
    (mathutils.py:134-160); `update` returns a new statistic."""

    def __init__(self, shape, device=None):
        self.n = torch.zeros(shape, dtype=torch.float32, device=device)
        self.mean = torch.zeros_like(self.n)
        self.m2 = torch.zeros_like(self.n)

    def update(self, value: torch.Tensor, mask: torch.Tensor) -> "RunningStat":
        m = mask.to(torch.float32)
        out = RunningStat(self.n.shape, self.n.device)
        out.n = self.n + m
        delta = value - self.mean
        out.mean = self.mean + torch.where(
            out.n > 0, delta * m / torch.clamp(out.n, min=1.0), 0.0)
        out.m2 = self.m2 + delta * (value - out.mean) * m
        return out

    @property
    def variance(self) -> torch.Tensor:
        return self.m2 / torch.clamp(self.n - 1.0, min=1.0)
