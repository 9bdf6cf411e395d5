"""Implicit moving least squares: an oriented point cloud to a signed
distance field, and its mesh (port of isopoints_tpu/ops/imls.py).

At a query x the field is the Gaussian-weighted mean of the point-to-plane
distances ⟨x − pᵢ, nᵢ⟩ over its k nearest points, the bandwidth set by the
nearest one; where no weight survives, the unsigned distance to the nearest
point. The neighbours come from `knn_points` (the kNN kernel on CUDA
tensors). `project_to_latent_surface` (the RIMLS projection) is not ported:
no workload of either package calls it (ROADMAP Queue 1 item 14).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.utils import eps_denom


@torch.no_grad()
def imls_sdf(query: torch.Tensor, points: torch.Tensor, normals: torch.Tensor,
             mask: Optional[torch.Tensor] = None, k: int = 8,
             sigma_scale: float = 2.0) -> torch.Tensor:
    """IMLS signed distance (imls.py:25): query (B, N, 3), points and normals
    (B, P, 3), mask (B, P). Returns (B, N), positive along the normals."""
    res = knn_points(query, points, None, mask, k=k)
    nn = knn_gather(points, res.idx)                       # (B, N, K, 3)
    nnn = knn_gather(normals, res.idx)
    nnn = nnn / torch.clamp(torch.linalg.norm(nnn, dim=-1, keepdim=True),
                            min=1e-12)
    # bandwidth from the local spacing (nearest-neighbour distance)
    h2 = torch.clamp(res.dists[..., :1], min=1e-12) * sigma_scale ** 2
    w = torch.where(res.mask, torch.exp(-res.dists / h2), 0.0)
    d_plane = torch.sum((query[:, :, None, :] - nn) * nnn, dim=-1)
    w_sum = torch.sum(w, dim=-1)
    sdf = torch.sum(w * d_plane, dim=-1) / eps_denom(w_sum, 1e-12)
    # far-field fallback: the unsigned distance keeps the field monotone
    far = torch.sqrt(torch.clamp(res.dists[..., 0], min=0.0))
    return torch.where(w_sum < 1e-12, far, sdf)


def pointcloud_to_mesh(points: np.ndarray, normals: np.ndarray,
                       resolution: int = 128, k: int = 8,
                       padding: float = 0.1, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh an oriented cloud (P, 3) by IMLS on a grid over its bounding
    box padded by `padding`, then marching tetrahedra (imls.py:104)."""
    from isopoints_torch.utils.meshing import extract_mesh

    dev = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None]
    nrm = torch.as_tensor(np.asarray(normals, np.float32), device=dev)[None]
    lo = np.asarray(points).min(axis=0) - padding
    hi = np.asarray(points).max(axis=0) + padding

    def f(x):
        return imls_sdf(x.reshape(1, -1, 3), pts, nrm, k=k).reshape(x.shape[:-1])

    return extract_mesh(f, resolution=resolution, bbox_min=tuple(lo),
                        bbox_max=tuple(hi), device=dev)
