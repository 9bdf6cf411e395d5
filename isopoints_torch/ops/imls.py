"""Implicit moving least squares: an oriented point cloud to a signed
distance field, and its mesh (port of isopoints_tpu/ops/imls.py).

At a query x the field is the Gaussian-weighted mean of the point-to-plane
distances ⟨x − pᵢ, nᵢ⟩ over its k nearest points, the bandwidth set by the
nearest one; where no weight survives, the unsigned distance to the nearest
point. The neighbours come from `knn_points` (the kNN kernel on CUDA
tensors). `project_to_latent_surface` moves points onto the cloud's latent
RIMLS surface on the same neighbours.
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


@torch.no_grad()
def project_to_latent_surface(points: torch.Tensor, normals: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              k: int = 16, iters: int = 2,
                              weight_iters: int = 3,
                              sharpness_sigma: float = 0.75) -> torch.Tensor:
    """RIMLS projection of each point onto the cloud's latent MLS surface
    (imls.py:52-101). `iters` times: the k nearest cloud points of each
    moved point (its own index excluded), spatial weights exp(−d²/h²) with
    h² = 2·d₁², `weight_iters` robust re-weightings (residual × normal
    bilateral), then a move along the weighted mean normal by the weighted
    mean plane residual. points, normals (B, P, 3), mask (B, P) ->
    moved points (B, P, 3); masked points stay."""
    if mask is None:
        mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)

    nrm = unit(normals)
    inv_sig_n = 1.0 / (sharpness_sigma * sharpness_sigma)
    x = points
    for _ in range(iters):
        res = knn_points(x, points, mask, mask, k=k, exclude_self=True)
        nn = knn_gather(points, res.idx)                   # (B, P, K, 3)
        nn_n = knn_gather(nrm, res.idx)
        h2 = torch.clamp(res.dists[..., :1] * 2.0, min=1e-12)
        w_sp = torch.where(res.mask, torch.exp(-res.dists / h2), 0.0)
        f = torch.sum((x[:, :, None, :] - nn) * nn_n, dim=-1)   # plane residuals
        w = w_sp
        for _ in range(weight_iters):
            mean_f = torch.sum(w * f, dim=-1, keepdim=True) / \
                eps_denom(torch.sum(w, dim=-1, keepdim=True), 1e-12)
            w_res = torch.exp(-((f - mean_f) ** 2) / torch.clamp(h2, min=1e-12))
            avg_n = unit(torch.sum(w[..., None] * nn_n, dim=-2))
            w_n = torch.exp(-torch.sum((nn_n - avg_n[:, :, None, :]) ** 2, dim=-1)
                            * inv_sig_n)
            w = torch.where(res.mask, w_sp * w_res * w_n, 0.0)
        avg_n = unit(torch.sum(w[..., None] * nn_n, dim=-2))
        move = torch.sum(w * f, dim=-1) / eps_denom(torch.sum(w, dim=-1), 1e-12)
        x = torch.where(mask[..., None], x - move[..., None] * avg_n, x)
    return x


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
