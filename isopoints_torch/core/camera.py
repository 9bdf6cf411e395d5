"""Perspective cameras in the pytorch3d screen convention (port of
isopoints_tpu/core/camera.py:30-185).

  - Row-vector world->view: X_view = X_world @ R + T.
  - Screen axes: +X left, +Y up, +Z into the screen.
  - NDC: x_ndc = fx·x_view/z + px; pixel centers at ndc = (S − 2i − 1)/S.
  - `project_ndc` keeps z = view-space depth (the rasterizer convention).

Float32 products here run at full precision: keep
`torch.backends.cuda.matmul.allow_tf32` False (PyTorch's default) on CUDA.
"""

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from isopoints_torch.utils import eps_denom


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class PerspectiveCamera:
    """B cameras: R (B, 3, 3), T (B, 3), focal_length / principal_point
    (B, 2) in NDC units."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor

    @classmethod
    def create(cls, R=None, T=None, focal_length=1.0,
               principal_point=(0.0, 0.0), batch_size: Optional[int] = None,
               device=None) -> "PerspectiveCamera":
        R = torch.eye(3, device=device)[None] if R is None else _f32(R, device)
        if R.dim() == 2:
            R = R[None]
        b = batch_size or R.shape[0]
        if R.shape[0] == 1 and b > 1:
            R = R.repeat(b, 1, 1)
        T = torch.zeros((b, 3), device=R.device) if T is None else _f32(T, R.device)
        if T.dim() == 1:
            T = T[None]
        if T.shape[0] == 1 and b > 1:
            T = T.repeat(b, 1)
        fl = _f32(focal_length, R.device)
        if fl.dim() == 0:
            fl = fl[None, None]
        if fl.dim() == 1:
            fl = fl[None]
        if fl.shape[-1] == 1:
            fl = fl.repeat(1, 2)
        if fl.shape[0] == 1 and b > 1:
            fl = fl.repeat(b, 1)
        pp = _f32(principal_point, R.device)
        if pp.dim() == 1:
            pp = pp[None]
        if pp.shape[0] == 1 and b > 1:
            pp = pp.repeat(b, 1)
        return cls(R=R, T=T, focal_length=fl, principal_point=pp)

    @property
    def batch_size(self) -> int:
        return self.R.shape[0]

    def _expand(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        """(B, k) -> (B, 1, ..., 1, k) for points of `ndim` dims."""
        return v.reshape(v.shape[0], *([1] * (ndim - 2)), v.shape[-1])

    def world_to_view(self, pts: torch.Tensor) -> torch.Tensor:
        """pts (B, ..., 3) -> view coords."""
        return (torch.einsum("b...i,bij->b...j", pts, self.R)
                + self._expand(self.T, pts.dim()))

    def camera_center(self) -> torch.Tensor:
        """World-space camera centers (B, 3): C = −T Rᵀ."""
        return -torch.einsum("bi,bji->bj", self.T, self.R)

    def project_ndc(self, pts: torch.Tensor) -> torch.Tensor:
        """World -> (..., 3) [x_ndc, y_ndc, view-space depth z]."""
        view = self.world_to_view(pts)
        z = eps_denom(view[..., 2:3], 1e-8)
        fl = self._expand(self.focal_length, pts.dim())
        pp = self._expand(self.principal_point, pts.dim())
        xy = view[..., :2] / z * fl + pp
        return torch.cat([xy, view[..., 2:3]], dim=-1)

    def ndc_to_rays(self, ndc_xy: torch.Tensor):
        """NDC points (B, N, 2) -> (centers (B, 3), unit dirs (B, N, 3))."""
        fl = self.focal_length[:, None, :]
        pp = self.principal_point[:, None, :]
        xy_view = (ndc_xy - pp) / fl
        dirs_view = torch.cat([xy_view, torch.ones_like(xy_view[..., :1])], -1)
        dirs = torch.einsum("bni,bij->bnj", dirs_view, self.R.transpose(-1, -2))
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        return self.camera_center(), dirs


def look_at_rotation(camera_position, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                     device=None) -> torch.Tensor:
    """R such that a camera at `camera_position` looks at `at`."""
    pos = _f32(camera_position, device)
    if pos.dim() == 1:
        pos = pos[None]
    at_ = torch.broadcast_to(_f32(at, pos.device), pos.shape)
    up_ = torch.broadcast_to(_f32(up, pos.device), pos.shape)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-12)

    z_axis = unit(at_ - pos)
    x_axis = torch.linalg.cross(up_, z_axis)
    x_norm = torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    fallback = torch.linalg.cross(
        torch.broadcast_to(_f32((0.0, 0.0, 1.0), pos.device), z_axis.shape),
        z_axis)
    x_axis = unit(torch.where(x_norm > 1e-6, x_axis, fallback))
    y_axis = torch.linalg.cross(z_axis, x_axis)
    return torch.stack([x_axis, y_axis, z_axis], dim=-1)   # columns = axes


def look_at_view_transform(dist, elev, azim, at=(0.0, 0.0, 0.0),
                           degrees: bool = True, device=None):
    """(R, T) for cameras on a sphere looking at `at`."""
    dist, elev, azim = (torch.atleast_1d(_f32(v, device))
                        for v in (dist, elev, azim))
    b = max(dist.shape[0], elev.shape[0], azim.shape[0])
    dist, elev, azim = (torch.broadcast_to(v, (b,)) for v in (dist, elev, azim))
    if degrees:
        elev = elev * math.pi / 180.0
        azim = azim * math.pi / 180.0
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    pos = torch.stack([x, y, z], dim=-1) + _f32(at, dist.device)
    R = look_at_rotation(pos, at=at, device=dist.device)
    T = -torch.einsum("bi,bij->bj", pos, R)
    return R, T


def cameras_from_matrices(cam_mats: Sequence, focal_length, principal_point,
                          device=None) -> PerspectiveCamera:
    """Cameras from the dataset's 4x4 `camera_mat` rows (R = m[:3, :3],
    T = m[3, :3]), as train_mvr.py builds them."""
    m = _f32(cam_mats, device)
    return PerspectiveCamera.create(R=m[:, :3, :3], T=m[:, 3, :3],
                                    focal_length=focal_length,
                                    principal_point=principal_point,
                                    device=device)
