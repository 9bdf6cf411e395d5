"""Padded point cloud (port of isopoints_tpu/core/cloud.py, the parts the
point model, the renderer and the DTU workload use): `(B, P, C)` arrays
with a `(B, P)` bool validity mask; `with_features` returns a new cloud;
`bounding_box` and `normalize_to_box`. Compaction, the sphere
normalisation and the named filters are not ported yet (ROADMAP Queue 1
item 2)."""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PointCloud:
    points: torch.Tensor                     # (B, P, 3)
    mask: torch.Tensor                       # (B, P) bool
    normals: Optional[torch.Tensor] = None   # (B, P, 3)
    features: Optional[torch.Tensor] = None  # (B, P, C), colours etc.

    @classmethod
    def create(cls, points, normals=None, features=None, mask=None) -> "PointCloud":
        """A cloud from (P, …) or (B, P, …) arrays; the mask defaults to
        all valid."""
        points = torch.as_tensor(points)
        if points.dim() == 2:
            lift = lambda x: None if x is None else torch.as_tensor(x)[None]
            points, normals, features, mask = (points[None], lift(normals),
                                               lift(features), lift(mask))
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        return cls(points=points, mask=mask, normals=normals, features=features)

    @property
    def batch_size(self) -> int:
        return self.points.shape[0]

    def with_features(self, features) -> "PointCloud":
        return dataclasses.replace(self, features=features)

    def bounding_box(self):
        """Masked per-cloud min and max corners ((B, 3), (B, 3)); a cloud
        with no valid point gives ±the dtype's largest value
        (cloud.py:83-89)."""
        big = torch.finfo(self.points.dtype).max
        m = self.mask[..., None]
        lo = torch.amin(torch.where(m, self.points, big), dim=1)
        hi = torch.amax(torch.where(m, self.points, -big), dim=1)
        return lo, hi

    def normalize_to_box(self, side: float = 2.0):
        """Centre and scale so the bounding box fits a cube of `side`
        (cloud.py:103-111): x' = (x − c)/s. Returns (cloud, center (B, 1, 3),
        scale (B, 1, 1))."""
        lo, hi = self.bounding_box()
        center = ((lo + hi) / 2.0)[:, None, :]
        scale = (torch.amax(hi - lo, dim=-1) / side)[:, None, None]
        scale = torch.clamp(scale, min=1e-12)
        return (dataclasses.replace(self, points=(self.points - center) / scale),
                center, scale)
