"""Padded point cloud (port of isopoints_tpu/core/cloud.py, the parts the
point model and the renderer use): `(B, P, C)` arrays with a `(B, P)` bool
validity mask; `with_features` returns a new cloud. Compaction,
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
