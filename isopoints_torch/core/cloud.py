"""Padded point cloud and its named filters (port of
isopoints_tpu/core/cloud.py): `(B, P, C)` arrays with a `(B, P)` bool
validity mask. Every `with_*` and transform returns a new cloud; the
capacity changes only through `utils.resize_padded`. The random subsample
takes its uniform draws as a tensor or a `torch.Generator`."""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from isopoints_torch.utils import masked_mean, num_valid


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

    @property
    def capacity(self) -> int:
        return self.points.shape[1]

    def lengths(self) -> torch.Tensor:
        """Valid points a cloud (B,)."""
        return num_valid(self.mask)

    def with_points(self, points) -> "PointCloud":
        return dataclasses.replace(self, points=points)

    def with_normals(self, normals) -> "PointCloud":
        return dataclasses.replace(self, normals=normals)

    def with_features(self, features) -> "PointCloud":
        return dataclasses.replace(self, features=features)

    def with_mask(self, mask) -> "PointCloud":
        return dataclasses.replace(self, mask=mask)

    def compact(self) -> "PointCloud":
        """Valid points to the front, in their order (cloud.py:71-81)."""
        order = torch.argsort((~self.mask).to(torch.uint8), dim=-1, stable=True)

        def g(x):
            return None if x is None else torch.gather(
                x, 1, order[..., None].expand(-1, -1, x.shape[-1]))
        return dataclasses.replace(self, points=g(self.points),
                                   normals=g(self.normals),
                                   features=g(self.features),
                                   mask=torch.gather(self.mask, 1, order))

    def bounding_box(self):
        """Masked per-cloud min and max corners ((B, 3), (B, 3)); a cloud
        with no valid point gives ±the dtype's largest value
        (cloud.py:83-89)."""
        big = torch.finfo(self.points.dtype).max
        m = self.mask[..., None]
        lo = torch.amin(torch.where(m, self.points, big), dim=1)
        hi = torch.amax(torch.where(m, self.points, -big), dim=1)
        return lo, hi

    def normalize_to_sphere(self, radius: float = 1.0):
        """Centre on the valid points' mean and scale so they fit a sphere
        of `radius` (cloud.py:91-101): x' = (x − c)/s. Returns (cloud,
        center (B, 1, 3), scale (B, 1, 1))."""
        center = masked_mean(self.points, self.mask, axis=1, keepdims=True)
        d = torch.linalg.norm(self.points - center, dim=-1)
        d = torch.where(self.mask, d, 0.0)
        scale = torch.amax(d, dim=1, keepdim=True)[..., None] / radius
        scale = torch.clamp(scale, min=1e-12)
        return (dataclasses.replace(self, points=(self.points - center) / scale),
                center, scale)

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

    def subsample_randomly(self, ratio: float, u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> "PointCloud":
        """Keep each valid point where its uniform [0, 1) draw is below
        `ratio`, then compact (cloud.py:113-116). `u`: the draws, shaped
        like the mask (the JAX package draws them from its key); else drawn
        from `generator`."""
        if u is None:
            u = torch.rand(self.mask.shape, generator=generator,
                           device=self.mask.device)
        return self.with_mask(self.mask & (u < ratio)).compact()


@dataclass(frozen=True)
class PointCloudFilters:
    """Named boolean masks over a padded cloud (cloud.py:120-141):
    `inmask`, `activation`, `visibility`, each (B, P) or None."""
    inmask: Optional[torch.Tensor] = None
    activation: Optional[torch.Tensor] = None
    visibility: Optional[torch.Tensor] = None

    def combined(self, base_mask: torch.Tensor) -> torch.Tensor:
        """`base_mask` and every filter that is set."""
        m = base_mask
        for f in (self.inmask, self.activation, self.visibility):
            if f is not None:
                m = m & f
        return m

    def filter_cloud(self, pc: PointCloud) -> PointCloud:
        return pc.with_mask(self.combined(pc.mask))
