"""The one generator of render traffic, driven by a mix's data file.

A mix names `views` a request, `image_size`, `elevation_deg`,
`azimuth_step_deg` between the views of a request, `rays_per_chunk` (the
generator's chunk a view) and the `check` sample. Request i looks at the
origin from `views` cameras on the ring at the configuration's
`camera_distance`, the first at azimuth a0 + i·φ (mod 360), where a0 is
drawn from the seed and φ is the golden angle, so the requests of a
window cover the ring evenly whatever its length and every seed renders
the same spread of views in another order.
"""

import math
from typing import Tuple

import torch

GOLDEN_DEG = 180.0 * (3.0 - math.sqrt(5.0))


def look_at(dist: float, elev_deg: torch.Tensor, azim_deg: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R (B, 3, 3), T (B, 3)) of cameras at `dist` on the ring looking at
    the origin, y up; row-vector world-to-view X·R + T."""
    e, a = torch.deg2rad(elev_deg), torch.deg2rad(azim_deg)
    pos = torch.stack([dist * torch.cos(e) * torch.sin(a), dist * torch.sin(e),
                       dist * torch.cos(e) * torch.cos(a)], dim=-1)
    z = -pos / torch.linalg.norm(pos, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], dim=-1)
    T = -torch.einsum("bi,bij->bj", pos, R)
    return R, T


class Traffic:
    """The requests of one run of a mix under a configuration's cameras."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.views = int(mix["views"])
        self.size = int(mix["image_size"])
        self.dist = float(config["data"]["camera_distance"])
        self.focal = float(config["data"]["focal_length"])
        g = torch.Generator().manual_seed((int(seed) * 7919 + 3) % (1 << 62))
        self.a0 = float(torch.rand((), generator=g)) * 360.0

    @property
    def rays_per_request(self) -> int:
        return self.views * self.size * self.size

    def cameras(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, T) float32 on the host of request i (i = -1: the warm-up)."""
        step = float(self.mix["azimuth_step_deg"])
        a = (self.a0 + i * GOLDEN_DEG
             + step * torch.arange(self.views, dtype=torch.float64)) % 360.0
        e = torch.full((self.views,), float(self.mix["elevation_deg"]),
                       dtype=torch.float64)
        R, T = look_at(self.dist, e, a)
        return R.float(), T.float()
