"""DVR-style occupancy scene model (port of isopoints_tpu/models/occupancy.py).

An ONet occupancy decoder (`OccupancyField`) whose logits, shifted by
logit(tau), are > 0 inside. Rays are clipped to the padded cube; the first
outside-to-inside crossing of the logits on each is found by a 100-step
sweep and refined by the secant (`find_zero_crossing_between_point_pairs`
in the occupancy convention). The forward pass adds the freespace and
occupancy targets: the largest logit over `n_steps` candidates a ray
(their fractions of the segment passed in, as the JAX model draws them
from its key), to be pushed down on rays outside the mask and up on rays
inside it that found no crossing (`occupancy_bce_loss`). The products are
plain layers (`nn.Linear`), as the JAX package computes them outside any
Pallas kernel. The crossing search runs without autograd: the surface
points carry no gradient, and the logit targets carry the decoder's.
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.models.fields import OccupancyField
from isopoints_torch.models.raytracing import (
    find_zero_crossing_between_point_pairs, intersection_with_unit_cube)
from isopoints_torch.ops.images import sample_image_at_ndc
from isopoints_torch.training.losses import reduce_loss
from isopoints_torch.utils import fma


class OccupancyOutput(NamedTuple):
    surface_points: torch.Tensor    # (B, N, 3) first crossings
    surface_mask: torch.Tensor      # (B, N) valid crossing & in the GT mask
    network_mask: torch.Tensor      # (B, N) valid crossing
    logits_freespace: torch.Tensor  # (B, N) the largest candidate logit
    freespace_mask: torch.Tensor
    logits_occupancy: torch.Tensor
    occupancy_mask: torch.Tensor


@dataclass(frozen=True)
class OccupancyConfig:
    object_bounding_sphere: float = 1.0
    n_steps: int = 100
    n_secant_steps: int = 8
    tau: float = 0.5   # the occupancy threshold; logits are shifted by logit(tau)


class OccupancyModel(nn.Module):
    """Occupancy decoder + DVR ray marching (occupancy.py:47-131)."""

    def __init__(self, decoder: Optional[OccupancyField] = None,
                 cfg: OccupancyConfig = OccupancyConfig(), device=None):
        super().__init__()
        self.decoder = decoder if decoder is not None else OccupancyField(device=device)
        self.cfg = cfg
        self._tau_logit = math.log(cfg.tau / (1.0 - cfg.tau))

    def logits_fn(self):
        """x -> raw occupancy logits minus logit(tau): > 0 inside."""
        return lambda x: self.decoder(x)[..., 0] - self._tau_logit

    def _rays(self, ndc_pixels: torch.Tensor, camera: PerspectiveCamera):
        cam_pos = camera.camera_center()[:, None, :]
        _, dirs = camera.ndc_to_rays(ndc_pixels)
        return intersection_with_unit_cube(
            cam_pos, dirs, side_length=self.cfg.object_bounding_sphere * 2)

    def pixels_to_world(self, ndc_pixels: torch.Tensor,
                        camera: PerspectiveCamera,
                        rays: Optional[Tuple[torch.Tensor, ...]] = None):
        """The first outside-to-inside crossing on each cube-clipped ray
        (occupancy.py:76-97); `rays` may carry (entry, exit, hit)."""
        entry, exit_, hit = rays if rays is not None else self._rays(ndc_pixels, camera)
        pts, mask = find_zero_crossing_between_point_pairs(
            self.logits_fn(), entry, exit_, n_steps=self.cfg.n_steps,
            n_secant_steps=self.cfg.n_secant_steps, is_occupancy=True)
        return pts, mask & hit

    def forward(self, ndc_pixels: torch.Tensor, mask_img: torch.Tensor,
                camera: PerspectiveCamera, steps: torch.Tensor) -> OccupancyOutput:
        """Crossings and the freespace / occupancy logit targets
        (occupancy.py:99-126). `steps` (n_steps,): the candidates'
        fractions of each segment."""
        f = self.logits_fn()
        mask_gt = sample_image_at_ndc(mask_img, ndc_pixels, mode="nearest")[..., 0] > 0.5
        entry, exit_, hit = self._rays(ndc_pixels, camera)
        pts, net_mask = self.pixels_to_world(ndc_pixels, camera,
                                             rays=(entry, exit_, hit))
        # candidates: the most occupied of n_steps points on each ray
        cand = fma(steps[:, None], (exit_ - entry)[..., None, :], entry[..., None, :])
        best_logit = torch.amax(f(cand.detach()), dim=-1)
        free_mask = ~mask_gt & hit
        occ_mask = mask_gt & ~net_mask & hit
        return OccupancyOutput(
            surface_points=pts, surface_mask=net_mask & mask_gt,
            network_mask=net_mask, logits_freespace=best_logit,
            freespace_mask=free_mask, logits_occupancy=best_logit,
            occupancy_mask=occ_mask)

    @torch.no_grad()
    def generate_mesh(self, resolution: int = 128):
        """The mesh of the tau level set (occupancy.py:128-131)."""
        from isopoints_torch.utils.meshing import extract_mesh

        f = self.logits_fn()
        return extract_mesh(lambda x: -f(x), resolution=resolution,
                            device=next(self.parameters()).device)


def occupancy_bce_loss(logits: torch.Tensor, target_inside: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       reduction: str = "mean") -> torch.Tensor:
    """BCE on occupancy logits: softplus(l) − t·l (occupancy.py:134-139)."""
    t = target_inside.to(logits.dtype)
    return reduce_loss(torch.nn.functional.softplus(logits) - t * logits, mask,
                       reduction)
