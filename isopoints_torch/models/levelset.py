"""Implicit-differentiation sample networks (port of
isopoints_tpu/models/levelset.py:484-519; the Newton projection and the
resampling machinery are not ported yet, ROADMAP Queue 1 items 5 and 8).

Frozen surface points are re-attached to the parameters θ with
`p0 − (f − sg f)·...`: the value is the frozen point, the θ-gradient is
the implicit one (paper Eq. 13 / IDR Eq. 3). `sg` is `.detach()`.
"""

from typing import Callable

import torch

from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.utils import eps_denom

SDFFn = Callable[[torch.Tensor], torch.Tensor]


def _frozen_grad(sdf_fn: SDFFn, p0: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return sdf_and_grad(sdf_fn, p0)[1]


def sample_network(sdf_fn: SDFFn, iso_points: torch.Tensor) -> torch.Tensor:
    """Value == iso_points; d/dθ == −∇f/|∇f|² · ∂f/∂θ. `sdf_fn` must
    use the parameters being differentiated."""
    p0 = iso_points.detach()
    f = sdf_fn(p0)
    grad = _frozen_grad(sdf_fn, p0)
    ssg = torch.sum(grad * grad, dim=-1, keepdim=True)
    return p0 - (f - f.detach())[..., None] * grad / eps_denom(ssg, 1e-17)


def directional_sample_network(sdf_fn: SDFFn, iso_points: torch.Tensor,
                               rays: torch.Tensor,
                               cam_pos: torch.Tensor) -> torch.Tensor:
    """Differentiable depth along fixed rays:
    t(θ) = t0 − (f − sg f)/⟨sg ∇f, ray⟩; x = cam + t·ray."""
    p0 = iso_points.detach()
    f = sdf_fn(p0)
    grad = _frozen_grad(sdf_fn, p0)
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-15)
    ray0 = rays.detach()
    t0 = torch.linalg.norm(p0 - cam_pos, dim=-1, keepdim=True)
    dot = torch.sum(grad * ray0, dim=-1, keepdim=True)
    t = t0 - (f - f.detach())[..., None] / eps_denom(dot, 1e-10)
    return cam_pos + t * rays
