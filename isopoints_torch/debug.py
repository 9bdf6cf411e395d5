"""Gradient taps for debugging (port of isopoints_tpu/debug.py).

With debugging on (`set_debugging_mode_(True)`), `tap_grad(name, x)`
registers a tensor hook that stores x and dL/dx under `name` in the
global `DebugState` when the backward pass reaches x, and
`tap_image_grad(x)` stores the gradient of a rendered mask image. Both
return x itself and change no value and no gradient; with debugging off,
or on a tensor that needs no gradient, they register nothing. The stored
tensors are detached and stay on x's device. The taps sit where the JAX
package puts them: the iso-points of the implicit and the combined
forward ("iso") and the point model's rendered mask channel.
"""

from typing import Dict, Optional

import torch


class DebugState:
    """Per-named-point-set positions and gradients, and the mask-image
    gradient, as tensors."""

    def __init__(self):
        self.pts_world: Dict[str, torch.Tensor] = {}
        self.pts_world_grad: Dict[str, torch.Tensor] = {}
        self.img_mask_grad: Optional[torch.Tensor] = None

    def clear(self) -> None:
        self.pts_world.clear()
        self.pts_world_grad.clear()
        self.img_mask_grad = None


_DEBUG = False
_STATE = DebugState()


def set_debugging_mode_(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)
    if not _DEBUG:
        _STATE.clear()


def get_debugging_mode() -> bool:
    return _DEBUG


def get_debugging_tensor() -> DebugState:
    return _STATE


def tap_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """x, with dL/dx recorded for point set `name` when debugging."""
    if _DEBUG and x.requires_grad:
        pos = x.detach()

        def hook(g):
            _STATE.pts_world[name] = pos
            _STATE.pts_world_grad[name] = g.detach()

        x.register_hook(hook)
    return x


def tap_image_grad(x: torch.Tensor) -> torch.Tensor:
    """x, with the gradient of the rendered mask image recorded when
    debugging (the reference's DebuggingTensor.img_mask_grad)."""
    if _DEBUG and x.requires_grad:
        def hook(g):
            _STATE.img_mask_grad = g.detach()

        x.register_hook(hook)
    return x
