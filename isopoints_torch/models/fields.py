"""Implicit field networks (port of isopoints_tpu/models/fields.py).

`SirenField` is an `nn.Module` whose layers are `nn.Linear`s, so weights
sit in the same (out, in) layout as the JAX pytree's `w` (fields.py:95-116)
and convert one to one (`isopoints_torch.convert`). `sdf_and_grad` returns
the SDF and its input gradient, dispatching to a fused `.sdf_and_grad`
when the callable carries one (ops/fused_mlp.py), like the reference.

`SDFField` (IGR), `RenderingNetwork` and the occupancy field are not
ported yet (ROADMAP Queue 1 item 3).
"""

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn


def _uniform_linear(in_d: int, out_d: int, bound: float,
                    generator: Optional[torch.Generator],
                    device) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, in_d, out_d, device=device or "cpu")
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.zero_()
    return lin


class SirenField(nn.Module):
    """SIREN SDF MLP: first SineLayer(3 -> h), `n_layers` hidden
    SineLayers, linear head to the SDF (reference common.py:56-167). Init
    as the JAX field: first layer U(±1/3), the rest U(±√(6/h)/ω), zero
    biases. The JAX field's other heads (`out_dims`, `c_dim`, output
    activations) are not ported: the slice's configs use none of them."""

    def __init__(self, hidden_size: int = 256, n_layers: int = 3,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.first_omega_0 = first_omega_0
        self.hidden_omega_0 = hidden_omega_0
        bound = math.sqrt(6.0 / hidden_size) / hidden_omega_0
        layers = [_uniform_linear(3, hidden_size, 1.0 / 3, generator, device)]
        layers += [_uniform_linear(hidden_size, hidden_size, bound, generator,
                                   device) for _ in range(n_layers)]
        layers.append(_uniform_linear(hidden_size, 1, bound, generator, device))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 3) -> sdf (...)."""
        h = torch.sin(self.first_omega_0 * self.layers[0](x))
        for lin in self.layers[1:-1]:
            h = torch.sin(self.hidden_omega_0 * lin(h))
        return self.layers[-1](h)[..., 0]

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)


def sdf_and_grad(apply_sdf: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sdf, ∇ₓsdf) (parity: fields.py:392-405).

    A callable carrying a fused `.sdf_and_grad` (ops/fused_mlp.py) is
    dispatched to it. Otherwise autograd: with grad mode on, the gradient
    is built with `create_graph=True`, so it stays differentiable in the
    parameters and in `x` (the eikonal and shading losses need that, as
    the JAX vjp gives it); with grad mode off both outputs are detached.
    """
    fused = getattr(apply_sdf, "sdf_and_grad", None)
    if fused is not None:
        return fused(x)
    if not torch.is_grad_enabled():
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = apply_sdf(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    f = apply_sdf(x)
    (g,) = torch.autograd.grad(f.sum(), x, create_graph=True)
    return f, g
