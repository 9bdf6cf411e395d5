"""Implicit field networks (port of isopoints_tpu/models/fields.py).

`SirenField` is an `nn.Module` whose layers are `nn.Linear`s, so weights
sit in the same (out, in) layout as the JAX pytree's `w` (fields.py:95-116)
and convert one to one (`isopoints_torch.convert`). `SDFField` is the IGR
softplus field (fields.py:190-262) with weight-normalised layers that keep
the JAX parametrisation `{v, g, b}`, and `positional_embedder` its NeRF
input encoding (fields.py:64-88). `sdf_and_grad` returns the SDF and its
input gradient, dispatching to a fused `.sdf_and_grad` when the callable
carries one (ops/fused_mlp.py), like the reference. `RenderingNetwork` is
the IDR colour net of the neural texture (fields.py:269-323). The SIREN,
IGR and colour nets carry the JAX fields' `out_dims` heads ("sdf",
"latent", "rgb", "occupancy"; `heads`, JAX's `apply`, returns a
`FieldOutput`, split as
`_split_output` splits it) and latent codes (`c_dim`); `forward` returns
the SDF (the colour net: the rgb).
`OccupancyField` is ONet's ResNet-FC occupancy decoder (fields.py:330-385)
for the DVR occupancy model (models/occupancy.py), and
`approximate_gradient` the central-difference gradient (fields.py:408).
"""

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class FieldOutput(NamedTuple):
    """The heads of a field's output (fields.py:24-29)."""
    sdf: Optional[torch.Tensor] = None
    latent: Optional[torch.Tensor] = None
    rgb: Optional[torch.Tensor] = None
    occupancy: Optional[torch.Tensor] = None


_FIELDS = ("sdf", "latent", "rgb", "occupancy")


def _validate_out_dims(out_dims: Dict[str, int]) -> None:
    for k, v in out_dims.items():
        if k not in _FIELDS:
            raise ValueError(f"invalid out_dims key {k}")
        if k in ("sdf", "occupancy") and v != 1:
            raise ValueError(f"{k} must have dim 1")
        if k == "rgb" and v != 3:
            raise ValueError("rgb must have dim 3")


def _split_output(x: torch.Tensor, out_dims: Dict[str, int],
                  scale_rgb: bool = False, sigmoid_rgb: bool = False
                  ) -> FieldOutput:
    """The output's channels cut into the heads in `out_dims` order; rgb
    mapped by (x + 1)/2 (`scale_rgb`) or a sigmoid (fields.py:45-57)."""
    parts = {}
    ofs = 0
    for k, d in out_dims.items():
        parts[k] = x[..., ofs:ofs + d]
        ofs += d
    if "rgb" in parts:
        if scale_rgb:
            parts["rgb"] = (parts["rgb"] + 1.0) / 2.0
        elif sigmoid_rgb:
            parts["rgb"] = torch.sigmoid(parts["rgb"])
    return FieldOutput(**parts)


def _uniform_linear(in_d: int, out_d: int, bound: float,
                    generator: Optional[torch.Generator],
                    device) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, in_d, out_d, device=device or "cpu")
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.zero_()
    return lin


class SirenField(nn.Module):
    """SIREN MLP (reference common.py:56-167; fields.py:129-180): first
    SineLayer(dim + c_dim -> h), `n_layers` hidden SineLayers, a linear head
    to the `out_dims` channels (default the SDF alone), optionally a sine
    head (`outermost_linear=False`) and a final tanh (rgb (x + 1)/2) or
    sigmoid; without one, rgb takes a sigmoid. A latent code `c` is
    concatenated before the points. Init as the JAX field: first layer
    U(±1/(dim + c_dim)), the rest U(±√(6/h)/ω), zero biases. `dim` is the
    points' dimension (3)."""

    def __init__(self, hidden_size: int = 256, n_layers: int = 3,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 out_dims: Optional[Dict[str, int]] = None, c_dim: int = 0,
                 outermost_linear: bool = True,
                 activation: Optional[str] = None, dim: int = 3,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.out_dims = dict(out_dims or {"sdf": 1})
        _validate_out_dims(self.out_dims)
        self.out_dim = sum(self.out_dims.values())
        self.dim = dim
        self.c_dim = c_dim
        self.in_dim = dim + c_dim
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.first_omega_0 = first_omega_0
        self.hidden_omega_0 = hidden_omega_0
        self.outermost_linear = outermost_linear
        self.activation = activation   # None | 'tanh' | 'sigmoid'
        bound = math.sqrt(6.0 / hidden_size) / hidden_omega_0
        layers = [_uniform_linear(self.in_dim, hidden_size, 1.0 / self.in_dim,
                                  generator, device)]
        layers += [_uniform_linear(hidden_size, hidden_size, bound, generator,
                                   device) for _ in range(n_layers)]
        layers.append(_uniform_linear(hidden_size, self.out_dim, bound,
                                      generator, device))
        self.layers = nn.ModuleList(layers)

    @property
    def sdf_only(self) -> bool:
        """A linear SDF head alone on 3-d points, no code: what the fused
        kernels take."""
        return (self.out_dim == 1 and self.activation is None
                and self.outermost_linear and self.c_dim == 0 and self.dim == 3)

    def heads(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
              ) -> FieldOutput:
        """x (..., 3), c (..., c_dim) -> the heads (JAX `apply`,
        fields.py:160-176)."""
        if self.c_dim > 0 and c is not None:
            x = torch.cat([c, x], dim=-1)
        h = torch.sin(self.first_omega_0 * self.layers[0](x))
        for lin in self.layers[1:-1]:
            h = torch.sin(self.hidden_omega_0 * lin(h))
        out = self.layers[-1](h)
        if not self.outermost_linear:
            out = torch.sin(self.hidden_omega_0 * out)
        if self.activation == "tanh":
            return _split_output(torch.tanh(out), self.out_dims, scale_rgb=True)
        if self.activation == "sigmoid":
            return _split_output(torch.sigmoid(out), self.out_dims)
        return _split_output(out, self.out_dims, sigmoid_rgb=True)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (..., 3) -> sdf (...)."""
        return self.heads(x, c).sdf[..., 0]

    def sdf(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
        return self(x, c)


def positional_embedder(multires: int, input_dims: int = 3,
                        include_input: bool = True, log_sampling: bool = True
                        ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """(embed_fn, out_dim): [x, sin(f₀x), cos(f₀x), sin(f₁x), ...] at
    `multires` octaves (fields.py:64-88); the identity for multires <= 0."""
    if multires <= 0:
        return (lambda x: x), input_dims
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, multires - 1, multires)
    else:
        freqs = np.linspace(1.0, 2.0 ** (multires - 1), multires)
    freqs = torch.tensor(freqs, dtype=torch.float32)
    out_dim = (input_dims if include_input else 0) + input_dims * 2 * multires

    def embed(x: torch.Tensor) -> torch.Tensor:
        xf = x[..., None, :] * freqs.to(x.device)[:, None]          # (..., F, D)
        enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)   # (..., F, 2, D)
        enc = enc.reshape(*x.shape[:-1], -1)
        return torch.cat([x, enc], dim=-1) if include_input else enc

    return embed, out_dim


def softplus_beta(z: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """softplus(β·z)/β as JAX writes it: logaddexp(βz, 0) = max(βz, 0) +
    log1p(exp(−|βz|)). `F.softplus` turns linear above its threshold of
    20 and so computes another function."""
    bz = beta * z
    return (torch.clamp(bz, min=0.0) + torch.log1p(torch.exp(-bz.abs()))) / beta


class WeightNormLinear(nn.Module):
    """y = x·wᵀ + b with w = v·(g / max(‖v‖_row, 1e-12)) formed on every
    call (fields.py:97-99); `v` (out, in), `g` (out, 1), `b` (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(w)
        self.g = nn.Parameter(torch.linalg.norm(w, dim=1, keepdim=True))
        self.b = nn.Parameter(b)

    @property
    def weight(self) -> torch.Tensor:
        norm = torch.clamp(torch.linalg.norm(self.v, dim=1, keepdim=True),
                           min=1e-12)
        return self.v * (self.g / norm)

    @property
    def bias(self) -> torch.Tensor:
        return self.b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.b)


def _plain_linear(w: torch.Tensor, b: torch.Tensor) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, w.shape[1], w.shape[0],
                             device=w.device)
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.copy_(b)
    return lin


class SDFField(nn.Module):
    """IGR / DeepSDF SDF MLP (reference common.py:220-311): `n_layers`
    softplus(β=100) layers of `hidden_size`, the input concatenated back at
    the layers of `skip_in` and scaled by 1/√2, a linear head and an
    optional final tanh. Geometric init (fields.py:215-239): head
    N(√π/√fan_in, 1e-4) with bias −`bias`, hidden N(0, 2/out), the
    positional-encoding columns zeroed at the input and skip layers.
    Weight-normalised layers (`weight_norm`) are `WeightNormLinear`s with
    the JAX leaves `v, g, b`; otherwise `nn.Linear`s. The head gives the
    `out_dims` channels (default the SDF alone; rgb through a sigmoid), and
    a code `c` is concatenated before the embedded points (fields.py:
    241-262; the first layer's width does not count it, as in JAX)."""

    def __init__(self, dim: int = 3, hidden_size: int = 512,
                 n_layers: int = 8, bias: float = 0.6,
                 weight_norm: bool = True, skip_in: Sequence[int] = (4,),
                 num_frequencies: int = 6, final_tanh: bool = True,
                 out_dims: Optional[Dict[str, int]] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.out_dims = dict(out_dims or {"sdf": 1})
        _validate_out_dims(self.out_dims)
        self.out_dim = sum(self.out_dims.values())
        self.raw_dim = dim
        self.embed, in_dim = positional_embedder(num_frequencies, dim)
        self.num_frequencies = num_frequencies
        self.hidden_size = hidden_size
        self.dims = [in_dim] + [hidden_size] * n_layers + [self.out_dim]
        self.skip_in = tuple(skip_in)
        self.final_tanh = final_tanh
        self.weight_norm = weight_norm
        nl = len(self.dims) - 1
        d0 = self.dims[0]
        f32 = dict(dtype=torch.float32, device=device or "cpu")
        layers = []
        for l in range(nl):
            in_d, out_d = self.dims[l], self.dims[l + 1]
            if l + 1 in self.skip_in:
                out_d -= d0
            if l == nl - 1:
                w = (math.sqrt(math.pi) / math.sqrt(in_d) + 1e-4 * torch.randn(
                    (out_d, in_d), generator=generator, **f32))
                b = torch.full((out_d,), -bias, **f32)
            else:
                w = torch.randn((out_d, in_d), generator=generator, **f32) * (
                    math.sqrt(2.0) / math.sqrt(out_d))
                b = torch.zeros(out_d, **f32)
                if num_frequencies > 0 and l == 0:
                    w[:, dim:] = 0.0
                elif num_frequencies > 0 and l in self.skip_in:
                    w[:, -(d0 - dim):] = 0.0
            layers.append(WeightNormLinear(w, b) if weight_norm
                          else _plain_linear(w, b))
        self.layers = nn.ModuleList(layers)

    def heads(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
              ) -> FieldOutput:
        """x (..., 3), c (..., C) -> the heads (JAX `apply`,
        fields.py:241-262)."""
        inp = self.embed(x)
        h = inp if c is None else torch.cat([c, inp], dim=-1)
        nl = len(self.layers)
        for l, lin in enumerate(self.layers):
            if l in self.skip_in:
                h = torch.cat([h, inp], dim=-1) * (1.0 / math.sqrt(2.0))
            h = lin(h)
            if l < nl - 1:
                h = softplus_beta(h)
        if self.final_tanh:
            h = torch.tanh(h)
        return _split_output(h, self.out_dims, sigmoid_rgb=True)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (..., 3) -> sdf (...)."""
        return self.heads(x, c).sdf[..., 0]

    def sdf(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
        return self(x, c)


class RenderingNetwork(nn.Module):
    """IDR colour net (reference common.py:313-366; fields.py:269-323):
    `n_layers` ReLU layers of `hidden_size` and a linear head to the
    `out_dims` channels (default rgb), then tanh, rgb = (tanh + 1) / 2
    (`_split_output` with `scale_rgb`). The caller embeds the view
    direction, so `dim` counts raw dims (9 = normal, point, view) and the
    input is c_dim + dim + (embed_dim − 3) wide (c_dim 256 by default, as in
    JAX; the neural texture passes 0), a latent code `c` first;
    `apply_with_view` forms the [normals, points, embed(view)] layout of the
    neural texture. Init as the JAX net: w and b U(±1/√fan_in);
    weight-normalised layers are `WeightNormLinear`s with the JAX leaves
    `v, g, b` (g = ‖w‖_row), else `nn.Linear`s."""

    def __init__(self, dim: int = 9, c_dim: int = 256, hidden_size: int = 512,
                 n_layers: int = 4, weight_norm: bool = True,
                 num_frequencies: int = 4,
                 out_dims: Optional[Dict[str, int]] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.out_dims = dict(out_dims or {"rgb": 3})
        _validate_out_dims(self.out_dims)
        self.out_dim = sum(self.out_dims.values())
        self.c_dim = c_dim
        self.embed_view, view_dim = positional_embedder(num_frequencies, 3)
        in_dim = dim + c_dim + (view_dim - 3 if num_frequencies > 0 else 0)
        self.dims = [in_dim] + [hidden_size] * n_layers + [self.out_dim]
        f32 = dict(dtype=torch.float32, device=device or "cpu")
        layers = []
        for in_d, out_d in zip(self.dims[:-1], self.dims[1:]):
            bound = 1.0 / math.sqrt(in_d)
            w = torch.empty((out_d, in_d), **f32).uniform_(-bound, bound,
                                                           generator=generator)
            b = torch.empty((out_d,), **f32).uniform_(-bound, bound,
                                                      generator=generator)
            layers.append(WeightNormLinear(w, b) if weight_norm
                          else _plain_linear(w, b))
        self.layers = nn.ModuleList(layers)

    def heads(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
              ) -> FieldOutput:
        """x (..., dim + embed), c (..., c_dim) -> the heads (JAX
        `apply`)."""
        h = x if c is None else torch.cat([c, x], dim=-1)
        for l, lin in enumerate(self.layers):
            h = lin(h)
            if l < len(self.layers) - 1:
                h = torch.relu(h)
        return _split_output(torch.tanh(h), self.out_dims, scale_rgb=True)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (..., in_dim) -> rgb (..., 3)."""
        return self.heads(x, c).rgb

    def apply_with_view(self, normals: torch.Tensor, points: torch.Tensor,
                        view_dirs: torch.Tensor,
                        c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rgb of the [normals, points, embed(view)] layout
        (fields.py:316-323)."""
        return self(torch.cat([normals, points, self.embed_view(view_dirs)],
                              dim=-1), c)


class OccupancyField(nn.Module):
    """ONet-style occupancy decoder (fields.py:330-385): fc_in (dim -> h),
    `n_blocks` ResNet blocks h + fc1(relu(fc0(relu(h)))), each first adding
    fc_c[i](c) of a conditional code when `c_dim` > 0 and a code is given,
    and fc_out on relu(h) to the `out_dims` channels (default one raw
    occupancy logit; rgb takes a sigmoid). Init as the JAX field:
    U(±1/√fan_in) weights, zero biases, and every block's fc1 zero (ONet's
    zero-initialised second layer)."""

    def __init__(self, dim: int = 3, hidden_size: int = 512, n_blocks: int = 5,
                 c_dim: int = 0, out_dims: Optional[Dict[str, int]] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.out_dims = dict(out_dims or {"occupancy": 1})
        _validate_out_dims(self.out_dims)
        self.out_dim = sum(self.out_dims.values())
        self.c_dim = c_dim
        h = hidden_size

        def lin(i, o, zero=False):
            return _uniform_linear(i, o, 0.0 if zero else 1.0 / math.sqrt(i),
                                   generator, device)

        self.fc_in = lin(dim, h)
        self.fc_out = lin(h, self.out_dim)
        self.blocks = nn.ModuleList(
            [nn.ModuleDict({"fc0": lin(h, h), "fc1": lin(h, h, zero=True)})
             for _ in range(n_blocks)])
        if c_dim > 0:
            self.fc_c = nn.ModuleList([lin(c_dim, h) for _ in range(n_blocks)])

    def heads(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
              ) -> FieldOutput:
        """x (..., dim), c (..., c_dim) -> the heads (JAX `apply`,
        fields.py:367-376); occupancy stays a raw logit."""
        h = self.fc_in(x)
        for i, blk in enumerate(self.blocks):
            if self.c_dim > 0 and c is not None:
                h = h + self.fc_c[i](c)
            h = h + blk["fc1"](torch.relu(blk["fc0"](torch.relu(h))))
        return _split_output(self.fc_out(torch.relu(h)), self.out_dims,
                             sigmoid_rgb=True)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (..., dim) -> raw occupancy logits (..., 1)."""
        return self.heads(x, c).occupancy


def field_grad(apply_sdf: Callable[[torch.Tensor], torch.Tensor]
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> ∇ₓsdf (fields.py:383-389): the gradient of the sum, one
    backward pass for the batch, as every point's value depends on that
    point alone; differentiable in the parameters as `sdf_and_grad`'s."""
    return lambda x: sdf_and_grad(apply_sdf, x)[1]


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


def approximate_gradient(apply_sdf: Callable[[torch.Tensor], torch.Tensor],
                         x: torch.Tensor, h: float = 1e-3) -> torch.Tensor:
    """Central differences over the six axis offsets of ±h (fields.py:
    408-416), for testing."""
    offsets = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], dtype=x.dtype,
                           device=x.device) * h
    vals = [apply_sdf(x + o) for o in offsets]
    return torch.stack([(vals[2 * i] - vals[2 * i + 1]) / (2 * h)
                        for i in range(3)], dim=-1)
