"""The fields of the render in plain PyTorch: the SIREN and IGR SDF networks
and the IDR neural texture, as their papers define them.

Weights come as lists of layers in (out, in) layout: SIREN `(w, b)`, the
weight-normalised IGR and texture layers `(v, g, b)` with w = v·g/‖v‖_row.
`dtype` is the precision every product and activation runs in: float32
(with TF32 off, `render.strict_f32`) for the reference, bfloat16 for its
control. Nothing here is the program's.
"""

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def _wn(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return v * (g / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                                min=1e-12))


def encode(x: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    """NeRF's encoding: [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]."""
    parts = [x]
    for k in range(num_frequencies):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def siren_sdf(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              x: torch.Tensor, first_omega_0: float = 30.0,
              hidden_omega_0: float = 30.0,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SIREN (Sitzmann et al. 2020): sin(ω0·(W x + b)) layers, a linear
    SDF head. x (N, 3) -> (N,) float32."""
    h = x.to(dtype)
    for i, (w, b) in enumerate(layers):
        h = F.linear(h, w.to(dtype), b.to(dtype))
        if i < len(layers) - 1:
            h = torch.sin((first_omega_0 if i == 0 else hidden_omega_0) * h)
    return h[:, 0].float()


def softplus(z: torch.Tensor, beta: float) -> torch.Tensor:
    """log(1 + exp(βz))/β, in its overflow-free form."""
    bz = beta * z
    return (torch.clamp(bz, min=0.0) + torch.log1p(torch.exp(-bz.abs()))) / beta


def igr_sdf(layers: Sequence[Tuple[torch.Tensor, ...]], x: torch.Tensor,
            skip_in: Sequence[int] = (4,), beta: float = 100.0,
            num_frequencies: int = 0, final_tanh: bool = True,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """IGR's network (Gropp et al. 2020): weight-normalised softplus_β
    layers, the (encoded) input concatenated back at `skip_in` and scaled
    by 1/√2, a linear head, an optional final tanh. x (N, 3) -> (N,)."""
    inp = encode(x, num_frequencies).to(dtype)
    h = inp
    for l, (v, g, b) in enumerate(layers):
        if l in skip_in:
            h = torch.cat([h, inp], dim=-1) * (1.0 / math.sqrt(2.0))
        h = F.linear(h, _wn(v, g).to(dtype), b.to(dtype))
        if l < len(layers) - 1:
            h = softplus(h, beta)
    if final_tanh:
        h = torch.tanh(h)
    return h[:, 0].float()


def texture_rgb(layers: Sequence[Tuple[torch.Tensor, ...]],
                normals: torch.Tensor, points: torch.Tensor,
                view: torch.Tensor, num_frequencies: int = 4,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """IDR's colour network on [normal, point, encoded view direction]:
    weight-normalised ReLU layers, rgb = (tanh + 1)/2. (N, 3) each ->
    (N, 3) float32."""
    h = torch.cat([normals, points, encode(view, num_frequencies)],
                  dim=-1).to(dtype)
    for l, (v, g, b) in enumerate(layers):
        h = F.linear(h, _wn(v, g).to(dtype), b.to(dtype))
        if l < len(layers) - 1:
            h = torch.relu(h)
    return ((torch.tanh(h) + 1.0) / 2.0).float()


def sdf_fn(model: dict, decoder: List, dtype: torch.dtype = torch.float32
           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The SDF of a configuration's `model` block on the `decoder` weights."""
    kw = model.get("decoder_kwargs", {})
    kind = model.get("decoder_type", "siren")
    if kind == "siren":
        return lambda x: siren_sdf(decoder, x, kw.get("first_omega_0", 30.0),
                                   kw.get("hidden_omega_0", 30.0), dtype)
    if kind == "sdf":
        return lambda x: igr_sdf(decoder, x, tuple(kw.get("skip_in", (4,))),
                                 100.0, kw.get("num_frequencies", 6),
                                 kw.get("final_tanh", True), dtype)
    raise ValueError(f"no reference for decoder_type {kind!r}")


def texture_fn(model: dict, texture: List, dtype: torch.dtype = torch.float32):
    """(normals, points, view) -> rgb of the configuration's texture."""
    nf = model.get("texture_kwargs", {}).get("num_frequencies", 4)
    return lambda n, p, v: texture_rgb(texture, n, p, v, nf, dtype)
