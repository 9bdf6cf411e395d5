"""Carry JAX parameters into the port.

`params_from_jax` maps the JAX parameter pytree, given as numpy arrays
(`{"decoder": {"layers": [{"w", "b"} | {"v", "g", "b"}, ...]}, ...}`),
to a torch `state_dict` for the port's modules. Plain layers become
`<module>.layers.i.weight` / `.bias` (`nn.Linear`). Weight-normalised
layers fold to one `weight` = g·v / max(‖v‖_row, 1e-12), as
isopoints_tpu/models/fields.py:95-100 computes it, unless
`keep_weight_norm`: then they stay `<module>.layers.i.v` / `.g` / `.b`,
the parameters of the port's `SDFField` (`WeightNormLinear`), so that an
optimiser sees the same parametrisation as the JAX one. Extra heads
(`out_dims`) and latent-code columns (`c_dim`) come across with their
layers: the head's rows and the first layer's columns in the JAX order,
which the port's `_split_output` and code concatenation read. An occupancy
decoder's tree (`{"fc_in", "blocks": [{"fc0", "fc1"}], "fc_out"}` and,
with a code, `"fc_c": [...]`; isopoints_tpu/models/fields.py:346-365) maps
to the same names in the port's `OccupancyField`. `load_jax_npz`
reads the same tree from a JAX `model.npz` checkpoint
(isopoints_tpu/misc/checkpoints.py: keys `model:['decoder']['layers'][0]['w']`).
`point_params_from_jax` maps the point model's pytree
(isopoints_tpu/models/point.py:68-74) to the `PointModel` state_dict.
"""

import re
from typing import Dict

import numpy as np
import torch


def _linear(prefix: str, lp: Dict[str, np.ndarray], keep_weight_norm: bool
            ) -> Dict[str, torch.Tensor]:
    f32 = lambda k: torch.tensor(np.asarray(lp[k], np.float32))
    if "v" not in lp:
        return {f"{prefix}.weight": f32("w"), f"{prefix}.bias": f32("b")}
    if keep_weight_norm:
        return {f"{prefix}.{k}": f32(k) for k in ("v", "g", "b")}
    v = np.asarray(lp["v"], np.float32)
    g = np.asarray(lp["g"], np.float32)
    norm = np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return {f"{prefix}.weight": torch.tensor((v * (g / norm)).astype(np.float32)),
            f"{prefix}.bias": f32("b")}


def params_from_jax(tree: Dict, keep_weight_norm: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> state_dict of the port's model."""
    out = {}
    for module, sub in tree.items():
        if "fc_in" in sub:
            out.update(_occupancy(module, sub))
            continue
        keep = keep_weight_norm or module == "texture"
        for i, lp in enumerate(sub["layers"]):
            out.update(_linear(f"{module}.layers.{i}", lp, keep))
    return out


def _occupancy(module: str, sub: Dict) -> Dict[str, torch.Tensor]:
    out = {}
    for name in ("fc_in", "fc_out"):
        out.update(_linear(f"{module}.{name}", sub[name], False))
    for i, blk in enumerate(sub["blocks"]):
        for name in ("fc0", "fc1"):
            out.update(_linear(f"{module}.blocks.{i}.{name}", blk[name], False))
    for i, lp in enumerate(sub.get("fc_c", [])):
        out.update(_linear(f"{module}.fc_c.{i}", lp, False))
    return out


POINT_PARAMS = ("points", "normals_azim", "normals_elev", "colors", "log_size")


def point_params_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX `PointModel` params (numpy leaves) -> state_dict of the
    port's `PointModel`: the same five names and shapes, as float32."""
    return {k: torch.tensor(np.asarray(params[k], np.float32)) for k in POINT_PARAMS}


_KEY = re.compile(r"^model:\['(\w+)'\]\['layers'\]\[(\d+)\]\['(\w+)'\]$")


def load_jax_npz(path: str, keep_weight_norm: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """state_dict from the `model:` entries of a JAX model.npz (the same
    leaves and the same `keep_weight_norm` rule as `params_from_jax`)."""
    tree: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            m = _KEY.match(k)
            if m:
                module, i, leaf = m.group(1), int(m.group(2)), m.group(3)
                tree.setdefault(module, {}).setdefault(i, {})[leaf] = data[k]
    return params_from_jax({mod: {"layers": [layers[i] for i in sorted(layers)]}
                            for mod, layers in tree.items()}, keep_weight_norm)
