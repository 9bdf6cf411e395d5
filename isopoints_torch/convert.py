"""Carry JAX parameters into the port.

`params_from_jax` maps the JAX parameter pytree, given as numpy arrays
(`{"decoder": {"layers": [{"w", "b"} | {"v", "g", "b"}, ...]}, ...}`),
to a torch `state_dict` for the port's modules (`decoder.layers.i.weight`
/ `.bias`). Weight-normalised layers fold to w = g·v / max(‖v‖_row, 1e-12)
as isopoints_tpu/models/fields.py:95-100 computes them. `load_jax_npz`
reads the same tree from a JAX `model.npz` checkpoint
(isopoints_tpu/misc/checkpoints.py: keys `model:['decoder']['layers'][0]['w']`).
"""

import re
from typing import Dict

import numpy as np
import torch


def _linear(lp: Dict[str, np.ndarray]):
    b = np.asarray(lp["b"], np.float32)
    if "v" in lp:
        v = np.asarray(lp["v"], np.float32)
        g = np.asarray(lp["g"], np.float32)
        norm = np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        return (v * (g / norm)).astype(np.float32), b
    return np.asarray(lp["w"], np.float32), b


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> state_dict of the port's model."""
    out = {}
    for module, sub in tree.items():
        for i, lp in enumerate(sub["layers"]):
            w, b = _linear(lp)
            out[f"{module}.layers.{i}.weight"] = torch.tensor(w)
            out[f"{module}.layers.{i}.bias"] = torch.tensor(b)
    return out


_KEY = re.compile(r"^model:\['(\w+)'\]\['layers'\]\[(\d+)\]\['(\w+)'\]$")


def load_jax_npz(path: str) -> Dict[str, torch.Tensor]:
    """state_dict from the `model:` entries of a JAX model.npz."""
    tree: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            m = _KEY.match(k)
            if m:
                module, i, leaf = m.group(1), int(m.group(2)), m.group(3)
                tree.setdefault(module, {}).setdefault(i, {})[leaf] = data[k]
    return params_from_jax({mod: {"layers": [layers[i] for i in sorted(layers)]}
                            for mod, layers in tree.items()})
