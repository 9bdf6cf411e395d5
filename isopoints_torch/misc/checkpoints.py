"""Checkpoints of named training state (port of
isopoints_tpu/misc/checkpoints.py, its npz backend).

`CheckpointIO(dir, **registry)` keeps named templates: a module's
`state_dict`, nested dicts, tuples and NamedTuples (the Adam state) of
tensors, numpy arrays and Python numbers. `save(name, **scalars)` writes
one `.npz`: every leaf under `name:path`, where the path joins dict keys
and NamedTuple fields with '/' (a bare tensor's path is empty, so its
entry is `name:`), and each scalar under `scalar:key`. `load` fills the
templates in place from a file, non-strict: a missing entry or one of
another shape is logged and the template's value kept. Tensors come back
on their template's device and in its dtype. The sharding-aware orbax
backend is out of scope (ROADMAP): `backend="orbax"` raises.
"""

import datetime
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from isopoints_torch.logger import get_logger


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _flatten(tree, path: str = "") -> Dict[str, np.ndarray]:
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, _join(path, k)))
        return out
    if _is_namedtuple(tree):
        out = {}
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), _join(path, k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, _join(path, i)))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().cpu().numpy()}
    return {path: np.asarray(tree)}


def _restore_like(template, saved: Dict[str, np.ndarray], path: str = ""):
    """`template` with each leaf replaced by its saved entry; non-strict."""
    if template is None:
        return None
    if isinstance(template, dict):
        return type(template)((k, _restore_like(v, saved, _join(path, k)))
                              for k, v in template.items())
    if _is_namedtuple(template):
        return type(template)(*(_restore_like(getattr(template, k), saved,
                                              _join(path, k))
                                for k in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_restore_like(v, saved, _join(path, i))
                              for i, v in enumerate(template))
    log = get_logger()
    if path not in saved:
        log.warning("missing key in checkpoint: %s — kept init", path)
        return template
    val = saved[path]
    shape = tuple(np.shape(template))
    if val.shape != shape:
        log.warning("shape mismatch for %s: ckpt %s vs model %s — kept model",
                    path, val.shape, shape)
        return template
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(val)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return val.astype(template.dtype)
    return type(template)(val.item())


class CheckpointIO:
    """Named-state checkpoint registry (checkpoints.py:59-121)."""

    def __init__(self, checkpoint_dir: str = "./chkpts", backend: str = "npz",
                 **registry):
        if backend == "orbax":
            raise NotImplementedError(
                "the orbax checkpoint backend is not ported (ROADMAP: out of "
                "scope on one GPU); use backend 'npz'")
        if backend != "npz":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.checkpoint_dir = checkpoint_dir
        self.backend = backend
        self.registry: Dict[str, Any] = dict(registry)
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **kwargs) -> None:
        self.registry.update(kwargs)

    def _path(self, filename: str) -> str:
        if not os.path.isabs(filename):
            filename = os.path.join(self.checkpoint_dir, filename)
        return filename if filename.endswith(".npz") else filename + ".npz"

    def save(self, filename: str, **scalars) -> str:
        """Write every registered state and the scalars; returns the path."""
        path = self._path(filename)
        payload: Dict[str, np.ndarray] = {}
        for name, tree in self.registry.items():
            for k, v in _flatten(tree).items():
                payload[f"{name}:{k}"] = v
        for k, v in scalars.items():
            payload[f"scalar:{k}"] = np.asarray(v)
        np.savez(path, **payload)
        return path

    def load(self, filename: str) -> Dict[str, Any]:
        """Fill the registered templates from `filename` (in place) and
        return its scalars; FileNotFoundError when it does not exist."""
        path = self._path(filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        get_logger().info("loading checkpoint from %s", path)
        with np.load(path, allow_pickle=False) as data:
            saved = {k: data[k] for k in data.files}
        scalars = {k[len("scalar:"):]: (v.item() if v.ndim == 0 else v)
                   for k, v in saved.items() if k.startswith("scalar:")}
        for name in self.registry:
            sub = {k[len(name) + 1:]: v for k, v in saved.items()
                   if k.startswith(name + ":")}
            self.registry[name] = _restore_like(self.registry[name], sub)
        return scalars

    def backup_model_best(self, filename: str = "model_best.npz") -> Optional[str]:
        """A timestamped copy of the best model (checkpoints.py:184-193)."""
        src = os.path.join(self.checkpoint_dir, filename)
        if not os.path.exists(src):
            return None
        ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M")
        dst = os.path.join(self.checkpoint_dir, f"model_{ts}.npz")
        shutil.copy(src, dst)
        return dst
