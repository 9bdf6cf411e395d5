"""Checkpoints of named training state (port of
isopoints_tpu/misc/checkpoints.py).

`CheckpointIO(dir, backend, **registry)` keeps named templates: a module's
`state_dict`, nested dicts, tuples and NamedTuples (the Adam state) of
tensors, numpy arrays and Python numbers. Every leaf is saved under
`name:path`, where the path joins dict keys and NamedTuple fields with
'/' (a bare tensor's path is empty, so its entry is `name:`), and each
scalar of `save(name, **scalars)` under `scalar:key`. `load` fills the
templates from a file, non-strict: a missing entry or one of another shape
is logged and the template's value kept. Tensors come back on their
template's device and in its dtype. Two backends:

  * 'npz' (default): one `.npz` a checkpoint, written by one process.
  * 'orbax': a sharding-aware directory checkpoint, `<stem>.orbax`, the
    JAX package's name and path rule (configs say
    `training.checkpoint_backend: orbax`), written through
    `torch.distributed.checkpoint`. Under a process group `save` and
    `load` are collective: each rank writes its own shards of a
    distributed tensor (a DTensor leaf), and a replicated tensor is written
    once. The flat keys above are the checkpoint's keys, so tuples and
    integer keys (the Adam state) restore through the same non-strict
    template fill as the npz backend; a DTensor template gets its restored
    value distributed as the template is. The directory holds PyTorch's
    format, not orbax's: neither package reads the other's checkpoints.
"""

import datetime
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from isopoints_torch.logger import get_logger


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor for torch.distributed.checkpoint: tensors (and
    DTensors) as they are, the rest through numpy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf))    # a copy, 0-d kept 0-d


def _flatten(tree, path: str = "", leaf=_to_numpy) -> Dict[str, Any]:
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {path: leaf(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, _join(path, k), leaf))
    return out


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
        return DTensor
    except ImportError:
        return ()


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
    if isinstance(template, _dtensor_type()):
        from torch.distributed.tensor import distribute_tensor
        full = torch.from_numpy(np.array(val)).to(device=template.device,
                                                  dtype=template.dtype)
        return distribute_tensor(full, template.device_mesh, template.placements)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(val)).to(device=template.device,
                                                  dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return val.astype(template.dtype)
    return type(template)(val.item())


class CheckpointIO:
    """Named-state checkpoint registry (checkpoints.py:59-182)."""

    def __init__(self, checkpoint_dir: str = "./chkpts", backend: str = "npz",
                 **registry):
        if backend not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.checkpoint_dir = checkpoint_dir
        self.backend = backend
        self.registry: Dict[str, Any] = dict(registry)
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **kwargs) -> None:
        self.registry.update(kwargs)

    def path(self, filename: str) -> str:
        """The file (npz) or directory (orbax: `<stem>.orbax`, the JAX
        rule of checkpoints.py:113-118) that `filename` names."""
        stem = filename[:-len(".npz")] if filename.endswith(".npz") else filename
        if not os.path.isabs(stem):
            stem = os.path.join(self.checkpoint_dir, stem)
        if self.backend == "orbax":
            return os.path.abspath(stem + ".orbax")
        return stem + ".npz"

    def exists(self, filename: str) -> bool:
        return os.path.exists(self.path(filename))

    def _payload(self, scalars, leaf) -> Dict[str, Any]:
        payload = {}
        for name, tree in self.registry.items():
            for k, v in _flatten(tree, leaf=leaf).items():
                payload[f"{name}:{k}"] = v
        for k, v in scalars.items():
            payload[f"scalar:{k}"] = leaf(np.asarray(v))
        return payload

    def save(self, filename: str, **scalars) -> str:
        """Write every registered state and the scalars; returns the path.
        Collective under a process group with the orbax backend."""
        path = self.path(filename)
        if self.backend == "npz":
            np.savez(path, **self._payload(scalars, _to_numpy))
            return path
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        group = _in_group()
        # overwrite, as orbax's force=True: rank 0 clears the directory first
        if (not group or dist.get_rank() == 0) and os.path.exists(path):
            shutil.rmtree(path)
        if group:
            dist.barrier()
        dcp.save(self._payload(scalars, _to_tensor), checkpoint_id=path,
                 no_dist=not group)
        return path

    def saved_arrays(self, filename: str) -> Dict[str, Tuple[tuple, np.dtype]]:
        """(shape, dtype) of every entry of a checkpoint, without reading
        its data; FileNotFoundError when it does not exist."""
        path = self.path(filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if self.backend == "npz":
            with np.load(path, allow_pickle=False) as data:
                return {k: (data[k].shape, data[k].dtype) for k in data.files}
        return {k: (tuple(m.size), _numpy_dtype(m.properties.dtype))
                for k, m in _dcp_tensors(path).items()}

    def read(self, filename: str) -> Dict[str, np.ndarray]:
        """Every entry of a checkpoint by its flat key, as numpy arrays
        (collective under a process group with the orbax backend)."""
        path = self.path(filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if self.backend == "npz":
            with np.load(path, allow_pickle=False) as data:
                return {k: data[k] for k in data.files}
        import torch.distributed.checkpoint as dcp

        # every entry into a host tensor of its saved global shape: a
        # sharded entry is read whole, then the template fill distributes it
        full = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in _dcp_tensors(path).items()}
        dcp.load(full, checkpoint_id=path, no_dist=not _in_group())
        return {k: v.numpy() for k, v in full.items()}

    def load(self, filename: str) -> Dict[str, Any]:
        """Fill the registered templates from `filename` and return its
        scalars; FileNotFoundError when it does not exist. Collective under
        a process group with the orbax backend."""
        if not self.exists(filename):
            raise FileNotFoundError(self.path(filename))
        get_logger().info("loading checkpoint from %s", self.path(filename))
        saved = self.read(filename)
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


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _dcp_tensors(path: str) -> Dict[str, Any]:
    """The tensor entries of a torch.distributed.checkpoint directory's
    metadata (key -> TensorStorageMetadata: global size, dtype)."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    md = FileSystemReader(path).read_metadata().state_dict_metadata
    return {k: m for k, m in md.items() if isinstance(m, TensorStorageMetadata)}


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype
