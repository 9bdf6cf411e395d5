"""Views sharded over the ranks (port of isopoints_tpu/parallel/data.py).

With `train_mvr --multihost` each rank loads only its share of a step's
views, and the step all-gathers them (`form_global_batch`) before it
shards the rays as the replicated path does, so the two input modes give
the same step. Every rank draws the same global view batch from a shared
seed (`sample_global_view_batch`) and takes its contiguous slice of it
(`local_view_indices`). The JAX package draws the batch from a key; the
port draws it from a numpy `RandomState`.
"""

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from isopoints_torch.parallel.sharding import Mesh


def local_view_indices(global_indices: Sequence[int],
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> np.ndarray:
    """The contiguous slice of a global view-index batch that this rank
    loads (data.py:33-50); the ranks default to the process group's.
    Raises ValueError when the batch does not divide by the rank count."""
    initialised = dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if initialised else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if initialised else 1)
    idx = np.asarray(global_indices)
    if idx.shape[0] % pc != 0:
        raise ValueError(f"global batch {idx.shape[0]} not divisible by {pc} hosts")
    per = idx.shape[0] // pc
    return idx[pi * per:(pi + 1) * per]


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' `x` concatenated along dim 0, in rank order."""
    dtype = x.dtype
    if dtype == torch.bool:      # gloo gathers no bool tensors
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, 0).to(dtype)


_WALKED = (torch.Tensor, np.ndarray, tuple, list, dict)


def form_global_batch(local_tree: Any, mesh: Mesh, device=None) -> Any:
    """The global view batch from every rank's share (data.py:53-71): each
    tensor of `local_tree` (a tensor, numpy array, tuple, list, dict or
    dataclass such as `PerspectiveCamera`) all-gathered along its batch
    axis in rank order. Numpy arrays go to `device` first. A dataclass's
    fields that are neither tensors nor arrays (the camera's `znear` /
    `zfar`, static fields in JAX) stay as they are. Without a process group
    the tree comes back as it is, numpy as tensors."""
    def place(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: place(v) for f in dataclasses.fields(x)
                if isinstance(v := getattr(x, f.name), _WALKED)
                or dataclasses.is_dataclass(v)})
        if isinstance(x, (tuple, list)):
            return type(x)(place(v) for v in x)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        x = torch.as_tensor(x, device=device)
        return x if mesh.group is None else _gather(x, mesh)
    return place(local_tree)


def sample_global_view_batch(rng, n_views: int, global_batch: int) -> np.ndarray:
    """The view indices of one global batch (data.py:74-85), the same on
    every rank that holds the same `rng` (a `np.random.RandomState` or a
    seed): without replacement when the batch fits in the dataset."""
    r = rng if isinstance(rng, np.random.RandomState) else np.random.RandomState(rng)
    if global_batch <= n_views:
        return r.choice(n_views, global_batch, replace=False)
    return r.randint(0, n_views, global_batch)


def _stack(items):
    """Stack per-view items field by field (tuples or lists of arrays)."""
    if isinstance(items[0], (tuple, list)):
        return type(items[0])(np.stack(f) for f in zip(*items))
    return np.stack(items)


class HostShardedViews:
    """Iterator over this rank's view batches of a map-style dataset
    (data.py:88-113): `dataset[i]` gives `(img_hwc, mask_hw1, camera_row)`
    numpy entries; `next_local()` yields (local indices, the stacked local
    entries) for `form_global_batch`. Every rank seeded alike draws the
    same global batches."""

    def __init__(self, dataset, global_batch: int, seed: int = 0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.global_batch = int(global_batch)
        self.rng = np.random.RandomState(seed)
        self.process_index = process_index
        self.process_count = process_count

    def next_local(self):
        gidx = sample_global_view_batch(self.rng, len(self.dataset),
                                        self.global_batch)
        lidx = local_view_indices(gidx, self.process_index, self.process_count)
        return lidx, _stack([self.dataset[int(i)] for i in lidx])
