"""Ray-sharded training over a torch.distributed process group (port of
isopoints_tpu/parallel/sharding.py).

The JAX package shards rays over a 1-D device mesh with `shard_map`. Here
each rank is one process on one device, and the mesh is the process group:
NCCL on the card, gloo on the CPU. `make_train_step` is the only step
implementation: `MVRTrainer` builds it at world size 1 too, where without a
process group it runs no collective. The determinism contract is JAX's:
every random draw is taken full width from the replicated generator chain
and sliced per rank, ray sums divide by the local ray count and sums over
the replicated iso-points by the global one (training/trainer.py
`compute_loss`), and the gradients and metrics are averaged by one
all-reduce. N ranks therefore reproduce one rank up to float reduction
order.

Launch one process per device:

    torchrun --nproc-per-node N -m isopoints_torch.train_mvr CONFIG --n-devices N
"""

import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

LAUNCH = ("launch one process per device with torchrun: torchrun "
          "--nproc-per-node N -m isopoints_torch.train_mvr CONFIG --n-devices N")


@dataclass(frozen=True)
class Mesh:
    """The ranks the rays are sharded over: the process group (None: one
    rank and no collective), its size and this process's rank."""
    group: Optional[object] = None
    size: int = 1
    rank: int = 0


def make_mesh(n_devices: Optional[int] = 1, device="cuda") -> Mesh:
    """The process group as the 1-D mesh of sharding.py:41-50.

    An initialised default group is adopted. Otherwise, under torchrun
    (WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT in the environment) with
    more than one process, the group is initialised here: NCCL for a CUDA
    `device`, on the card of the rank's LOCAL_RANK, and gloo for the CPU.
    `n_devices` None or 0 takes every rank; N must equal the world size.
    N > 1 with neither a group nor a torchrun launch raises ValueError."""
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            if n_devices in (None, 0, 1):
                return Mesh()
            raise ValueError(f"--n-devices {n_devices} needs a process group of "
                             f"{n_devices} ranks: {LAUNCH}")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group("nccl")
        else:
            dist.init_process_group("gloo")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices and n_devices != size:
        raise ValueError(f"--n-devices {n_devices}, but the process group has "
                         f"{size} ranks: {LAUNCH}")
    return Mesh(dist.group.WORLD, size, rank)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every rank takes rank 0's parameters and buffers (sharding.py:141-144:
    the replicated placement); a no-op without a process group."""
    if mesh.group is not None:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)
    return module


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the ranks of each float tensor, by one all-reduce of
    their concatenation (the `pmean` of sharding.py:119-124)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / mesh.size
    return [v.view(t.shape) for v, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank when `flag` is true on any (a collective decision,
    so that no rank leaves a loop the others are still in)."""
    if mesh.group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item() > 0)


def make_train_step(model, mesh: Mesh, project: bool, n_rays: int,
                    n_eikonal_points: int = 1024, views_sharded: bool = False,
                    learning_rate: float = 1e-4, grad_clip: float = 1.0):
    """THE training step over `mesh` (sharding.py:53-140).

    Rays: `step.n_rays` = ceil(n_rays / size)·size pixels are drawn full
    width, and each rank traces its contiguous n_rays / size slice; the
    eikonal set is rounded up the same way (`step.n_eikonal`). Images,
    cameras, iso-points and parameters are replicated; with
    `views_sharded` each rank holds its share of the views and the step
    all-gathers them first (`data.form_global_batch`). The loss's terms are
    normalised per segment (`compute_loss`), the gradients and metrics
    averaged over the ranks, and every rank applies the same clip + Adam
    update to its parameters in place.

    Returns step(opt_state, points, points_mask, spacing, img, mask_img,
    camera, hp, draws) -> (opt_state, new_points, new_mask, metrics,
    saliency): `draws` is the full-width `StepDraws`, `metrics` a dict of
    0-d float32 tensors, `saliency` compute_loss's (iso_points, RGB
    residual, iso_mask), replicated in the projected phase."""
    from isopoints_torch.parallel.data import form_global_batch
    from isopoints_torch.training.trainer import clip_and_adam, compute_loss

    n_local = -(-n_rays // mesh.size)            # ceil: round the rays up
    lo = mesh.rank * n_local

    def step(opt_state, points, points_mask, spacing, img, mask_img, camera,
             hp, draws):
        if views_sharded:
            img, mask_img, camera = form_global_batch((img, mask_img, camera),
                                                      mesh)
        total, metrics, new_pts, new_mask, saliency = compute_loss(
            model, points, points_mask, draws.pixels[:, lo:lo + n_local], img,
            mask_img, camera, draws.eikonal, draws.u_minsdf, hp,
            project=project, proj_draws=draws.projected, spacing=spacing,
            n_dev=mesh.size, shard=mesh.rank)
        params = dict(model.named_parameters())
        grads = list(torch.autograd.grad(total, list(params.values())))
        names = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        if mesh.group is not None:
            *grads, values = all_reduce_mean(grads + [values], mesh)
        opt_state = clip_and_adam(params, dict(zip(params, grads)), opt_state,
                                  learning_rate, grad_clip)
        return (opt_state, new_pts, new_mask, dict(zip(names, values.unbind())),
                saliency)

    step.n_rays = n_local * mesh.size
    step.n_eikonal = -(-n_eikonal_points // mesh.size) * mesh.size
    return step
