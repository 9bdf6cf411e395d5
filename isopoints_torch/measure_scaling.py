"""Weak scaling of the sharded train step (port of scripts/measure_scaling.py).

    python -m isopoints_torch.measure_scaling [--world-sizes 1 2 ...] \
        [--rays-per-device 2048] [--total-rays 0] [--iters 5] \
        [--image-size 64] [--device cuda|cpu]

Times the projected step of `parallel.sharding.make_train_step` over a
process group of each world size, with the rays a rank held fixed (weak
scaling), and prints one JSON line a world size:

    efficiency(N) = total_rays_per_s(N) / (N · total_rays_per_s(1))

With `--total-rays T` the total is held fixed instead and the line reports
`partition_overhead_efficiency` = rays/s(N) / rays/s(1). The model is the
JAX script's (SIREN 3×256, 5 projection iterations, 512 iso-points a batch
of a 1024-point cloud, visibility at `--image-size`), from a seed. A world
size of N is N processes, each joining a process group (NCCL on the card,
one card a rank, gloo on the CPU) through a file store; world size 1 too,
so that its step runs the same collectives; on the CPU the ranks share
the caller's torch threads. Each line names its backend
and device, so that ranks sharing one host's cores (gloo on the CPU) are
never read as the card's numbers. `main(argv)` returns the lines as dicts.
"""

import argparse
import datetime
import json
import os
import tempfile
import time
from typing import Dict, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HP = {"lambda_rgb": 1.0, "lambda_freespace": 1.0, "lambda_occupied": 1.0,
      "lambda_eikonal": 0.01, "sdf_alpha": 10.0}


def build(image_size: int, device, seed: int = 0):
    """scripts/measure_scaling.py's model, camera and views."""
    from isopoints_torch.core.camera import (PerspectiveCamera,
                                             look_at_view_transform)
    from isopoints_torch.models.combined import CombinedConfig, CombinedModel
    from isopoints_torch.models.fields import SirenField
    from isopoints_torch.models.implicit import ImplicitConfig
    from isopoints_torch.rendering.rasterizer import RasterizationSettings

    g = torch.Generator(device=device).manual_seed(seed)
    model = CombinedModel(
        SirenField(hidden_size=256, n_layers=3, generator=g, device=device),
        ImplicitConfig(proj_max_iters=5),
        CombinedConfig(max_iso_per_batch=512, n_points_per_cloud=1024,
                       visibility_image_size=image_size),
        raster_settings=RasterizationSettings(image_size=image_size, tile_size=16,
                                              max_points_per_tile=128))
    R, T = look_at_view_transform([2.0], [10.0], [0.0], device=device)
    camera = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=device)
    img = torch.full((1, image_size, image_size, 3), 0.5, device=device)
    mask = torch.ones((1, image_size, image_size, 1), device=device)
    return model, camera, img, mask


def measure(mesh, rays_per_device: int, n_iters: int, image_size: int,
            device) -> float:
    """The fastest of `n_iters` projected steps over `mesh` after one
    warm-up step, in seconds (every rank takes part; the clock is rank 0's,
    around a synchronised step)."""
    from isopoints_torch.parallel.sharding import make_train_step
    from isopoints_torch.training.trainer import MVRTrainer

    model, camera, img, mask = build(image_size, device)
    trainer = MVRTrainer(model, device=device, mesh=mesh)   # replicates rank 0's
    state = trainer.init_state()
    step = make_train_step(model, mesh, project=True,
                           n_rays=rays_per_device * mesh.size,
                           n_eikonal_points=256 * mesh.size)

    def once():
        draws = trainer.draw(step.n_rays, (image_size, image_size), 1,
                             n_points=state.points.shape[1],
                             n_eikonal=step.n_eikonal)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        step(state.opt_state, state.points, state.points_mask, None, img, mask,
             camera, HP, draws)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(n_iters))


def _rank(rank: int, world: int, store: str, kw: Dict, out: str) -> None:
    """One rank of a world size's run; rank 0 writes its seconds to `out`."""
    from isopoints_torch.parallel.sharding import make_mesh

    device = torch.device(kw["device"])
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(kw["threads"])
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(world, device)
        dt = measure(mesh, kw["rays_per_device"], kw["iters"], kw["image_size"],
                     device)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"seconds": dt, "backend": dist.get_backend()}, f)
    finally:
        dist.destroy_process_group()


def run_world(world: int, **kw) -> Dict:
    """One world size: `world` spawned rank processes; returns rank 0's
    {"seconds", "backend"}."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.json")
        mp.start_processes(_rank, args=(world, os.path.join(d, "store"), kw, out),
                           nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)


def device_label(device: str) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world-sizes", type=int, nargs="*", default=None,
                    help="default: 1, 2, 4, 8 up to the cards there are (cuda) "
                         "or 1 and 2 (cpu)")
    ap.add_argument("--rays-per-device", type=int, default=2048)
    ap.add_argument("--total-rays", type=int, default=0,
                    help="hold the total ray budget fixed across world sizes")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.world_sizes:
        sizes = args.world_sizes
    elif torch.device(args.device).type == "cuda":
        n = torch.cuda.device_count()
        sizes = sorted({s for s in (1, 2, 4, 8, n) if s <= n})
    else:
        sizes = [1, 2]
    lines, base = [], None
    for n in sizes:
        per_dev = args.total_rays // n if args.total_rays else args.rays_per_device
        res = run_world(n, device=args.device, rays_per_device=per_dev,
                        iters=args.iters, image_size=args.image_size,
                        threads=max(1, torch.get_num_threads() // n))
        line = scaling_line(n, per_dev, res["seconds"], res["backend"],
                            device_label(args.device), base,
                            constant_total=bool(args.total_rays))
        if n == 1:
            base = per_dev / res["seconds"]
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def scaling_line(n: int, per_dev: int, seconds: float, backend: str,
                 device: str, base_rays_per_s=None,
                 constant_total: bool = False) -> Dict:
    """One world size's JSON line; `base_rays_per_s` is world size 1's
    rate (None: this line is world size 1's)."""
    rays_per_s = per_dev * n / seconds
    base = base_rays_per_s or (rays_per_s if n == 1 else None)
    if constant_total:
        key, eff = "partition_overhead_efficiency", (
            rays_per_s / base if base else float("nan"))
    else:
        key, eff = "weak_scaling_efficiency", (
            rays_per_s / (n * base) if base else float("nan"))
    return {"backend": backend, "device": device, "n_devices": n,
            "rays_per_device": per_dev, "total_rays_per_s": round(rays_per_s, 1),
            "step_ms": round(seconds * 1e3, 2), key: round(eff, 4)}


if __name__ == "__main__":
    main()
