"""Multiview-reconstruction training (port of train_mvr.py).

    python -m isopoints_torch.train_mvr CONFIG [--max-iters N] [--seed S] \
        [--out-dir DIR] [--device cuda|cpu] [--checkpoint-every N] \
        [--print-every N] [--exit-after SECONDS] [--fresh-keys] \
        [--profile-at IT] [--validate-every N] [--visualize-every N] \
        [--eval-mesh-resolution R] [--n-devices N] [--multihost] \
        [--restart-every-resample]

    torchrun --nproc-per-node N -m isopoints_torch.train_mvr CONFIG \
        --n-devices N [--multihost]

The config is read over configs/default.yaml, as train_mvr.py reads it.
Builds the dataset (an MVR or DTU directory, or a synthetic shape rendered
in memory), the model and the trainer from the config, and runs to
`--max-iters` on views drawn as a pure function of (seed, it): warm-up
steps before the config's `warm_up_iters`, projected steps with iso-point
resampling from then on. Each step appends one JSON row to
OUT_DIR/metrics.jsonl (misc/metrics.py).

Checkpoints: OUT_DIR/model.npz holds the parameters, the Adam state, the
iso-point buffer and its cached splat spacing, the saliency reference
cloud and its statistics (`saliency:` entries), the iteration and the
trainer's generator state. It is written every `--checkpoint-every`
iterations, at the end, and before `--exit-after SECONDS` of training
ends the process with exit code 3. With `training.checkpoint_backend:
orbax` it is the directory OUT_DIR/model.orbax instead, written through
torch.distributed.checkpoint by every rank (misc/checkpoints.py). With
`--restart-every-resample` the run checkpoints and exits with code 4 right
before each iso-point resample boundary after the iteration it started
from (the first projected iteration and every `resample_every`-th after
it), so that a runner relaunching it runs the resample first in a fresh
process (train_mvr.py:47-50, 284-294); relaunched until done, it ends
where an uninterrupted run ends. A run whose OUT_DIR holds the checkpoint
resumes from it: the buffer's capacity is taken from the file before the
load, and the generator state is restored unless `--fresh-keys`, so the
resumed run draws what the uninterrupted one would have. With
`training.saliency_ref_gt` the saliency reference cloud is seeded from the
data's ground-truth points (an oracle, opt-in). `--profile-at IT` traces
iterations IT..IT+4 with torch.profiler into OUT_DIR/profile/. A hang
watchdog (`ISOPOINTS_WATCHDOG_S`, default 600 s; 0 turns it off) dumps
every thread's stack and exits when one iteration stalls that long; it is
cancelled when `main` returns or raises.

Every `--validate-every` iterations (default 500) the first two views are
scored (`eval_step` on random rays, `eval_step_full` on whole rendered
images, and, where the data has GT points, `evaluate_mesh_vs_gt` on a
one-stage mesh at `--eval-mesh-resolution`); the scores go to
metrics.jsonl as `eval_` rows and the best `iou_full` so far is kept as
OUT_DIR/model_best.npz (with its own saliency state). Every
`--visualize-every` iterations (default off) the plain field is meshed at
96³ into OUT_DIR/{it:06d}_mesh.ply.

`--n-devices N` shards each step's rays over the N processes of a torchrun
launch (parallel/sharding.py; NCCL on the card, one card a process, gloo
with `--device cpu`); without a launch, N > 1 raises ValueError. With
`--multihost` each rank loads only its share of a step's views (one view a
rank, the global batch drawn from (seed, it); parallel/data.py) and the
step gathers them. Every rank validates, so that the ranks' generator chains
stay equal; only rank 0 writes the config, metrics, checkpoints and
meshes. `main(argv)` returns the run's `TrainRun` for callers in the same
process.
"""

import argparse
import faulthandler
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

STAGE_LIMIT_BYTES = 2 * 1024 ** 3   # views staged on the device below this


class TrainRun(NamedTuple):
    cfg: object
    trainer: object
    state: object
    # views(idx) -> (images, masks, cameras) of those views, on the device
    views: Callable


def draw_views(seed: int, it: int, n_views: int, batch_views: int = 2):
    """The views of iteration `it`: a pure function of (seed, it), so a
    resumed run draws the uninterrupted run's views."""
    r = np.random.RandomState((seed * 1_000_003 + it) % (2 ** 31))
    return r.choice(n_views, size=batch_views, replace=batch_views > n_views)


def _parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", type=str)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--max-iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--print-every", type=int, default=20)
    parser.add_argument("--exit-after", type=float, default=-1,
                        help="checkpoint and exit(3) after this many seconds")
    parser.add_argument("--fresh-keys", action="store_true",
                        help="on resume, do not restore the generator state "
                             "from the checkpoint")
    parser.add_argument("--profile-at", type=int, default=-1)
    parser.add_argument("--validate-every", type=int, default=500)
    parser.add_argument("--visualize-every", type=int, default=-1)
    parser.add_argument("--eval-mesh-resolution", type=int, default=96)
    parser.add_argument("--n-devices", type=int, default=1,
                        help="shard the rays over the N ranks of a torchrun "
                             "launch (0 = every rank)")
    parser.add_argument("--multihost", action="store_true",
                        help="each rank loads only its share of a step's "
                             "views (one a rank); the step gathers them")
    parser.add_argument("--restart-every-resample", action="store_true",
                        help="checkpoint and exit(4) right before each "
                             "iso-point resample boundary after the start, "
                             "so that a relaunch runs the resample first")
    return parser.parse_args(argv)


def _views(data, device):
    """(images, masks, get_camera, gt_points, gt_normals) of a dataset:
    `get_camera(idx)` gives those views' cameras on `device` (per-view
    intrinsics for DTU); the GT surface samples may be None."""
    from isopoints_torch.core.camera import cameras_from_matrices
    from isopoints_torch.data.dataset import DTUDataset

    if isinstance(data, dict):   # synthetic: in-memory arrays
        return (data["img.rgb"], data["img.mask"],
                lambda idx: cameras_from_matrices(
                    data["camera_mat"][idx], data["focal_length"],
                    data["principal_point"], device),
                data.get("points"), data.get("normals"))
    items = [data[i] for i in range(len(data))]
    images = np.stack([i["img.rgb"] for i in items])
    masks = np.stack([i["img.mask"] for i in items])
    if isinstance(data, DTUDataset):
        gt = data.get_gt_pointcloud() or {}
        return (images, masks,
                lambda idx: data.camera(idx, images.shape[1:3], device=device),
                gt.get("points"), gt.get("normals"))
    points, normals, _ = data.get_pointclouds()
    return (images, masks, lambda idx: data.camera(idx, device=device),
            points, normals)


def _adopt_saved_shapes(ckpt, filename: str, device) -> None:
    """Take the checkpoint's shapes for the state whose size changes in
    training: the iso-point buffer (its capacity follows the resample
    targets), its cached spacing and the saliency arrays. The non-strict
    load would otherwise keep the templates of a fresh start (the random
    initial points) and only warn."""
    saved = ckpt.saved_arrays(filename)
    for name in ("points", "points_mask", "spacing"):
        key = name + ":"
        tmpl = ckpt.registry.get(name)
        if key in saved and (tmpl is None or tuple(tmpl.shape) != saved[key][0]):
            ckpt.registry[name] = torch.from_numpy(np.zeros(*saved[key])).to(device)
    sal = {k[len("saliency:"):]: np.zeros(*v) for k, v in saved.items()
           if k.startswith("saliency:")}
    ckpt.registry["saliency"] = sal or None


def main(argv=None) -> TrainRun:
    args = _parse(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.config import (default_config_path, load_config,
                                        save_config)
    from isopoints_torch.factories import (create_dataset, create_model,
                                           create_trainer)
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.misc.metrics import MetricsWriter
    from isopoints_torch.parallel.data import local_view_indices
    from isopoints_torch.parallel.sharding import any_rank, make_mesh
    from isopoints_torch.training.trainer import TrainState
    from isopoints_torch.utils.io import save_ply
    from isopoints_torch.utils.meshing import extract_mesh

    log = get_logger()
    device = torch.device(args.device)
    # --multihost: the mesh spans every rank of the launch (train_mvr.py:71-74)
    mesh = make_mesh(0 if args.multihost else args.n_devices, device)
    if mesh.group is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    views_sharded = args.multihost and mesh.size > 1
    is_main = mesh.rank == 0
    cfg = load_config(args.config, default_config_path())
    out_dir = args.out_dir or os.path.join(
        "out", "torch_" + os.path.splitext(os.path.basename(args.config))[0])
    if is_main:
        os.makedirs(out_dir, exist_ok=True)
        save_config(os.path.join(out_dir, "config.yaml"), cfg)

    images, masks, get_camera, gt_points, gt_normals = _views(
        create_dataset(cfg, device=device), device)
    n_views = images.shape[0]
    log.info("dataset: %d views of %s", n_views, tuple(images.shape[1:3]))
    if images.nbytes + masks.nbytes < STAGE_LIMIT_BYTES:
        # every view on the device once; a step gathers its two there
        images_dev = torch.as_tensor(images, device=device)
        masks_dev = torch.as_tensor(masks, device=device)

        def views(idx):
            i = torch.as_tensor(idx, device=device)
            return images_dev[i], masks_dev[i], get_camera(idx)
    else:
        def views(idx):
            return (torch.as_tensor(images[idx], device=device),
                    torch.as_tensor(masks[idx], device=device), get_camera(idx))

    model = create_model(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    trainer = create_trainer(model, cfg, seed=args.seed, device=device,
                             n_devices=mesh.size, views_sharded=views_sharded)
    if mesh.size > 1:
        log.info("rank %d of %d; %s", mesh.rank, mesh.size,
                 "views sharded" if views_sharded else "views replicated")
    if (trainer.cfg.saliency_sampling and gt_points is not None
            and cfg.training.get("saliency_ref_gt", False)):
        # an oracle: by default the reference cloud is seeded from the
        # model's own first projected iso-points
        trainer.set_reference_cloud(gt_points)
        log.info("saliency reference cloud (oracle, opt-in): FPS of %d GT "
                 "points", len(gt_points))
    state = trainer.init_state()

    ckpt = CheckpointIO(out_dir, backend=cfg.training.get("checkpoint_backend",
                                                          "npz"))

    def register(state):
        ckpt.register_modules(model=model.state_dict(), opt=state.opt_state,
                              points=state.points, points_mask=state.points_mask,
                              spacing=state.spacing,
                              saliency=trainer.saliency_state())

    def save(name, **extra):
        # the orbax backend's save is collective: every rank writes
        if not is_main and ckpt.backend == "npz":
            return
        register(state)
        ckpt.save(name, it=state.it, rng_state=trainer.generators.state(),
                  **extra)

    register(state)
    if ckpt.exists("model.npz"):
        _adopt_saved_shapes(ckpt, "model.npz", device)
        scalars = ckpt.load("model.npz")
        model.load_state_dict(ckpt.registry["model"])
        state = TrainState(opt_state=ckpt.registry["opt"],
                           points=ckpt.registry["points"],
                           points_mask=ckpt.registry["points_mask"],
                           it=int(scalars.get("it", 0)),
                           spacing=ckpt.registry["spacing"])
        if trainer.cfg.saliency_sampling and ckpt.registry["saliency"] is not None:
            trainer.load_saliency_state(ckpt.registry["saliency"])
        restore = "rng_state" in scalars and not args.fresh_keys
        if restore:
            trainer.generators.set_state(scalars["rng_state"])
        log.info("resumed from it=%d (%s generator state)", state.it,
                 "restored" if restore else "fresh")

    metrics_writer = MetricsWriter(out_dir) if is_main else None
    best_iou = -1.0

    def step_views(it):
        """Two views drawn from (seed, it); with views sharded, one a rank:
        this rank's slice of the global batch drawn from (seed, it)."""
        if not views_sharded:
            return draw_views(args.seed, it, n_views)
        return local_view_indices(draw_views(args.seed, it, n_views, mesh.size),
                                  mesh.rank, mesh.size)

    watchdog_s = int(os.environ.get("ISOPOINTS_WATCHDOG_S", "600"))
    prof = None
    it0 = state.it
    warm_up, resample_every = trainer.cfg.warm_up_iters, trainer.cfg.resample_every
    t_start = t_last = time.time()
    try:
        for it in range(it0, args.max_iters):
            if (args.restart_every_resample and it > it0 and it >= warm_up
                    and (it == warm_up or it % resample_every == 0)):
                # hand the resample to a fresh process; it0 itself is
                # excluded, so that the relaunch runs it instead of exiting
                save("model.npz")
                log.info("restart-every-resample: exiting before resample "
                         "at it=%d", it)
                sys.exit(4)
            if watchdog_s > 0:
                faulthandler.dump_traceback_later(watchdog_s, repeat=True,
                                                  exit=True)
            if it == args.profile_at:
                prof = _start_profiler(device)
            state, metrics = trainer.train_step(state, *views(step_views(it)))
            if is_main:
                metrics_writer.log(it, metrics)
            if prof is not None and it == args.profile_at + 4:
                _stop_profiler(prof, device, os.path.join(out_dir, "profile"))
                prof = None
            if it % args.print_every == 0:
                log.info("it %05d %s (%.1fs)", it, " ".join(
                    f"{k}={v:.4g}" for k, v in metrics.items()),
                    time.time() - t_last)
                t_last = time.time()
            if args.checkpoint_every > 0 and it > 0 and it % args.checkpoint_every == 0:
                log.info("stage: checkpoint it=%d", it)
                save("model.npz")
            if args.validate_every > 0 and it > 0 and it % args.validate_every == 0:
                ev = _validate(trainer, state, it,
                               views(np.arange(min(2, n_views))),
                               gt_points, gt_normals, args.eval_mesh_resolution)
                if is_main:
                    metrics_writer.log(it, ev, prefix="eval_")
                log.info("eval it %05d %s", it, " ".join(
                    f"{k}={v:.4g}" for k, v in ev.items()))
                if ev["iou_full"] > best_iou:
                    best_iou = ev["iou_full"]
                    save("model_best.npz", loss_val_best=best_iou)
            if (is_main and args.visualize_every > 0 and it > 0
                    and it % args.visualize_every == 0):
                verts, faces = extract_mesh(model.sdf_fn(), resolution=96,
                                            device=device)
                save_ply(os.path.join(out_dir, f"{it:06d}_mesh.ply"), verts,
                         faces=faces)
            # decided together, so that no rank waits in a step alone
            if args.exit_after > 0 and any_rank(
                    time.time() - t_start > args.exit_after, mesh, device):
                save("model.npz")
                log.info("exit-after reached; checkpointed at it=%d", state.it)
                sys.exit(3)
    finally:
        if watchdog_s > 0:
            faulthandler.cancel_dump_traceback_later()
        if prof is not None:
            prof.stop()
        if metrics_writer is not None:
            metrics_writer.close()
    if not trainer.check_state():
        raise SystemExit("non-finite parameters after training")
    save("model.npz")
    log.info("done: %d iters in %.1fs", args.max_iters - it0,
             time.time() - t_start)
    return TrainRun(cfg, trainer, state, views)


def _validate(trainer, state, it: int, batch, gt_points, gt_normals,
              mesh_resolution: int):
    """The validate cadence's scores on one batch of views (train_mvr.py:
    339-358): random rays, whole images, and the mesh against the GT
    samples where there are any."""
    from isopoints_torch import get_logger

    log = get_logger()
    log.info("stage: eval start it=%d", it)
    ev = trainer.eval_step(state, *batch)
    ev.update(trainer.eval_step_full(state, *batch))
    if gt_points is not None:
        ev.update(trainer.evaluate_mesh_vs_gt(state, gt_points, gt_normals,
                                              resolution=mesh_resolution))
    log.info("stage: eval done it=%d", it)
    return ev


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    prof.wall_start = time.perf_counter()
    return prof


def _stop_profiler(prof, device: torch.device, out: str) -> None:
    """Write the trace and an op table; log the device busy share (summed
    device self time over the window's wall time, ignoring overlap)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - prof.wall_start)
    prof.stop()
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=100))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    from isopoints_torch import get_logger
    get_logger().info("profile: 5 steps, %.1f ms wall, %.1f ms device time "
                      "(%.1f%% busy), table in %s", wall_ms, busy_ms,
                      100.0 * busy_ms / wall_ms, out)


if __name__ == "__main__":
    main()
