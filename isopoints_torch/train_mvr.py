"""Multiview-reconstruction training (port of the training loop of
train_mvr.py).

    python -m isopoints_torch.train_mvr isopoints_torch/configs/mvr_uni_siren.yml \
        [--max-iters N] [--seed S] [--out-dir DIR] [--device cuda|cpu] \
        [--profile-at IT]

The config is read over configs/default.yaml, as train_mvr.py reads it.
Builds the dataset, model and trainer from the config, runs N steps on
views drawn as a pure function of (seed, it) — warm-up steps before the
config's `warm_up_iters`, projected steps with iso-point resampling from
then on (the trainer logs each resample's start and yield) — and appends
one JSON object per step to OUT_DIR/metrics.jsonl. `--profile-at IT`
traces iterations IT..IT+4 with torch.profiler into OUT_DIR/profile/
(chrome trace + an op table sorted by device time), as train_mvr.py's
`--profile-at` does with the JAX profiler.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

PRINT_EVERY = 10


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", type=str)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--max-iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--profile-at", type=int, default=-1)
    args = parser.parse_args(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.config import (default_config_path, load_config,
                                        save_config)
    from isopoints_torch.core.camera import cameras_from_matrices
    from isopoints_torch.factories import (create_dataset, create_model,
                                           create_trainer)

    log = get_logger()
    device = torch.device(args.device)
    cfg = load_config(args.config, default_config_path())
    out_dir = args.out_dir or os.path.join(
        "out", "torch_" + os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(out_dir, exist_ok=True)
    save_config(os.path.join(out_dir, "config.yaml"), cfg)

    data = create_dataset(cfg, device=device)
    images = torch.as_tensor(data["img.rgb"], device=device)
    masks = torch.as_tensor(data["img.mask"], device=device)
    n_views = images.shape[0]
    log.info("dataset: %d views of %s", n_views, tuple(images.shape[1:3]))

    model = create_model(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    trainer = create_trainer(model, cfg, seed=args.seed, device=device)
    state = trainer.init_state()

    batch_views = 2
    prof = None
    t_start = time.time()
    with open(os.path.join(out_dir, "metrics.jsonl"), "a",
              buffering=1) as metrics_file:
        for it in range(args.max_iters):
            if it == args.profile_at:
                prof = _start_profiler(device)
            r = np.random.RandomState((args.seed * 1_000_003 + it) % (2 ** 31))
            idx = r.choice(n_views, size=batch_views,
                           replace=batch_views > n_views)
            idx_t = torch.as_tensor(idx, device=device)
            camera = cameras_from_matrices(data["camera_mat"][idx],
                                           data["focal_length"],
                                           data["principal_point"], device)
            state, metrics = trainer.train_step(state, images[idx_t],
                                                masks[idx_t], camera)
            metrics_file.write(json.dumps({"it": it, "ts": time.time(),
                                           **metrics}) + "\n")
            if prof is not None and it == args.profile_at + 4:
                _stop_profiler(prof, device, os.path.join(out_dir, "profile"))
                prof = None
            if it % PRINT_EVERY == 0:
                log.info("it %05d %s", it, " ".join(
                    f"{k}={v:.4g}" for k, v in metrics.items()))
    if not trainer.check_state():
        raise SystemExit("non-finite parameters after training")
    log.info("done: %d iters in %.1fs", args.max_iters, time.time() - t_start)


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
