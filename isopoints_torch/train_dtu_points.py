"""Point-cloud surface reconstruction entry, the DTU workload (port of
train_dtu_points.py): fit a SIREN (or IGR) SDF to a noisy point cloud with
periodic iso-point refreshes and reweighting, then mesh it.

    python -m isopoints_torch.train_dtu_points scan.ply --out-dir out/scan
    python -m isopoints_torch.train_dtu_points synthetic:torus --total-iters 500

A `.ply` is read with its normals when it has them; `synthetic:{sphere,
torus,box}` makes a noisy cloud of the analytic shape. The cloud is
normalised into a cube of side 1.5 and the final mesh mapped back. Runs on
CUDA unless `--device cpu`.
"""

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from isopoints_torch.core.cloud import PointCloud
from isopoints_torch.data.synthetic import SDFS
from isopoints_torch.logger import get_logger
from isopoints_torch.models.levelset import project_points_newton
from isopoints_torch.utils.io import read_ply
from isopoints_torch.workloads.dtu_points import DTUPointsConfig, fit_point_cloud


def load_cloud(spec: str, n_noise: float, n_points: int, seed: int,
               device="cuda"):
    """A `.ply` (subsampled to `n_points` when it has more; 0 keeps it
    whole) or a synthetic noisy cloud 'synthetic:sphere|torus|box':
    `n_points or 20000` points uniform in ±0.8 from `RandomState(seed)`,
    Newton-projected onto the shape on `device` (30 iterations, tolerance
    1e-5), the converged ones kept, plus normal noise of sigma `n_noise`
    from the same `RandomState`. Returns (points (P, 3) float32, normals
    or None)."""
    if spec.startswith("synthetic:"):
        sdf_fn = SDFS[spec.split(":", 1)[1]]()
        n_points = n_points or 20000
        rng = np.random.RandomState(seed)
        init = torch.as_tensor(rng.uniform(-0.8, 0.8, (1, n_points, 3))
                               .astype(np.float32), device=device)
        proj = project_points_newton(
            sdf_fn, init, torch.ones((1, n_points), dtype=torch.bool,
                                     device=device),
            max_iters=30, tolerance=1e-5)
        pts = proj.points[0][proj.mask[0]].cpu().numpy()
        pts = pts + rng.normal(scale=n_noise, size=pts.shape)
        return pts.astype(np.float32), None
    data = read_ply(spec)
    pts = data["points"].astype(np.float32)
    normals = data.get("normals")
    if n_points > 0 and len(pts) > n_points:
        idx = np.random.RandomState(seed).choice(len(pts), n_points,
                                                 replace=False)
        pts = pts[idx]
        normals = None if normals is None else normals[idx]
    return pts, None if normals is None else normals.astype(np.float32)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("pointcloud", type=str,
                        help=".ply path or synthetic:{sphere,torus,box}")
    parser.add_argument("--out-dir", type=str, default="out/dtu_points")
    parser.add_argument("--decoder-type", choices=["siren", "sdf"],
                        default="siren")
    parser.add_argument("--total-iters", type=int, default=2000)
    parser.add_argument("--warm-up", type=int, default=200)
    parser.add_argument("--resample-every", type=int, default=500)
    parser.add_argument("--n-points", type=int, default=0,
                        help="optional random subsample; 0 = keep the full "
                             "cloud")
    parser.add_argument("--n-iso-points", type=int, default=4000)
    parser.add_argument("--batch-size", type=int, default=5000)
    parser.add_argument("--weight-mode", type=int, default=1,
                        help="-1 off, 1 bilateral, 2 laplacian, 3 heat-kernel")
    parser.add_argument("--ear", action="store_true",
                        help="edge-aware iso-point projection")
    parser.add_argument("--use-off-normal-loss", action="store_true")
    parser.add_argument("--mesh-resolution", type=int, default=256)
    parser.add_argument("--noise", type=float, default=0.02,
                        help="synthetic cloud noise sigma")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda unless asked otherwise)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Run the entry; returns fit_point_cloud's (decoder, info)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_dtu_points: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    log = get_logger()
    os.makedirs(args.out_dir, exist_ok=True)
    pts, normals = load_cloud(args.pointcloud, args.noise, args.n_points,
                              args.seed, device=dev)
    log.info("loaded %d points from %s", len(pts), args.pointcloud)

    # normalise to about [-0.75, 0.75]^3
    pc, center, scale = PointCloud.create(points=torch.from_numpy(pts)[None]) \
        .normalize_to_box(side=1.5)
    pts_n = pc.points[0].numpy()
    center = center.numpy().ravel()
    scale = float(scale.numpy().ravel()[0])
    log.info("normalized: center=%s scale=%.4f", center, scale)

    cfg = DTUPointsConfig(
        decoder_type=args.decoder_type, total_iters=args.total_iters,
        warm_up=args.warm_up, resample_every=args.resample_every,
        n_iso_points=args.n_iso_points,
        batch_size=min(args.batch_size, len(pts_n)),
        weight_mode=args.weight_mode, ear=args.ear,
        use_off_normal_loss=args.use_off_normal_loss,
        mesh_resolution=args.mesh_resolution)
    out = fit_point_cloud(pts_n, normals, cfg, seed=args.seed,
                          out_dir=args.out_dir, denormalize=(center, scale),
                          device=dev)
    log.info("finished; outputs in %s", args.out_dir)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
