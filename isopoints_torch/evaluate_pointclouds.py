"""Point-cloud to point-cloud chamfer (port of scripts/evaluate_pointclouds.py).

    python -m isopoints_torch.evaluate_pointclouds PRED.ply GT.ply \
        [--max-points 50000] [--device cuda|cpu]

Each cloud larger than `--max-points` is cut to that many points drawn
without replacement by `np.random.RandomState(0)`, as the JAX script draws
them. The squared chamfer (and the normal consistency where both clouds
have normals) takes its nearest neighbours from the kNN kernel on the card
(`training/evaluation.chamfer_distance`, k = 1 both ways). Prints one
`name: value` line a metric; `main(argv)` returns the metrics.
"""

import argparse

import numpy as np
import torch


def load_cloud(path: str, max_points: int):
    """(points, normals or None) of a PLY, cut to `max_points` by the
    seeded draw."""
    from isopoints_torch.utils.io import read_ply

    d = read_ply(path)
    pts, nrm = d["points"], d.get("normals")
    if len(pts) > max_points:
        idx = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[idx]
        nrm = None if nrm is None else nrm[idx]
    return pts, nrm


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("pred", type=str)
    parser.add_argument("gt", type=str)
    parser.add_argument("--max-points", type=int, default=50000)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from isopoints_torch.training.evaluation import chamfer_distance

    dev = torch.device(args.device)
    t = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a, np.float32), device=dev)
    p, pn = load_cloud(args.pred, args.max_points)
    g, gn = load_cloud(args.gt, args.max_points)
    m = chamfer_distance(t(p), t(g), x_normals=t(pn), y_normals=t(gn))
    for k, v in m.items():
        print(f"{k}: {v:.6g}")
    return m


if __name__ == "__main__":
    main()
