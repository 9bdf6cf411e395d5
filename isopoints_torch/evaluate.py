"""Mesh evaluation against a ground truth (port of evaluate.py).

    python -m isopoints_torch.evaluate EXP_DIR (--gt-mesh PLY | --gt-points PLY
        | --gt-sdf {sphere,torus,box}) [--n-samples 50000]
        [--scale-mat-from DTU_DIR] [--device cuda|cpu]

Every mesh under EXP_DIR (a `*mesh*.ply` or `final.ply` with faces) is
sampled at `--n-samples` points and scored against the GT surface samples:
chamfer_p, chamfer_n, and the point-face distance (predicted samples to the
GT faces with `--gt-mesh`, else GT points to the predicted faces,
`point_face_rev`). GT samples: `--n-samples` area-weighted samples of a GT
mesh (cached in EXP_DIR/val{n}_mesh.npz, read back when present, as is
val{n}_{points,sphere,...}.npz), the first `--n-samples` points of a GT
cloud, or uniform points Newton-projected onto an analytic SDF of
data/synthetic.py. `--scale-mat-from` applies a DTU scan's scale_mat to
every mesh that lacks the mesh.ply.denormalized marker `generate_mvr`
writes. Writes EXP_DIR/eval.csv. Runs on `--device` (default cuda).
`main(argv)` returns the rows.
"""

import argparse
import csv
import glob
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("exp_dir", type=str)
    parser.add_argument("--gt-mesh", type=str, default=None,
                        help="GT mesh .ply (sampled to --n-samples points)")
    parser.add_argument("--gt-points", type=str, default=None,
                        help="GT point cloud .ply")
    parser.add_argument("--gt-sdf", type=str, default=None,
                        choices=["sphere", "torus", "box"],
                        help="analytic GT surface (synthetic runs)")
    parser.add_argument("--n-samples", type=int, default=50000)
    parser.add_argument("--scale-mat-from", type=str, default=None,
                        metavar="DATA_DIR",
                        help="DTU data dir: apply its scale_mat to every mesh "
                             "not marked as already denormalized")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.training.evaluation import evaluate_mesh
    from isopoints_torch.utils.io import read_ply
    from isopoints_torch.utils.meshing import sample_points_from_mesh

    log = get_logger()
    device = torch.device(args.device)
    # the cache is keyed by the GT source, so switching --gt-* never reuses
    # stale samples
    src_tag = ("mesh" if args.gt_mesh else
               "points" if args.gt_points else args.gt_sdf or "none")
    cache = os.path.join(args.exp_dir, f"val{args.n_samples}_{src_tag}.npz")
    gt_normals = None
    if os.path.exists(cache):
        with np.load(cache) as d:
            gt_points = d["points"]
            gt_normals = d["normals"] if "normals" in d else None
    elif args.gt_points:
        data = read_ply(args.gt_points)
        gt_points = data["points"][:args.n_samples]
        gt_normals = data.get("normals")
        if gt_normals is not None:
            gt_normals = gt_normals[:args.n_samples]
    elif args.gt_mesh:
        data = read_ply(args.gt_mesh)
        gt_points, gt_normals = sample_points_from_mesh(
            data["points"], data["faces"], args.n_samples)
        np.savez(cache, points=gt_points, normals=gt_normals)
    elif args.gt_sdf:
        gt_points = analytic_gt_points(args.gt_sdf, args.n_samples, device)
    else:
        parser.error("one of --gt-mesh/--gt-points/--gt-sdf is required")

    meshes = sorted(glob.glob(os.path.join(args.exp_dir, "**", "*.ply"),
                              recursive=True))
    meshes = [m for m in meshes if "mesh" in os.path.basename(m)
              or os.path.basename(m) == "final.ply"]
    if not meshes:
        log.warning("no meshes found under %s", args.exp_dir)
        return []
    gt_verts = gt_faces = None
    if args.gt_mesh:
        gd = read_ply(args.gt_mesh)
        gt_verts, gt_faces = gd["points"], gd.get("faces")
    scale_mat = None
    if args.scale_mat_from:
        from isopoints_torch.data.dataset import DTUDataset

        scale_mat = DTUDataset(args.scale_mat_from).get_scale_mat()
        log.info("denormalizing meshes with scale_mat from %s",
                 args.scale_mat_from)

    rows = []
    for m in meshes:
        data = read_ply(m)
        if data.get("faces") is None:
            continue
        if scale_mat is not None:
            if os.path.exists(m + ".denormalized"):
                # generate_mvr wrote this mesh in world coordinates already
                log.info("%s: already denormalized (marker present), "
                         "skipping scale_mat", os.path.relpath(m, args.exp_dir))
            else:
                data["points"] = (data["points"] @ scale_mat[:3, :3].T
                                  + scale_mat[:3, 3])
        metrics = evaluate_mesh(data["points"], data["faces"], gt_points,
                                gt_normals, gt_verts=gt_verts,
                                gt_faces=gt_faces, n_samples=args.n_samples,
                                device=device)
        row = {"mesh": os.path.relpath(m, args.exp_dir), **metrics}
        rows.append(row)
        log.info("%s: %s", row["mesh"],
                 " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))
    if not rows:
        log.warning("no evaluable meshes (missing faces?) under %s",
                    args.exp_dir)
        return rows
    out_csv = os.path.join(args.exp_dir, "eval.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    log.info("wrote %s", out_csv)
    return rows


def analytic_gt_points(shape: str, n_samples: int, device) -> np.ndarray:
    """Surface samples of an analytic shape (evaluate.py:75-90): points
    uniform in [-0.8, 0.8)³ from `np.random.RandomState(0)`, Newton-projected
    (30 iterations, tolerance 1e-5); those that converged."""
    from isopoints_torch.data import synthetic
    from isopoints_torch.models.levelset import project_points_newton

    rng = np.random.RandomState(0)
    init = torch.as_tensor(rng.uniform(-0.8, 0.8, (1, n_samples, 3)),
                           dtype=torch.float32, device=device)
    proj = project_points_newton(
        synthetic.SDFS[shape](), init,
        torch.ones((1, n_samples), dtype=torch.bool, device=device),
        max_iters=30, tolerance=1e-5)
    return proj.points[0][proj.mask[0]].cpu().numpy()


if __name__ == "__main__":
    main()
