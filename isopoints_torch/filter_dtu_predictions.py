"""Keep the points of a DTU MVS cloud that every view's silhouette agrees
on (port of scripts/filter_dtu_predictions.py).

    python -m isopoints_torch.filter_dtu_predictions SCAN.ply DTU_DIR OUT.ply \
        [--min-views N] [--chunk 200000] [--device cuda|cpu]

Each point is projected through every view's `DTUDataset` camera, in chunks
of `--chunk` points on `--device`. A view counts a point as in front when
its NDC depth is positive and it lands inside the image, and votes for it
when the nearest mask pixel there is set. A point survives when some view
has it in front and at least `--min-views` of those views (default: all of
them) vote for it. Writes the kept points (and their normals) to OUT.ply;
`main(argv)` returns the keep mask.
"""

import argparse

import numpy as np
import torch


@torch.no_grad()
def silhouette_votes(pts: np.ndarray, ds, chunk: int, device):
    """(front, votes) int32 counts a point over the views of `ds`."""
    from isopoints_torch.ops.images import sample_image_at_ndc

    votes = torch.zeros(len(pts), dtype=torch.int32, device=device)
    front = torch.zeros(len(pts), dtype=torch.int32, device=device)
    image_size = ds[0]["img.mask"].shape[:2]
    pts_d = torch.as_tensor(np.asarray(pts, np.float32), device=device)
    for v in range(len(ds)):
        cam = ds.camera([v], image_size, device=device)
        mask_img = torch.as_tensor(ds[v]["img.mask"], device=device)[None]
        for i in range(0, len(pts), chunk):
            ndc = cam.project_ndc(pts_d[None, i:i + chunk])
            seen = (ndc[0, :, 2] > 0) & torch.all(ndc[0, :, :2].abs() <= 1.0, dim=-1)
            inm = sample_image_at_ndc(mask_img, ndc[..., :2], mode="nearest")[0, :, 0] > 0.5
            front[i:i + chunk] += seen.int()
            votes[i:i + chunk] += (seen & inm).int()
    return front.cpu().numpy(), votes.cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("pointcloud", type=str)
    parser.add_argument("dtu_dir", type=str,
                        help="DTU directory with image/ mask/ cameras.npz")
    parser.add_argument("out", type=str)
    parser.add_argument("--min-views", type=int, default=None,
                        help="default: every view with the point in front")
    parser.add_argument("--chunk", type=int, default=200000)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.data.dataset import DTUDataset
    from isopoints_torch.utils.io import read_ply, save_ply

    data = read_ply(args.pointcloud)
    pts = np.asarray(data["points"], np.float32)
    front, votes = silhouette_votes(pts, DTUDataset(args.dtu_dir), args.chunk,
                                    torch.device(args.device))
    need = front if args.min_views is None else np.minimum(front, args.min_views)
    keep = (front > 0) & (votes >= need)
    get_logger().info("kept %d/%d points", int(keep.sum()), len(pts))
    normals = data.get("normals")
    save_ply(args.out, pts[keep],
             normals=None if normals is None else np.asarray(normals)[keep])
    return keep


if __name__ == "__main__":
    main()
