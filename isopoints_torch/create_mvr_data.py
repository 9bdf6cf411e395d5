"""Write an MVR dataset directory of an analytic shape or a mesh (port of
scripts/create_mvr_data.py).

    python -m isopoints_torch.create_mvr_data {sphere,torus,box} OUT_DIR \
        [--n-views 24] [--image-size 128] [--camera-distance 2.0] \
        [--focal-length 2.0] [--seed 0] [--dtu] [--device cuda|cpu]
    python -m isopoints_torch.create_mvr_data mesh OUT_DIR --mesh M.ply \
        [--norm-radius 0.7] [--n-gt-points 20000] [...]

The views are ray-traced with the port's own ray engine and Phong-shaded
(data/synthetic.py), then written as the MVRDataset layout (image/*.png,
mask/*.png, data_dict.npz with the cameras and ground-truth surface
samples) that `data: {type: MVR, data_dir: OUT_DIR}` reads. With `--dtu`
the same shape is written in the IDR/DTU layout that `type: DTU` reads
(cameras.npz with per-view projections, points.ply; `--focal-length` is
then unused: the focal length is the image size in pixels). A mesh
(`mesh --mesh PATH`, PLY or OBJ) is normalised into the sphere of
`--norm-radius`, ray-cast exactly (ops/raymesh.py, the Möller–Trumbore
kernel on the card) and flat-shaded; the directory then also holds depth/
and the normalised mesh.ply, and `--n-gt-points` area-weighted surface
samples. `main(argv)` returns the in-memory MVR arrays it wrote (None with
`--dtu`).
"""

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shape", choices=["sphere", "torus", "box", "mesh"])
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--mesh", type=str, default=None,
                        help="PLY/OBJ mesh path (shape mesh)")
    parser.add_argument("--n-views", type=int, default=24)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--camera-distance", type=float, default=2.0)
    parser.add_argument("--focal-length", type=float, default=2.0)
    parser.add_argument("--norm-radius", type=float, default=0.7,
                        help="mesh normalisation radius (< 1 keeps it inside "
                             "the tracer's bounding sphere)")
    parser.add_argument("--n-gt-points", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtu", action="store_true",
                        help="write the IDR/DTU layout instead of the MVR one")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.shape == "mesh" and not args.mesh:
        parser.error("shape mesh needs --mesh PATH")
    if args.shape == "mesh" and args.dtu:
        parser.error("--dtu writes analytic shapes only, as the JAX script")

    from isopoints_torch import get_logger
    from isopoints_torch.data import synthetic

    device = torch.device(args.device)
    data = None
    if args.dtu:
        synthetic.make_synthetic_dtu(
            synthetic.SDFS[args.shape](), args.out_dir, n_views=args.n_views,
            image_size=args.image_size, dist=args.camera_distance,
            seed=args.seed, device=device)
    else:
        if args.shape == "mesh":
            from isopoints_torch.utils.io import load_mesh

            mesh = load_mesh(args.mesh)
            data = synthetic.make_mesh_mvr(
                mesh["points"], mesh["faces"], n_views=args.n_views,
                image_size=args.image_size, dist=args.camera_distance,
                focal=args.focal_length, seed=args.seed,
                norm_radius=args.norm_radius, n_gt_points=args.n_gt_points,
                device=device)
        else:
            data = synthetic.make_synthetic_mvr(
                synthetic.SDFS[args.shape](), n_views=args.n_views,
                image_size=args.image_size, dist=args.camera_distance,
                focal=args.focal_length, seed=args.seed, device=device)
        synthetic.export_mvr_dataset(data, args.out_dir)
    get_logger().info("wrote %d views of the %s to %s", args.n_views,
                      args.shape, args.out_dir)
    return data


if __name__ == "__main__":
    main()
