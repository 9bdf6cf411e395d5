"""Write an MVR dataset directory of an analytic shape (port of
scripts/create_mvr_data.py for the analytic shapes).

    python -m isopoints_torch.create_mvr_data {sphere,torus,box} OUT_DIR \
        [--n-views 24] [--image-size 128] [--camera-distance 2.0] \
        [--focal-length 2.0] [--seed 0] [--dtu] [--device cuda|cpu]

The views are ray-traced with the port's own ray engine and Phong-shaded
(data/synthetic.py), then written as the MVRDataset layout (image/*.png,
mask/*.png, data_dict.npz with the cameras and ground-truth surface
samples) that `data: {type: MVR, data_dir: OUT_DIR}` reads. With `--dtu`
the same shape is written in the IDR/DTU layout that `type: DTU` reads
(cameras.npz with per-view projections, points.ply; `--focal-length` is
then unused: the focal length is the image size in pixels). Rendering a
mesh (`mesh`) needs the mesh ray-caster, which is not ported yet (ROADMAP
Queue 1 item E; marching tetrahedra and the mesh I/O are). `main(argv)`
returns the in-memory MVR arrays it wrote (None with `--dtu`).
"""

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shape", choices=["sphere", "torus", "box", "mesh"])
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--n-views", type=int, default=24)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--camera-distance", type=float, default=2.0)
    parser.add_argument("--focal-length", type=float, default=2.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtu", action="store_true",
                        help="write the IDR/DTU layout instead of the MVR one")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.shape == "mesh":
        raise NotImplementedError(
            "shape 'mesh' needs the mesh ray-caster (ops/raymesh.py) of "
            "ROADMAP Queue 1 item E, which is not ported yet")

    from isopoints_torch import get_logger
    from isopoints_torch.data import synthetic

    sdf_fn = synthetic.SDFS[args.shape]()
    device = torch.device(args.device)
    data = None
    if args.dtu:
        synthetic.make_synthetic_dtu(
            sdf_fn, args.out_dir, n_views=args.n_views,
            image_size=args.image_size, dist=args.camera_distance,
            seed=args.seed, device=device)
    else:
        data = synthetic.make_synthetic_mvr(
            sdf_fn, n_views=args.n_views, image_size=args.image_size,
            dist=args.camera_distance, focal=args.focal_length, seed=args.seed,
            device=device)
        synthetic.export_mvr_dataset(data, args.out_dir)
    get_logger().info("wrote %d views of the %s to %s", args.n_views,
                      args.shape, args.out_dir)
    return data


if __name__ == "__main__":
    main()
