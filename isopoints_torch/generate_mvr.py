"""Mesh and images of a trained MVR checkpoint (port of generate_mvr.py).

    python -m isopoints_torch.generate_mvr CONFIG [--checkpoint PATH] \
        [--out-dir DIR] [--mesh-resolution 256] [--image-size 256] \
        [--n-views 4] [--device cuda|cpu]

The config is read over configs/default.yaml; the checkpoint defaults to
out/torch_<config name>/model.npz (where `train_mvr` writes it) and the
output to its directory's `generation/`. Writes mesh.ply, the two-stage
extraction at `--mesh-resolution` (in the scan's world frame for DTU data:
its `scale_mat` applied, with the marker file mesh.ply.denormalized that
`evaluate --scale-mat-from` reads), and view_%03d.png, `--n-views` RGBA
renders at `--image-size` px from cameras around the object at elevation
15°. `--iso-contours` also writes iso_contour.html, the SDF's contours on
axis-aligned cuts (`Generator.generate_iso_contour`). `main(argv)` returns
(verts, faces, rgba).
"""

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", type=str)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--mesh-resolution", type=int, default=256)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--n-views", type=int, default=4)
    parser.add_argument("--iso-contours", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.config import default_config_path, load_config
    from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.models.generator import Generator, GeneratorConfig
    from isopoints_torch.utils.io import save_image, save_ply

    log = get_logger()
    device = torch.device(args.device)
    cfg = load_config(args.config, default_config_path())
    run_name = os.path.splitext(os.path.basename(args.config))[0]
    ckpt_path = args.checkpoint or os.path.join("out", "torch_" + run_name,
                                                "model.npz")
    out_dir = args.out_dir or os.path.join(os.path.dirname(ckpt_path),
                                           "generation")
    os.makedirs(out_dir, exist_ok=True)

    model = create_model(cfg, device=device)
    ckpt = CheckpointIO(os.path.dirname(ckpt_path) or ".",
                        model=model.state_dict())
    scalars = ckpt.load(os.path.basename(ckpt_path))
    model.load_state_dict(ckpt.registry["model"])
    log.info("loaded checkpoint (it=%s)", scalars.get("it"))
    gen = Generator(model, GeneratorConfig(mesh_resolution=args.mesh_resolution,
                                           image_size=args.image_size))

    verts, faces = gen.generate_mesh()
    mesh_path = os.path.join(out_dir, "mesh.ply")
    if str(cfg.data.get("type", "")).upper() == "DTU":
        # the model is trained in scale_mat-normalized coordinates; the
        # mesh goes out in the scan's world frame (generate_mvr.py:57-71)
        from isopoints_torch.data.dataset import DTUDataset

        sm = DTUDataset(cfg.data.data_dir).get_scale_mat()
        verts = verts @ sm[:3, :3].T + sm[:3, 3]
        log.info("applied DTU scale_mat denormalization")
        with open(mesh_path + ".denormalized", "w") as f:
            f.write("scale_mat applied by generate_mvr\n")
    save_ply(mesh_path, verts, faces=faces)
    log.info("mesh: %d verts %d faces -> %s", len(verts), len(faces), mesh_path)
    if args.iso_contours:
        gen.generate_iso_contour(os.path.join(out_dir, "iso_contour.html"))
        log.info("iso contours -> %s/iso_contour.html", out_dir)

    n = args.n_views
    R, T = look_at_view_transform([cfg.data.get("camera_distance", 2.0)] * n,
                                  [15.0] * n,
                                  np.linspace(0, 360, n, endpoint=False),
                                  device=device)
    camera = PerspectiveCamera.create(
        R=R, T=T, focal_length=cfg.data.get("focal_length", 2.0), device=device)
    rgba = gen.raytrace_images(camera)
    for i in range(n):
        save_image(os.path.join(out_dir, f"view_{i:03d}.png"), rgba[i])
    log.info("%d ray-traced views -> %s", n, out_dir)
    return verts, faces, rgba


if __name__ == "__main__":
    main()
