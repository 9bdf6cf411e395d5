"""Build the ablation's dataset: a compound CSG mesh rendered into a 512-px
MVR directory (port of scripts/make_ablation_data.py).

    python -m isopoints_torch.make_ablation_data OUT_DIR [--image-size 512] \
        [--n-views 24] [--mesh-resolution 128] [--n-gt-points 20000] \
        [--seed 0] [--device cuda|cpu]

The solid (`compound_sdf`: a torus and an axle box joined by two end
spheres, with a vertical bore through the axle) has a through-hole,
concave junctions and thin features. Its SDF is evaluated on a grid on
`--device` and meshed by marching tetrahedra on the host (utils/meshing.py),
the largest component is kept, and the mesh is ray-cast exactly into the
views (ops/raymesh.py, the Möller–Trumbore kernel on the card) and written
as the MVR layout (image/, mask/, depth/, data_dict.npz with the cameras
and GT surface samples, the normalised mesh.ply) plus mesh_source.ply, the
mesh before normalisation. `main(argv)` returns (source verts, source
faces, the in-memory MVR arrays).
"""

import argparse
import os
from typing import Callable

import torch


def compound_sdf() -> Callable[[torch.Tensor], torch.Tensor]:
    """Torus ∪ axle box ∪ two end spheres, minus a vertical bore
    (make_ablation_data.py:26-58)."""
    def f(x):
        dev = x.device
        # main ring, in the xy plane
        q = torch.stack([torch.linalg.norm(x[..., :2], dim=-1) - 0.55,
                         x[..., 2]], -1)
        torus = torch.linalg.norm(q, dim=-1) - 0.16
        # axle: a box through the ring along x
        qb = torch.abs(x) - torch.tensor([0.68, 0.12, 0.12], device=dev)
        box = (torch.linalg.norm(torch.clamp(qb, min=0.0), dim=-1)
               + torch.clamp(torch.amax(qb, dim=-1), max=0.0))
        # end caps
        cap = torch.tensor([0.68, 0.0, 0.0], device=dev)
        s1 = torch.linalg.norm(x - cap, dim=-1) - 0.2
        s2 = torch.linalg.norm(x + cap, dim=-1) - 0.2
        solid = torch.minimum(torch.minimum(torus, box), torch.minimum(s1, s2))
        # the bore: subtract a z-cylinder
        cyl = torch.linalg.norm(x[..., :2], dim=-1) - 0.09
        return torch.maximum(solid, -cyl)
    return f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", type=str)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--n-views", type=int, default=24)
    ap.add_argument("--mesh-resolution", type=int, default=128)
    ap.add_argument("--n-gt-points", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from isopoints_torch import get_logger
    from isopoints_torch.data import synthetic
    from isopoints_torch.utils.io import save_ply
    from isopoints_torch.utils.meshing import extract_mesh, largest_component

    log = get_logger()
    device = torch.device(args.device)
    verts, faces = extract_mesh(compound_sdf(), args.mesh_resolution,
                                bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3,
                                device=device)
    verts, faces = largest_component(verts, faces)
    log.info("compound mesh: %d verts, %d faces", len(verts), len(faces))
    data = synthetic.make_mesh_mvr(
        verts, faces, n_views=args.n_views, image_size=args.image_size,
        seed=args.seed, norm_radius=0.7, n_gt_points=args.n_gt_points,
        device=device)
    synthetic.export_mvr_dataset(data, args.out_dir)
    save_ply(os.path.join(args.out_dir, "mesh_source.ply"), verts, faces=faces)
    log.info("wrote %d views at %d px to %s", args.n_views, args.image_size,
             args.out_dir)
    return verts, faces, data


if __name__ == "__main__":
    main()
