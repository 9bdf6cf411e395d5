"""The DTU workload's full schedule in both packages on the CPU, from the
same cloud, the same random numbers (the JAX key chain replayed into the
port) and the same initialisation: where the two runs end up after
thousands of steps. Not a test (pytest does not collect it): it takes tens
of minutes.

    python tests/dtu_parity_run.py jax OUT      # the JAX package's run
    python tests/dtu_parity_run.py torch OUT    # the port's run
    python tests/dtu_parity_run.py report OUT   # both side by side

Each run writes OUT/<package>/ (the iso-point PLYs, final.ply) and
OUT/<package>.json (the loss history). The cloud: a noisy torus (R 0.4,
r 0.15, sigma 0.02) of `--n-points` points (default 100,000: the data
normals take the grid search), normalised into a cube of side 1.5 as the
entry does; the workload's defaults but `--mesh-resolution` (default 128).
The report prints the totals at each logged iteration, the valid
iso-points of each refresh and each mesh's distance to the torus.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def cloud(n, seed=0, sigma=0.02):
    """(points normalised into a cube of side 1.5, center, scale)."""
    rng = np.random.RandomState(seed)
    u, v = rng.uniform(0, 2 * np.pi, (2, n))
    p = np.stack([(0.4 + 0.15 * np.cos(v)) * np.cos(u),
                  (0.4 + 0.15 * np.cos(v)) * np.sin(u), 0.15 * np.sin(v)], -1)
    p = (p + rng.normal(scale=sigma, size=p.shape)).astype(np.float32)
    lo, hi = p.min(0), p.max(0)
    center = (lo + hi) / 2.0
    scale = float((hi - lo).max() / 1.5)
    return ((p - center) / scale).astype(np.float32), center, scale


def config(args, package):
    kw = dict(mesh_resolution=args.mesh_resolution, total_iters=args.total_iters)
    if package == "jax":
        from isopoints_tpu.workloads.dtu_points import DTUPointsConfig
    else:
        from isopoints_torch.workloads.dtu_points import DTUPointsConfig
    return DTUPointsConfig(**kw)


def run(args):
    pts, center, scale = cloud(args.n_points)
    out = os.path.join(args.out, args.package)
    os.makedirs(out, exist_ok=True)
    cfg = config(args, args.package)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from isopoints_tpu.workloads.dtu_points import fit_point_cloud
        _, _, info = fit_point_cloud(pts, None, cfg, seed=0, out_dir=out,
                                     log_every=100, denormalize=(center, scale))
    else:
        import torch
        from isopoints_torch.workloads.dtu_points import fit_point_cloud
        from test_torch_dtu_fit import JaxDraws, converted_decoder
        torch.set_num_threads(args.threads)
        draws = JaxDraws(0)
        _, info = fit_point_cloud(pts, None, cfg, seed=0, out_dir=out,
                                  log_every=100, denormalize=(center, scale),
                                  device="cpu", draws=draws,
                                  decoder=converted_decoder(cfg, draws))
    with open(os.path.join(args.out, f"{args.package}.json"), "w") as f:
        json.dump(info["history"], f)


def report(args):
    import torch
    from isopoints_torch.data.synthetic import torus_sdf
    from isopoints_torch.utils.io import read_ply
    hist = {}
    for pkg in ("jax", "torch"):
        with open(os.path.join(args.out, f"{pkg}.json")) as f:
            hist[pkg] = json.load(f)
    print("iteration: total (JAX, port)")
    for (it, jt, _), (_, tt, _) in zip(hist["jax"], hist["torch"]):
        print(f"  {it}: {jt:.6g} {tt:.6g} (rel {abs(tt - jt) / abs(jt):.3g})")
    for pkg in ("jax", "torch"):
        d = os.path.join(args.out, pkg)
        iso = sorted(f for f in os.listdir(d) if f.endswith("_iso.ply"))
        counts = [len(read_ply(os.path.join(d, f))["points"]) for f in iso]
        mesh = read_ply(os.path.join(d, "final.ply"))
        err = torus_sdf()(torch.from_numpy(mesh["points"])).abs().numpy()
        print(f"{pkg}: refreshes {[f[:10].lstrip('0') for f in iso]} valid "
              f"{counts}; final.ply {len(mesh['points'])} vertices, "
              f"{len(mesh['faces'])} faces; |torus_sdf| median "
              f"{np.median(err):.5f}, 95th percentile "
              f"{np.percentile(err, 95):.5f}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=["jax", "torch", "report"])
    parser.add_argument("out")
    parser.add_argument("--n-points", type=int, default=100_000)
    parser.add_argument("--total-iters", type=int, default=2000)
    parser.add_argument("--mesh-resolution", type=int, default=128)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()
    report(args) if args.package == "report" else run(args)


if __name__ == "__main__":
    main()
