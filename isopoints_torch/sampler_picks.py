"""The rays on which the SIREN sampler kernel picks another step than its
plain version, and why.

    python -m isopoints_torch.sampler_picks [--seeds N]

`tests/test_torch_kernels_cuda.py::test_fused_sampler_matches_twin[0-True]`
holds the fused sampler (SIREN 3x256, 4096 rays, 100 steps in random
order, no secant) to `sweep_plain` over cuBLAS: both picks (`t_pick`, the
first step whose value is negative, and `t_min`, the step of the least
value) equal on 99.9% of the rays. This takes the test's field and rays,
and its 100 steps from each draw: first the one the test took from the
card's global generator while it drew unseeded (the file's earlier global
draws replayed in a fresh process: `torch.rand(n, 3)` for n = 1000, 4096,
4096, 5000, 40000, 77 and 10, then `torch.rand(100)`), then seeds 0..N-1
of a `torch.Generator`. For each draw it runs the kernel and the plain
version twice each (are they repeatable?) and prints every ray whose picks
differ: which pick, its two steps, the field's values there on the
kernel's tile (the fused callable, on which `sweep_plain` equals the
kernel bit for bit), over cuBLAS and with exactly formed sums
(`exact_sums`), and the gap that decides the pick: the value nearest zero
for `t_pick`, the difference of the two values for `t_min`. The last line
is a JSON summary per draw.
"""

import argparse
import json

import torch

from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import fused_mlp, fused_sampler
from isopoints_torch.utils import fma

N_RAYS = 4096
N_STEPS = 100
# the global draws of tests/test_torch_kernels_cuda.py before its random steps
EARLIER_DRAWS = ((1000, 3), (4096, 3), (4096, 3), (5000, 3), (40000, 3),
                 (77, 3), (10, 3))


def case_inputs(dev):
    """The test's SIREN 3x256 (generator seed 0) and its 4096 rays (seed 1),
    as `_sdf` and `_rays` make them."""
    g = torch.Generator(device=dev).manual_seed(0)
    field = SirenField(hidden_size=256, n_layers=3, generator=g, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(N_RAYS, 3).contiguous()
    d = torch.randn(N_RAYS, 3, generator=g, device=dev) * 0.3
    d[:, 2] = 1.0
    d = d / d.norm(dim=-1, keepdim=True)
    t_lo = 0.8 + 0.4 * torch.rand(N_RAYS, generator=g, device=dev)
    t_hi = t_lo + 2.2 * torch.rand(N_RAYS, generator=g, device=dev)
    return fused_mlp.make_fused_siren_sdf(field), (cam, d, t_lo, t_hi)


def differing_rays(sdf, rays, steps):
    """(summary, lines) for one draw of steps."""
    pack = sdf.pack
    plain = lambda p: fused_mlp.siren_sdf_plain(pack, p)
    outs = [sdf.fused_ray_sampler(*rays, steps, n_secant=0) for _ in range(2)]
    refs = [fused_sampler.sweep_plain(plain, *rays, steps, 0) for _ in range(2)]
    repeat_k = all(torch.equal(a, b) for a, b in zip(*outs))
    repeat_p = all(torch.equal(a, b) for a, b in zip(*refs))
    out, ref = outs[0], refs[0]
    cam, d, t_lo, t_hi = rays
    ts = fma(steps, (t_hi - t_lo)[:, None], t_lo[:, None])      # (R, S)
    pts = fma(ts[..., None], d[:, None, :], cam[:, None, :]).reshape(-1, 3)
    f_k = sdf(pts).reshape(ts.shape)
    f_p = plain(pts).reshape(ts.shape)
    f_x = fused_mlp.siren_sdf_plain(pack, pts, exact_sums=True).reshape(ts.shape)
    step_of = lambda r, t: int(torch.argmax((ts[r] == t).int()))
    lines, gaps, exact_with_kernel = [], [], 0
    for which, col in (("t_pick", 0), ("t_min", 2)):
        rays_off = torch.nonzero(out[col] != ref[col])[:, 0]
        for r in rays_off.tolist():
            a, b = step_of(r, out[col][r]), step_of(r, ref[col][r])
            vals = {name: (float(f[r, a]), float(f[r, b]))
                    for name, f in (("kernel", f_k), ("plain", f_p),
                                    ("exact", f_x))}
            if which == "t_pick":
                # the earlier of the two steps is negative on one route only
                s = min(a, b)
                gap = abs(float(f_p[r, s]))
                x = float(f_x[r, s])
                agrees = (x < 0) == (s == a)
            else:
                gap = abs(vals["plain"][0] - vals["plain"][1])
                agrees = vals["exact"][0] < vals["exact"][1] or (
                    vals["exact"][0] == vals["exact"][1] and a < b)
            gaps.append(gap)
            exact_with_kernel += int(agrees)
            lines.append(
                f"  ray {r}: {which} kernel step {a}, plain step {b}; values "
                + ", ".join(f"{n} ({v[0]:.9g}, {v[1]:.9g})" for n, v in vals.items())
                + f"; deciding gap {gap:.3g} (plain); the exactly summed field "
                  f"sides with the {'kernel' if agrees else 'plain version'}")
    n_off = int(((out[0] != ref[0]) | (out[2] != ref[2])).sum())
    summary = {"rays_differing": n_off, "share_equal": 1.0 - n_off / N_RAYS,
               "t_pick_differing": int((out[0] != ref[0]).sum()),
               "t_min_differing": int((out[2] != ref[2]).sum()),
               "largest_deciding_gap": max(gaps) if gaps else 0.0,
               "exact_sides_with_kernel": exact_with_kernel,
               "max_value_err_kernel_vs_plain": float((f_k - f_p).abs().max()),
               "kernel_repeatable": repeat_k, "plain_repeatable": repeat_p}
    return summary, lines


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=6)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sampler_picks needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the unseeded draw first, before anything else takes from the global
    # generator of this process
    for shape in EARLIER_DRAWS:
        torch.rand(*shape, device=dev)
    draws = [("the global generator's draw", torch.rand(N_STEPS, device=dev))]
    draws += [(f"seed {s}", torch.rand(
        N_STEPS, generator=torch.Generator(device=dev).manual_seed(s), device=dev))
        for s in range(args.seeds)]
    sdf, rays = case_inputs(dev)
    result = {}
    for name, steps in draws:
        summary, lines = differing_rays(sdf, rays, steps)
        print(f"{name}: {summary}")
        print("\n".join(lines))
        result[name] = summary
    print(json.dumps(result))


if __name__ == "__main__":
    main()
