"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels_cuda.py

The kNN, splat-selection and fine-stage kernels are held against their
plain versions on the same inputs: kNN distances, indices and masks equal
bit for bit (both form the distance with the same fused multiply-adds and
rank by (distance, index)), also on adversarial clouds (exact duplicates,
an integer lattice, masked points and queries, two clusters far apart, k
= 1, 8, 16 and, on a warp a query, 17, 24, 31 and 32, with and without
self-exclusion; two of them past
knn.SORT_MIN, on the Morton order with pruning); candidate SETS and
overflow counts equal (the kernel lists a tile's candidates in index
order, the plain version by depth), also at the splat frame's shape and on
a strip whose threshold ties straddle two blocks of its cluster (clusters
of 8 and 4, and the two-kernel arrangement); fragment maps, occupancy,
used flags and visibility identical, conic values within 1e-6, with and
without the fine kernel's early exit and per-warp cull, and on a permuted
candidate list (`used` and `slots` permuted to match).

Tolerances: MLP values atol 2e-5 and input gradients atol 1e-4 + rtol 1e-4
(3xTF32 tensor-core sums in the kernel against cuBLAS float32 in the twin;
ω = 30 sine layers amplify the round-off of the gradient), at hidden
widths 64, 128 and 256 and at launches of both tile sizes (32 and 128
rows), and at widths the wrapper pads to the next instance (48 to 64;
288, 300 and 320 to 384) and at 512 (the wide instances, on mlp_wide.cuh's
wgmma tile); a width above the widest instance is refused with a
ValueError and launches nothing; the fused MLP's and the IGR kernels'
libraries hold tensor-core instructions in their SASS (HMMA up to 256,
HGMMA and no HMMA in the `_wide` ones). Sampler: the picked
depths must be equal on all but 0.1% of rays (a pick flips only where two
proposal values tie within round-off), and on equal picks f_pick agrees to
1e-5 and the secant depth to 1e-4 on rays with a sign change.

Splat backward: the zbuf points kernel's tile sums against the one-hot
plain version within 1e-5 (the same terms in another order) and bit for
bit on a repeat; its point gradient within rtol 1e-5 of the plain version
and of its own tile sums scattered by `index_add_` (atomics add in another
order); padded slots (candidate 0, hit by no fragment) add nothing. The
occupancy kernels within 1e-5·max(1, max|g|) (the same pixel set and
per-pixel arithmetic, summed in another order), bit for bit on a repeat,
for one and for several clouds in one call (one C call), on signed sparse
cotangents and on the all-ones one (expanded, strides 0), also beside a
cloud with no visible point (zeros); the window kernel's renderable flags
and search radius bit-equal to `backward_window`'s (an odd and an even
count of radii, NaN radii, ties, an all-NaN cloud, none renderable, at W =
S and W < S); a patch too wide for the halo in shared memory and an image
wide enough to double the cell side; one occupancy C call per backward of
`rasterize_splats` at
B = 1, 2, 3; gradients through `rasterize_splats` with every kernel
against every plain version: xy as the occupancy kernels, z within 1e-5
relative.

IGR (fused_igr, the IGR sampler and the march, all three on mlp_mma.cuh's
tensor-core tile): the outputs the kernels gave before the tile took the
activation and the row groups as parameters and the f32 mode's sums were
repaired (`isopoints_torch.igr_reference`, saved in
tests/data/igr_reference.pt), bit for bit in the bf16 mode and within a
tenth of the f32 tolerances in the f32 mode; f32 (3xTF32) values atol 2e-5 and gradients
atol 1e-4 + rtol 1e-4 as for SIREN. bf16: kernel and plain version round
the same operands, so they differ only where a sum formed another way
lands on the other side of a bf16 rounding boundary: all within the
mode's own error (the plain bf16 version's largest difference from f32 on
the same points). Since fused_igr's tensor-core sums are not float32 sums
in the plain version's order, both are held to the mode with exactly
formed sums (`exact_sums`): the kernel within 1e-5 of it on 99% of values
and gradients, or on as many as the plain version. The IGR
sampler against the plain version: picks equal on 99.9% (fine) and 99%
(coarse: a bf16 value within round-off of −margin flips the pick) of the
rays; f_pick within 1e-5 on equal picks; the secant within 1e-4 on 99.9%
of the crossing rays and 1e-3 on all (it divides by value differences).
The march kernel against its plain version (`body_fused` over cuBLAS):
masks equal on 99.9% of rays, depths within 1e-5 on 99.9% after 3
iterations. Against the same functions over the fused IGR callables
(every point on the same tile, with the same per-row arithmetic), the
sampler and the march are exact: all outputs bit for bit, and the whole
bench schedule with the march equals the loop route.

SIREN on the same tile: the bf16 mode of fused_mlp held as IGR's bf16 mode
(within the mode's own error, and to the exactly summed bf16 mode on 99%
of values or as many as the plain version); the SIREN sampler (fine and
coarse, at the rays a block `rays_per_block` chooses for 65 to 24,576
rays: 8, 16, 32 and 64) and the SIREN march bit for bit against `sweep_plain` /
`march_plain` over the fused SIREN callables, and against the plain
versions at the IGR sampler's and march's tolerances; the uni ablation
arm's schedule with the march equal to the loop route.

The lossS arm: the kNN at its three saliency shapes (the statistics, the
hot-point lookup, the mothers), over an all-masked database and over one
of 5 valid points, bit for bit against the plain version; the reference
cloud's statistics (`update_ref_metric`) with the kernel and with the plain
kNN, bit for bit.

Evaluation and generation: the SIREN MLP on a 262,144-point chunk of a
256³ grid and a whole grid through `eval_sdf_grid` (two chunks, the last
padded) at the MLP tolerance; the kNN at the chamfer's shape (50,000 x
48,000, k=1, the Morton route) and an IMLS grid chunk's (262,144 x 5000,
k=8), bit for bit against the plain version.

The mesh ray-caster (csrc/raymesh.cu): t, faces, points and normals bit for
bit against `ray_mesh_intersect_plain` (the same roundings in the same
order) on 1, 2047 and 20,000 rays with duplicate faces, one launch a call;
float64, CPU and malformed face arrays refused.
"""

import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import knn_clouds
from isopoints_torch import igr_reference
from isopoints_torch.models.fields import SDFField, SirenField
from isopoints_torch.models.raytracing import (RayTracingConfig, march_plain,
                                               ray_trace)
from isopoints_torch.ops import _build, fused_mlp, fused_sampler, fused_trace, knn
from isopoints_torch.rendering import occ_bwd, select, splat
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  rasterize_splats)
from isopoints_torch.utils import fma, linspace01

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sdf(dev, hidden, n_layers, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    field = SirenField(hidden_size=hidden, n_layers=n_layers, generator=g,
                       device=dev)
    return field, fused_mlp.make_fused_siren_sdf(field)


def _rays(dev, n, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n, 3).contiguous()
    d = torch.randn(n, 3, generator=g, device=dev) * 0.3
    d[:, 2] = 1.0
    d = d / d.norm(dim=-1, keepdim=True)
    t_lo = 0.8 + 0.4 * torch.rand(n, generator=g, device=dev)
    t_hi = t_lo + 2.2 * torch.rand(n, generator=g, device=dev)
    return cam, d, t_lo, t_hi


@pytest.mark.parametrize("hidden,n_layers,n", [(64, 2, 1000), (128, 3, 4096),
                                               (256, 3, 4096), (256, 3, 5000),
                                               (256, 3, 40000), (96, 0, 77),
                                               (512, 3, 3000), (512, 3, 40000),
                                               (300, 2, 1000), (48, 2, 77)])
def test_fused_mlp_matches_twin(dev, hidden, n_layers, n):
    field, sdf = _sdf(dev, hidden, n_layers)
    x = torch.rand(n, 3, device=dev) * 2 - 1
    before = fused_mlp.KERNEL.launches
    v = sdf(x)
    v2, g = sdf.sdf_and_grad(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 2
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x)
    torch.testing.assert_close(v, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(v2, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(v, field.sdf(x), atol=2e-5, rtol=0)


@pytest.mark.parametrize("lib", ["fused_mlp", "fused_igr", "fused_sampler",
                                 "fused_trace", "fused_mlp_wide", "fused_igr_wide",
                                 "fused_sampler_wide", "fused_trace_wide"])
def test_tensor_core_instructions_in_sass(dev, lib):
    """The narrow instances on mlp_mma.cuh's `mma.sync` tile (HMMA), the wide
    ones on mlp_wide.cuh's `wgmma` tile (HGMMA, and no HMMA)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", _build.build_all()[lib]],
                          capture_output=True, text=True, check=True).stdout.splitlines()
    n_hgmma = sum("HGMMA" in line for line in sass)
    n_hmma = sum("HMMA" in line and "HGMMA" not in line for line in sass)
    if lib.endswith("_wide"):
        assert n_hgmma > 0 and n_hmma == 0
    else:
        assert n_hmma > 0


def test_fused_mlp_checks_inputs(dev):
    _, sdf = _sdf(dev, 64, 1)
    x = torch.rand(10, 3, device=dev)
    with pytest.raises(TypeError):
        sdf(x.double())
    with pytest.raises(ValueError):
        fused_mlp.siren_forward_cuda(sdf.pack, x[:, :2], False)
    with pytest.raises(ValueError):
        fused_mlp.siren_forward_cuda(sdf.pack, x.t(), False)
    # JAX's kernels take any width: 48 runs on the 64-wide instance, padded
    _, odd = _sdf(dev, 48, 1)
    before = fused_mlp.KERNEL.launches
    v, g = odd.sdf_and_grad(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 1
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(odd.pack, x)
    torch.testing.assert_close(v, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=1e-4)
    # above the widest instance: refused, nothing launched
    _, wide = _sdf(dev, fused_mlp.MAX_WIDTH + 32, 1)
    before = fused_mlp.KERNEL.launches
    with pytest.raises(ValueError, match=str(fused_mlp.MAX_WIDTH)):
        wide(x)
    assert fused_mlp.KERNEL.launches == before


@pytest.mark.parametrize("n_secant,random_steps", [(8, False), (0, True)])
def test_fused_sampler_matches_twin(dev, n_secant, random_steps):
    """t_min is the argmin of 100 values along the ray: where two steps'
    values tie within the kernel tile's rounding (differences of 1.9e-9 to
    4.1e-8 on 2-5 of 4096 rays a draw, the exactly summed field siding with
    either: `python -m isopoints_torch.sampler_picks`), the kernel and
    cuBLAS may take either step, and which rays do changes between
    processes. So a ray passes with equal picks, or with equal t_pick and a
    t_min whose plain value is within 2e-5 (the MLP's value tolerance) of
    the plain t_min's: a minimum within the field's error, as phase 7
    conditions the secant on the ray's slope. The steps come from a seeded
    generator."""
    _, sdf = _sdf(dev, 256, 3)
    cam, d, t_lo, t_hi = _rays(dev, 4096)
    g = torch.Generator(device=dev).manual_seed(0)
    steps = (torch.rand(100, generator=g, device=dev) if random_steps
             else linspace01(100, device=dev))
    before = fused_sampler.KERNEL.launches
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=n_secant)
    torch.cuda.synchronize()
    assert fused_sampler.KERNEL.launches == before + 1
    plain = lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p)
    ref = fused_sampler.sweep_plain(plain, cam, d, t_lo, t_hi, steps, n_secant)
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    f_min = lambda t: plain(fma(t[:, None], d, cam))
    tie = (out[0] == ref[0]) & ((f_min(out[2]) - f_min(ref[2])).abs() <= 2e-5)
    assert float((same | tie).float().mean()) >= 0.999
    torch.testing.assert_close(out[1][same], ref[1][same], atol=1e-5, rtol=0)
    hit = same & (ref[1] < 0)
    assert int(hit.sum()) > 100
    torch.testing.assert_close(out[3][hit], ref[3][hit], atol=1e-4, rtol=0)


def test_ray_trace_fused_matches_plain(dev):
    field, sdf = _sdf(dev, 256, 3)
    cam, d, _, _ = _rays(dev, 2048)
    cam, d = cam.reshape(2, 1024, 3), d.reshape(2, 1024, 3)
    obj = torch.rand(2, 1024, device=dev) > 0.4
    u = torch.rand(100, device=dev)
    with torch.no_grad():
        r_k = ray_trace(sdf, cam, d, obj, u,
                        RayTracingConfig(sampler_in_kernel=True))
        r_p = ray_trace(field.sdf, cam, d, obj, u, RayTracingConfig())
    agree = r_k.network_object_mask == r_p.network_object_mask
    assert float(agree.float().mean()) >= 0.998
    close = (r_k.dists - r_p.dists).abs() < 1e-4
    assert float(close.float().mean()) >= 0.99


def _sphere_cloud(dev, n, seed=0, frac=0.95):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(1, n, 3, generator=g, device=dev)
    v = v / v.norm(dim=-1, keepdim=True)
    mask = torch.rand(1, n, generator=g, device=dev) < frac
    return 0.5 * v, v, mask


@pytest.mark.parametrize("p,k", [(8000, 6), (3000, 8), (6000, 16)])
def test_knn_kernel_matches_plain(dev, p, k):
    pts, _, mask = _sphere_cloud(dev, p, seed=k)
    before = knn.KERNEL.launches
    a = knn.knn_points(pts, pts, mask, mask, k=k, exclude_self=True)
    torch.cuda.synchronize()
    assert knn.KERNEL.launches == before + 1
    b = knn.knn_points(pts, pts, mask, mask, k=k, exclude_self=True,
                       method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k", [1, 8, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("cloud", range(7))
def test_knn_kernel_adversarial_clouds(dev, cloud, k, exclude_self):
    """Exact duplicates, an integer lattice, masked points and queries, a
    masked cloud, two clusters far apart, and a lattice and masked points
    and queries of 20,480 points, past knn.SORT_MIN, where the kernel runs
    on the Morton order and prunes (chip_smoke.knn_clouds, B = 2)."""
    _, q, pts, qm, pm, is_self = knn_clouds(dev)[cloud]
    if exclude_self and not is_self:
        pytest.skip("self-exclusion needs query IS points")
    a = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=exclude_self)
    b = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=exclude_self,
                       method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)


def test_knn_kernel_masks_and_queries(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.rand(2, 700, 3, generator=g, device=dev) - 0.5
    pts = torch.rand(2, 3000, 3, generator=g, device=dev) - 0.5
    qm = torch.rand(2, 700, generator=g, device=dev) < 0.9
    pm = torch.rand(2, 3000, generator=g, device=dev) < 0.9
    a = knn.knn_points(q, pts, qm, pm, k=8)
    b = knn.knn_points(q, pts, qm, pm, k=8, method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)
    with pytest.raises(ValueError, match="k <= 32"):
        knn.knn_points(q, pts, k=33)


@pytest.mark.parametrize("k", [17, 24, 31, 32])
def test_knn_kernel_warp_group_rimls_shape(dev, k):
    """16 < k <= 32 (a warp a query) at the RIMLS losses' shape, (2, 5000)
    self-excluded, bit for bit against the plain version."""
    pts, _, mask = _sphere_cloud(dev, 5000, seed=k)
    pts = torch.stack([pts[0], pts[0].flip(0)])
    mask = torch.stack([mask[0], mask[0].flip(0)])
    before = knn.KERNEL.launches
    a = knn.knn_points(pts, pts, mask, mask, k=k, exclude_self=True)
    torch.cuda.synchronize()
    assert knn.KERNEL.launches == before + 1
    b = knn.knn_points(pts, pts, mask, mask, k=k, exclude_self=True,
                       method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)


def _splats(dev, P, seed, z_ties=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(1, P, generator=g, device=dev)
    z = u(0.5, 3.0)
    if z_ties:
        z = torch.round(z * 8.0) / 8.0
    valid = torch.rand(1, P, generator=g, device=dev) > 0.1
    return u(-1.1, 1.1), u(-1.1, 1.1), z, u(0.005, 0.1), u(0.005, 0.1), valid


def _sets(ci, ok):
    return [set(c[o].tolist()) for c, o in zip(ci.cpu(), ok.cpu())]


@pytest.mark.parametrize("P,S,R,M,z_ties", [(8000, 256, 2048, 256, False),
                                            (8000, 256, 512, 64, True),
                                            (640, 64, 2048, 128, True),
                                            (24_576, 512, 1280, 256, False),
                                            (3000, 256, 3000, 256, False)])
def test_select_kernel_matches_plain(dev, P, S, R, M, z_ties):
    args = _splats(dev, P, seed=P + M, z_ties=z_ties)
    before = select.KERNEL.launches
    ci, ok, ovf = select.select_candidates(*args, S, 16, R, M)
    torch.cuda.synchronize()
    assert select.KERNEL.launches == before + 1
    ci_p, ok_p, ovf_p = select.select_candidates_plain(*args, S, 16, R, M)
    assert torch.equal(ovf, ovf_p)
    assert _sets(ci[0], ok[0]) == _sets(ci_p[0], ok_p[0])


def test_select_kernel_threshold_ties_in_two_ranks(dev):
    """A strip past R whose threshold ties straddle the first two blocks'
    parts of the splats (the cluster's 8 blocks split P in contiguous
    parts): every splat overlaps every strip, 20 splats at depth 1.0 (each
    over every tile) around the parts' boundary, R - 13 strictly in front.
    The plain version's sets and overflow, the strip's first 13 ties among
    them."""
    P, S, R, M = 8000, 256, 512, 512
    g = torch.Generator(device=dev).manual_seed(8)
    chunk = -(-P // 8)
    ties = torch.arange(chunk - 10, chunk + 10, device=dev)
    rest = torch.ones(P, dtype=torch.bool, device=dev)
    rest[ties] = False
    rest = rest.nonzero()[:, 0]
    front = rest[torch.randperm(len(rest), generator=g, device=dev)[:R - 13]]
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(1, P, generator=g, device=dev)
    z = u(1.01, 3.0)
    z[0, front] = u(0.5, 0.99)[0, :R - 13]
    z[0, ties] = 1.0
    px, rx = u(-1.0, 1.0), u(0.02, 0.2)
    px[0, ties], rx[0, ties] = 0.0, 2.0
    py, ry = torch.zeros(1, P, device=dev), torch.full((1, P), 2.0, device=dev)
    valid = torch.ones(1, P, dtype=torch.bool, device=dev)
    args = (px, py, z, rx, ry, valid, S, 16, R, M)
    ci, ok, ovf = select.select_candidates_cuda(*args)
    torch.cuda.synchronize()
    ci_p, ok_p, ovf_p = select.select_candidates_plain(*args)
    assert torch.equal(ovf, ovf_p) and int(ovf) >= 16 * (P - R)
    assert _sets(ci[0], ok[0]) == _sets(ci_p[0], ok_p[0])
    first = set(ci[0, 0][ok[0, 0]].tolist())
    assert set(ties[:13].tolist()) <= first and not set(ties[13:].tolist()) & first
    # a tile's list in index order, then the padding
    assert bool(((ci[..., 1:] > ci[..., :-1]) | ~ok[..., 1:]).all())
    assert bool((ci[~ok] == 0).all())


def _fine_inputs(dev):
    """The selection's candidates and the per-splat table of an 8000-point
    sphere cloud in two views at 256 px, and the splat parameters."""
    pts, normals, mask = _sphere_cloud(dev, 8000, seed=3)
    from isopoints_torch.core.camera import (PerspectiveCamera,
                                             look_at_view_transform)
    from isopoints_torch.rendering.rasterizer import (compute_splat_params,
                                                      stage_inputs)
    R, T = look_at_view_transform(2.0, [10.0, -30.0], [20.0, 150.0], device=dev)
    cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
    kern = RasterizationSettings(image_size=256, use_pallas=True)
    sp = compute_splat_params(pts.expand(2, -1, -1), normals.expand(2, -1, -1),
                              mask.expand(2, -1), cam, kern)
    sel, table = stage_inputs(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff,
                              sp.mask, kern)
    ci, ok, _ = select.select_candidates_plain(*sel)
    return sp, table, ci, ok


def test_fine_kernel_and_rasterizer_match_plain(dev):
    sp, table, ci, ok = _fine_inputs(dev)
    kern = RasterizationSettings(image_size=256, use_pallas=True)
    plain = RasterizationSettings(image_size=256, use_pallas=False)
    args = (sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask)
    before = (select.KERNEL.launches, splat.KERNEL.launches)
    a = rasterize_splats(*args, kern)
    torch.cuda.synchronize()
    assert (select.KERNEL.launches, splat.KERNEL.launches) == (before[0] + 1,
                                                               before[1] + 1)
    b = rasterize_splats(*args, plain)
    for name in ("idx", "occupancy", "visibility", "tile_overflow"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    torch.testing.assert_close(a.zbuf, b.zbuf, atol=0, rtol=0)
    torch.testing.assert_close(a.qvalue, b.qvalue, atol=1e-6, rtol=0)
    assert int(a.visibility.sum()) > 2000
    # the fine kernel alone on the plain selection's candidates
    fp = splat.rasterize_fine_plain(table, ci, ok, 256, 16, 5, 0.05)
    fk = splat.rasterize_fine_cuda(table, ci, ok, 256, 16, 5, 0.05)
    for name in ("idx", "zbuf", "occ", "used", "slots"):
        assert torch.equal(getattr(fk, name), getattr(fp, name)), name
    torch.testing.assert_close(fk.qvalue, fp.qvalue, atol=1e-6, rtol=0)


def test_fine_kernel_on_permuted_list(dev):
    """Each tile's candidate list permuted: the kernel's maps equal the
    plain version's on the original list, with `used` and `slots` permuted
    to match."""
    _, table, ci, ok = _fine_inputs(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    perm = torch.argsort(torch.rand(ci.shape, generator=g, device=dev), dim=-1)
    inv = torch.argsort(perm, dim=-1)
    fk = splat.rasterize_fine(table, torch.gather(ci, 2, perm),
                              torch.gather(ok, 2, perm), 256, 16, 5, 0.05)
    fp = splat.rasterize_fine_plain(table, ci, ok, 256, 16, 5, 0.05)
    for name in ("idx", "zbuf", "occ"):
        assert torch.equal(getattr(fk, name), getattr(fp, name)), name
    torch.testing.assert_close(fk.qvalue, fp.qvalue, atol=1e-6, rtol=0)
    assert torch.equal(fk.used, torch.gather(fp.used, 2, perm))
    b, n_t = ci.shape[:2]
    moved = torch.gather(inv, 2, fp.slots.long().clamp(min=0).reshape(b, n_t, -1)
                         ).reshape(fp.slots.shape)
    assert torch.equal(fk.slots, torch.where(fp.slots >= 0, moved, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# Splat backward: the zbuf tile reduction and the occupancy backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nt,T,K,M,P", [(8, 16, 5, 256, 3000),
                                         (6, 8, 3, 100, 500),
                                         (4, 16, 8, 1000, 5000)])
def test_zbuf_points_kernel_matches_plain(dev, nt, T, K, M, P):
    g = torch.Generator(device=dev).manual_seed(nt * M)
    b, S = 2, nt * T
    slots = torch.randint(-1, M, (b, nt * nt, T * T, K), generator=g,
                          device=dev, dtype=torch.int32)
    slots[0, 0] = -1                                 # an empty tile
    gz = torch.randn(b, S, S, K, generator=g, device=dev)
    cand = torch.randint(0, P, (b, nt * nt, M), generator=g, device=dev)
    before = splat.ZBUF_KERNEL.launches
    pa, ta = splat.zbuf_backward_points_cuda(slots, gz, cand, P, tile_sums=True)
    pb, tb = splat.zbuf_backward_points_cuda(slots, gz, cand, P, tile_sums=True)
    pc = splat.zbuf_backward_points(slots, gz, cand, P)
    torch.cuda.synchronize()
    assert splat.ZBUF_KERNEL.launches == before + 3
    assert torch.equal(ta, tb)
    assert torch.equal(ta[0], torch.zeros_like(ta[0]))
    tiles = splat.to_tiles(gz, T)
    torch.testing.assert_close(
        ta, splat.zbuf_backward_tile_plain(slots.reshape(-1, T * T, K), tiles, M),
        atol=1e-5, rtol=0)
    offs = torch.arange(b, device=dev)[:, None, None] * P
    scattered = torch.zeros(b * P, device=dev).index_add_(
        0, (cand + offs).reshape(-1), ta.reshape(-1)).reshape(b, P)
    ref = splat.zbuf_backward_points_plain(slots, gz, cand, P)
    for got in (pa, pb, pc):
        torch.testing.assert_close(got, scattered, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_zbuf_points_kernel_padded_slots(dev):
    """Slots the selection pads with candidate 0 and no fragment hits add
    nothing: point 0's gradient is the sum of its own fragments."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, nt, T, K, M, P = 2, 32, 16, 5, 256, 24576
    cand = torch.zeros((b, nt * nt, M), dtype=torch.int64, device=dev)
    cand[..., :8] = torch.randint(1, P, (b, nt * nt, 8), generator=g, device=dev)
    cand[:, ::2, 0] = 0                               # point 0 for real
    slots = torch.randint(-1, 8, (b, nt * nt, T * T, K), generator=g,
                          device=dev, dtype=torch.int32)
    gz = torch.randn(b, nt * T, nt * T, K, generator=g, device=dev)
    got = splat.zbuf_backward_points(slots, gz, cand, P)
    pid = torch.where(slots >= 0, torch.gather(
        cand, 2, slots.clamp(min=0).reshape(b, nt * nt, -1).long()
    ).reshape(slots.shape), P)
    tiles = splat.to_tiles(gz, T).reshape(slots.shape)
    want = torch.zeros((b, P + 1), dtype=torch.float64, device=dev).scatter_add_(
        1, pid.reshape(b, -1), tiles.reshape(b, -1).double())[:, :P]
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)
    assert float(want[:, 0].abs().min()) > 1.0


def _occ_case(dev, n, S, seed, edge=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(n, 3, generator=g, device=dev)
    v = 0.7 * v / v.norm(dim=-1, keepdim=True)
    if edge:
        v[: n // 3, 0] = 0.98
    pts = torch.stack([v[:, 0], v[:, 1], 2.5 + v[:, 2]], -1)
    radii = torch.randn(n, 2, generator=g, device=dev).abs() * 0.02 + 0.01
    vis = torch.rand(n, generator=g, device=dev) < 0.85
    grad = torch.randn(S, S, generator=g, device=dev) * (
        torch.rand(S, S, generator=g, device=dev) < 0.3)
    return pts, radii, vis, grad


@pytest.mark.parametrize("n,S,edge", [(600, 128, False), (600, 128, True),
                                      (200, 64, False), (24576, 512, False)])
def test_occ_bwd_kernel_matches_plain(dev, n, S, edge):
    case = _occ_case(dev, n, S, seed=n + S, edge=edge)
    st = RasterizationSettings(image_size=S)
    before = occ_bwd.KERNEL.launches
    a = occ_bwd.occ_backward_one(*case, st)
    b = occ_bwd.occ_backward_one(*case, st)
    torch.cuda.synchronize()
    assert occ_bwd.KERNEL.launches == before + 2
    assert torch.equal(a, b)
    ref = occ_bwd.occ_backward_one_plain(*case, st)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(a, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))
    none = occ_bwd.occ_backward_one(case[0], case[1], torch.zeros_like(case[2]),
                                    case[3], st)
    assert torch.equal(none, torch.zeros_like(none))


def _occ_batch(dev, B, n, S, seed, cotangent, edge=False):
    """B clouds of `_occ_case`'s kind (cloud i from seed + i) with a signed
    sparse cotangent or the all-ones one (the splat frame's: positive
    everywhere, an expanded tensor whose strides are 0)."""
    cases = [_occ_case(dev, n, S, seed + i, edge) for i in range(B)]
    pts, radii, vis, grad = (torch.stack(a) for a in zip(*cases))
    if cotangent == "ones":
        grad = torch.ones((1, 1, 1), device=dev).expand(B, S, S)
    return pts, radii, vis, grad


@pytest.mark.parametrize("cotangent", ["signed", "ones"])
@pytest.mark.parametrize("B,n,S,edge", [(1, 600, 128, False), (2, 600, 128, True),
                                        (2, 200, 64, False), (1, 24576, 512, False),
                                        (2, 5000, 256, False)])
def test_occ_bwd_batched_kernel_matches_plain(dev, B, n, S, edge, cotangent):
    """The batched kernels against the plain version; twice bit-identical;
    one C call for the B clouds."""
    case = _occ_batch(dev, B, n, S, seed=n + S, cotangent=cotangent, edge=edge)
    st = RasterizationSettings(image_size=S)
    before = occ_bwd.KERNEL.launches
    a = occ_bwd.occ_backward(*case, st)
    b = occ_bwd.occ_backward(*case, st)
    torch.cuda.synchronize()
    assert occ_bwd.KERNEL.launches == before + 2
    assert torch.equal(a, b)
    ref = occ_bwd.occ_backward_plain(*case, st)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(a, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))


def test_occ_bwd_kernel_all_invisible_cloud(dev):
    """A cloud with no visible point beside one with: zeros for it, the
    other's gradient unchanged."""
    pts, radii, vis, grad = _occ_batch(dev, 2, 600, 128, seed=9, cotangent="signed")
    vis[1] = False
    st = RasterizationSettings(image_size=128)
    got = occ_bwd.occ_backward(pts, radii, vis, grad, st)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got[0], occ_bwd.occ_backward(pts[:1], radii[:1], vis[:1],
                                                    grad[:1], st)[0])


@pytest.mark.parametrize("S", [64, 128])           # W = S, and W < S
def test_occ_bwd_window_matches_backward_window(dev, S):
    """The window kernel's renderable flags and search_r² bit-equal to
    backward_window's: an even and an odd count of radii, a renderable
    point with a NaN radius, ties, an all-NaN cloud and one without a
    renderable point."""
    pts, radii, vis, grad = _occ_batch(dev, 6, 300, S, seed=4, cotangent="signed")
    radii[1, 7, 0] = float("nan")                 # an odd count
    radii[2, 3] = float("nan")                    # both radii of a point
    radii[3] = torch.round(radii[3] * 100) / 100  # ties
    radii[4] = float("nan")                       # all NaN
    vis[5] = False                                # none renderable
    pts[0, :5, 2] = -1.0                          # behind the camera
    st = RasterizationSettings(image_size=S)
    _, scratch = occ_bwd.launch(pts, radii, vis, grad, st)
    ren, sr2, ids = occ_bwd.window_of(scratch, pts.shape[1])
    for i in range(6):
        r, s2, _ = occ_bwd.backward_window(pts[i], radii[i], vis[i], st)
        assert torch.equal(ren[i], r), i
        assert int(sr2[i:i + 1].view(torch.int32)) == int(s2.reshape(1).view(torch.int32)), \
            (i, float(sr2[i]), float(s2))
        assert len(set(ids[i].tolist())) == len(ids[i])


@pytest.mark.parametrize("n,S,W", [(600, 512, 256), (2000, 3072, 64)])
def test_occ_bwd_no_halo_and_doubled_cells(dev, n, S, W):
    """The launch's two rarer branches: a patch whose halo does not fit in
    shared memory (W = 256 at 512 px: the walk reads device memory and
    visits every window row) and an image wide enough to double the cell
    side past kMaxCells cells (3072 px, W = 64: 64-px cells). Against the
    plain version, twice bit-identical, the flags and search radius
    bit-equal to backward_window's, the walk order bucketed by cell."""
    cs = 32
    while ((S - W) // cs + 1) ** 2 > 8192:      # csrc/occ_bwd.cu kMaxCells
        cs *= 2
    hs = min(cs + W - 1, S)
    if W == 256:
        assert (hs * hs + hs) * 4 > 232448       # past an H100 block's opt-in smem
    else:
        assert cs == 64
    pts, radii, vis, grad = _occ_case(dev, n, S, seed=n + S)
    st = RasterizationSettings(image_size=S, backward_patch_pixels=W)
    args = (pts[None], radii[None], vis[None], grad[None], st)
    before = occ_bwd.KERNEL.launches
    a, scratch = occ_bwd.launch(*args)
    b = occ_bwd.occ_backward(*args)
    torch.cuda.synchronize()
    assert occ_bwd.KERNEL.launches == before + 2
    assert torch.equal(a, b)
    ren, sr2, ids = occ_bwd.window_of(scratch, n)
    r, s2, w = occ_bwd.backward_window(pts, radii, vis, st)
    assert w == W and torch.equal(ren[0], r)
    assert int(sr2[:1].view(torch.int32)) == int(s2.reshape(1).view(torch.int32))
    nca = (S - W) // cs + 1
    c0 = occ_bwd._patch_origin(pts[ids[0], 0], S, W)
    r0 = occ_bwd._patch_origin(pts[ids[0], 1], S, W)
    cell = (r0 // cs) * nca + c0 // cs
    assert bool((cell[1:] >= cell[:-1]).all())
    ref = occ_bwd.occ_backward_plain(*args)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(a, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))


def test_occ_bwd_one_call_per_backward(dev):
    """rasterize_splats' backward makes one occupancy C call whatever B is."""
    pts, normals, mask = _sphere_cloud(dev, 3000, seed=5)
    from isopoints_torch.core.camera import (PerspectiveCamera,
                                             look_at_view_transform)
    from isopoints_torch.rendering.rasterizer import compute_splat_params
    st = RasterizationSettings(image_size=256, use_pallas=True)
    for B in (1, 2, 3):
        R, T = look_at_view_transform(2.0, [10.0, -30.0, 40.0][:B],
                                      [20.0, 150.0, 270.0][:B], device=dev)
        cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
        sp = compute_splat_params(pts.expand(B, -1, -1), normals.expand(B, -1, -1),
                                  mask.expand(B, -1), cam, st)
        p = sp.pts_ndc.detach().clone().requires_grad_(True)
        fr = rasterize_splats(p, sp.ellipse, sp.radii, sp.cutoff, sp.mask, st)
        before = occ_bwd.KERNEL.launches
        torch.autograd.grad(fr.occupancy.sum(), p)
        assert occ_bwd.KERNEL.launches - before == 1, B


def test_rasterize_backward_kernels_match_plain(dev):
    pts, normals, mask = _sphere_cloud(dev, 8000, seed=3)
    from isopoints_torch.core.camera import (PerspectiveCamera,
                                             look_at_view_transform)
    from isopoints_torch.rendering.rasterizer import compute_splat_params
    R, T = look_at_view_transform(2.0, [10.0, -30.0], [20.0, 150.0], device=dev)
    cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
    kern = RasterizationSettings(image_size=256, use_pallas=True)
    plain = RasterizationSettings(image_size=256, use_pallas=False,
                                  use_pallas_backward=False)
    sp = compute_splat_params(pts.expand(2, -1, -1), normals.expand(2, -1, -1),
                              mask.expand(2, -1), cam, kern)
    grads = []
    for st in (kern, plain):
        p = sp.pts_ndc.detach().clone().requires_grad_(True)
        before = (splat.ZBUF_KERNEL.launches, occ_bwd.KERNEL.launches)
        fr = rasterize_splats(p, sp.ellipse, sp.radii, sp.cutoff, sp.mask, st)
        loss = fr.occupancy.sum() + torch.where(fr.zbuf > 0, fr.zbuf, 0.0).sum()
        (g,) = torch.autograd.grad(loss, p)
        torch.cuda.synchronize()
        launched = (splat.ZBUF_KERNEL.launches - before[0],
                    occ_bwd.KERNEL.launches - before[1])
        assert launched == ((1, 1) if st is kern else (0, 0))
        grads.append(g)
    a, b = grads
    assert float(b[..., :2].abs().max()) > 0 and float(b[..., 2].abs().max()) > 0
    torch.testing.assert_close(a[..., :2], b[..., :2], rtol=0,
                               atol=1e-5 * max(1.0, float(b[..., :2].abs().max())))
    torch.testing.assert_close(a[..., 2], b[..., 2], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# IGR: the fused MLP, the IGR sampler (fine and coarse) and the march
# ---------------------------------------------------------------------------

def _igr(dev, hidden=256, n_layers=4, seed=0, **kw):
    g = torch.Generator(device=dev).manual_seed(seed)
    field = SDFField(hidden_size=hidden, n_layers=n_layers, num_frequencies=0,
                     generator=g, device=dev, **kw)
    return field, fused_mlp.make_fused_igr_sdf(field)


def _close_frac(a, b, atol):
    return float(((a - b).abs() <= atol).float().mean())


@pytest.mark.parametrize("hidden,n_layers,skip,n", [(256, 4, (4,), 5000),
                                                    (256, 4, (2,), 131),
                                                    (128, 4, (2,), 1000),
                                                    (128, 3, (3,), 129),
                                                    (64, 4, (2,), 1000),
                                                    (32, 3, (3,), 77),
                                                    (32, 2, (), 33),
                                                    (96, 1, (), 77),
                                                    (512, 8, (4,), 5000),
                                                    (512, 4, (2,), 131),
                                                    (384, 4, (4,), 1000),
                                                    (320, 5, (4,), 1000),
                                                    (300, 4, (2,), 777),
                                                    (288, 3, (3,), 129),
                                                    (48, 4, (2,), 77)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_igr_matches_plain(dev, hidden, n_layers, skip, n, bf16):
    field, _ = _igr(dev, hidden, n_layers, skip_in=skip)
    sdf = fused_mlp.make_fused_igr_sdf(field, "bf16" if bf16 else "f32")
    x = torch.rand(n, 3, device=dev) * 2 - 1
    before = fused_mlp.IGR_KERNEL.launches
    v = sdf(x)
    v2, g = sdf.sdf_and_grad(x)
    torch.cuda.synchronize()
    assert fused_mlp.IGR_KERNEL.launches == before + 2
    v_ref, g_ref = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, x, bf16)
    torch.testing.assert_close(v, v2, atol=0, rtol=0)
    if not bf16:
        torch.testing.assert_close(v, v_ref, atol=2e-5, rtol=0)
        torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=1e-4)
        with torch.no_grad():
            torch.testing.assert_close(v, field.sdf(x), atol=2e-5, rtol=0)
    else:
        # the mode's own error: the plain bf16 version against f32
        own = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, x)
        for a, b, c in zip((v, g), (v_ref, g_ref), own):
            assert float((a - b).abs().max()) <= float((b - c).abs().max())
        # the exactly summed bf16 mode, to which the kernel is at least as
        # close as the plain version or within 1e-5 on 99%: a share, so on
        # 8192 seeded points (one of n = 131 points moves it by 0.8%)
        gen = torch.Generator(device=dev).manual_seed(n)
        xs = torch.rand(8192, 3, generator=gen, device=dev) * 2 - 1
        plain = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, xs, True)
        exact = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, xs, True, True)
        for a, b, e in zip(sdf.sdf_and_grad(xs), plain, exact):
            assert _close_frac(a, e, 1e-5) >= min(0.99, _close_frac(b, e, 1e-5))


def _igr_rays(dev, n, seed=1):
    cam, d, t_lo, t_hi = _rays(dev, n, seed)
    return cam, d, t_lo * 0.6, t_hi * 0.9


@pytest.mark.parametrize("hidden,n_layers", [(256, 4), (512, 8)])
@pytest.mark.parametrize("coarse", [False, True])
def test_fused_sampler_igr_matches_plain(dev, coarse, hidden, n_layers):
    """At 512 wide the coarse picks are held to the sweep with exactly
    formed sums, as chip_smoke.py's phase 20 holds them: the kernel's
    equal to its picks on 99% of rays or as many as the plain version's
    (a bf16 sum in another order flips a bf16 rounding on ~10% of the
    values there, and a pick with it where a step lies that close to
    -margin)."""
    field, sdf = _igr(dev, hidden, n_layers)
    cam, d, t_lo, t_hi = _igr_rays(dev, 4096)
    steps = linspace01(100, device=dev)
    margin = 2e-3 if coarse else 0.0
    before = fused_sampler.KERNEL.launches
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=8,
                                margin=margin, coarse_sweep=coarse)
    torch.cuda.synchronize()
    assert fused_sampler.KERNEL.launches == before + 1
    plain = lambda p: fused_mlp.igr_sdf_plain(sdf.pack, p)
    plain_c = lambda p: fused_mlp.igr_sdf_plain(sdf.pack, p, True)
    ref = fused_sampler.sweep_plain(plain, cam, d, t_lo, t_hi, steps, 8, margin,
                                    sdf_fn_coarse=plain_c if coarse else None)
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    if hidden <= 256 or not coarse:
        assert float(same.float().mean()) >= (0.99 if coarse else 0.999)
    else:
        ref_x = fused_sampler.sweep_plain(
            lambda p: fused_mlp.igr_sdf_plain(sdf.pack, p, False, True), cam, d,
            t_lo, t_hi, steps, 8, margin, chunk_rays=1024,
            sdf_fn_coarse=lambda p: fused_mlp.igr_sdf_plain(sdf.pack, p, True, True))
        share = lambda o: float(((o[0] == ref_x[0]) & (o[2] == ref_x[2])).float().mean())
        assert share(out) >= min(0.99, share(ref))
    torch.testing.assert_close(out[1][same], ref[1][same], atol=1e-5, rtol=0)
    hit = same & (ref[1] < 0)
    assert int(hit.sum()) > 100
    assert _close_frac(out[3][hit], ref[3][hit], 1e-4) >= 0.999
    assert float((out[3][hit] - ref[3][hit]).abs().max()) <= 1e-3


@pytest.mark.parametrize("hidden,n_layers,skip,n,n_steps", [
    (256, 4, (4,), 4096, 100),    # the bench field at the trace's shape
    (256, 4, (4,), 4099, 37),     # a ragged last block and tile
    (96, 3, (2,), 777, 1000),     # past the old proposal-buffer limit
    (32, 2, (), 65, 5),
    (512, 8, (4,), 4096, 100),    # the published IGR network: 16 rays a block
    (512, 8, (4,), 4099, 37),     # a ragged last block and tile at 32 rows
    (300, 4, (2,), 777, 100),     # padded to the 384-wide instance
    (48, 3, (2,), 65, 5)])        # padded to 64
@pytest.mark.parametrize("coarse", [False, True])
def test_fused_sampler_igr_equals_sweep_plain_over_fused(dev, hidden, n_layers,
                                                         skip, n, n_steps,
                                                         coarse):
    """The IGR sampler evaluates every point on fused_igr's tile: all four
    outputs equal `sweep_plain` over the fused callables bit for bit."""
    field, sdf = _igr(dev, hidden, n_layers, skip_in=skip)
    fn_c = fused_mlp.make_fused_igr_sdf(field, "bf16") if coarse else None
    cam, d, t_lo, t_hi = _igr_rays(dev, n)
    steps = linspace01(n_steps, device=dev)
    margin = 2e-3 if coarse else 0.0
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=8,
                                margin=margin, coarse_sweep=coarse)
    ref = fused_sampler.sweep_plain(sdf, cam, d, t_lo, t_hi, steps, 8, margin,
                                    sdf_fn_coarse=fn_c)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int((ref[1] < 0).sum()) > 0


def _march_state(dev, sdf, n):
    """A compacted stage's state: a few plain fused-backstep iterations
    from the sphere entry of the bench's rays."""
    cam, d, _, _ = _rays(dev, n, seed=4)
    t0 = torch.full((n,), 1.0, device=dev)
    t1 = torch.full((n,), 3.0, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    on = torch.ones(n, dtype=torch.bool, device=dev)
    st = (t0, t1, sdf(cam + t0[:, None] * d), sdf(cam + t1[:, None] * d),
          on, on, zi, zi, torch.zeros_like(t0), torch.zeros_like(t0))
    return cam, d, march_plain(sdf, cam, d, st, 2, 5e-5, 0.5, 1, True)


def test_trace_march_matches_plain(dev):
    _, sdf = _igr(dev)
    cam, d, st = _march_state(dev, sdf, 8192)
    before = fused_trace.KERNEL.launches
    out = sdf.fused_trace_stepper(cam, d, st, 3, 5e-5, 0.5, 1, True)
    torch.cuda.synchronize()
    assert fused_trace.KERNEL.launches == before + 1
    ref = march_plain(lambda p: fused_mlp.igr_sdf_plain(sdf.pack, p), cam, d,
                      st, 3, 5e-5, 0.5, 1, True)
    for i in (4, 5, 6, 7):
        assert float((out[i] == ref[i]).float().mean()) >= 0.999
    for i in (0, 1):
        assert _close_frac(out[i], ref[i], 1e-5) >= 0.999
    # the same iterations over the fused IGR kernel: the same tile, so
    # every state array bit for bit
    loop = march_plain(sdf, cam, d, st, 3, 5e-5, 0.5, 1, True)
    for a, b in zip(out, loop):
        assert torch.equal(a, b)


def test_ray_trace_igr_schedule_kernels(dev):
    """The bench schedule on the kernels: trace_in_kernel equals the loop
    over the fused kernel (both on the tensor-core tile), and the loop
    agrees with every plain version (two f32 arithmetics over 21
    iterations)."""
    field, sdf = _igr(dev)
    coarse = fused_mlp.make_fused_igr_sdf(field, "bf16")
    cam, d, _, _ = _rays(dev, 4096)
    cam, d = cam.reshape(1, -1, 3), d.reshape(1, -1, 3)
    gt = torch.ones(d.shape[:2], dtype=torch.bool, device=dev)
    cfg = RayTracingConfig(
        sphere_tracing_iters=21, sampler_fraction=0.5,
        trace_compact_after=(6, 9, 13, 17),
        trace_compact_fraction=(0.65, 0.42, 0.21, 0.14), coarse_trace_iters=6,
        sampler_coarse=True, sampler_coarse_margin=2e-3,
        coarse_stall_on_cross=True, fused_backstep=True,
        trace_gate_end_front=True, sampler_in_kernel=True)
    with torch.no_grad():
        a = ray_trace(sdf, cam, d, gt, None, cfg, training=False,
                      sdf_fn_coarse=coarse)
        before = fused_trace.KERNEL.launches
        b = ray_trace(sdf, cam, d, gt, None,
                      dataclasses.replace(cfg, trace_in_kernel=True),
                      training=False, sdf_fn_coarse=coarse)
        assert fused_trace.KERNEL.launches > before
        p = ray_trace(lambda x: fused_mlp.igr_sdf_plain(sdf.pack, x), cam, d,
                      gt, None, cfg, training=False,
                      sdf_fn_coarse=lambda x: fused_mlp.igr_sdf_plain(
                          sdf.pack, x, True))
    assert torch.equal(a.network_object_mask, b.network_object_mask)
    assert torch.equal(a.sampler_mask, b.sampler_mask)
    assert torch.equal(a.dists, b.dists)
    agree = a.network_object_mask == p.network_object_mask
    assert float(agree.float().mean()) >= 0.99
    assert _close_frac(a.dists, p.dists, 1e-4) >= 0.98


@pytest.mark.parametrize("coarse", [False, True])
def test_presweep_route_kernels_match_plain(dev, coarse):
    """The certify-then-sweep sampler on the kernels: the presweep grid on
    fused_igr (chunked), the compacted dense pass in the sampler kernel.
    Bit for bit the route with the sampler's plain sweep over the fused
    callable (the sampler kernel equals sweep_plain over it), and within
    the trace bars of every plain version."""
    field, sdf = _igr(dev)
    fn_c = fused_mlp.make_fused_igr_sdf(field, "bf16") if coarse else None
    cam, d, _, _ = _rays(dev, 4096)
    cam, d = cam.reshape(1, -1, 3), d.reshape(1, -1, 3)
    gt = torch.ones(d.shape[:2], dtype=torch.bool, device=dev)
    cfg = RayTracingConfig(sphere_tracing_iters=6, sampler_presweep=26,
                           sampler_dense_fraction=0.9, sampler_chunk_rays=1024,
                           sampler_coarse=coarse,
                           sampler_coarse_margin=2e-3 if coarse else 0.0,
                           sampler_in_kernel=True)
    with torch.no_grad():
        igr0, smp0 = fused_mlp.IGR_KERNEL.launches, fused_sampler.KERNEL.launches
        a = ray_trace(sdf, cam, d, gt, None, cfg, training=False,
                      sdf_fn_coarse=fn_c)
        assert fused_mlp.IGR_KERNEL.launches > igr0
        assert fused_sampler.KERNEL.launches == smp0 + 1
        b = ray_trace(sdf, cam, d, gt, None,
                      dataclasses.replace(cfg, sampler_in_kernel=False),
                      training=False, sdf_fn_coarse=fn_c)
        p = ray_trace(lambda x: fused_mlp.igr_sdf_plain(sdf.pack, x), cam, d,
                      gt, None, cfg, training=False,
                      sdf_fn_coarse=(lambda x: fused_mlp.igr_sdf_plain(
                          sdf.pack, x, True)) if coarse else None)
    assert int(a.sampler_overflow) == 0 and int(a.sampler_mask.sum()) > 0
    assert torch.equal(a.network_object_mask, b.network_object_mask)
    assert torch.equal(a.dists, b.dists)
    agree = a.network_object_mask == p.network_object_mask
    assert float(agree.float().mean()) >= 0.99
    assert _close_frac(a.dists, p.dists, 1e-4) >= 0.98


def _igr_reference(dev):
    """The outputs saved from the IGR kernels before the tile took the
    activation and the row groups as parameters and the f32 mode's sums
    were repaired, and this build's on the same inputs."""
    ref = torch.load(os.path.join(os.path.dirname(__file__), "data",
                                  "igr_reference.pt"), weights_only=True)
    got = igr_reference.outputs(dev)
    assert sorted(got) == sorted(ref)
    return got, ref


def test_igr_bf16_kernels_equal_the_saved_reference(dev):
    """fused_igr's bf16 mode (value and value+grad) and the bench trace in
    bf16 with the sampler and with the march: bit for bit."""
    got, ref = _igr_reference(dev)
    for name in (n for n in got if n.startswith("bf16")):
        assert torch.equal(got[name], ref[name]), name


def test_igr_f32_kernels_near_the_saved_reference(dev):
    """The f32 mode's sums changed (each k8 step's hi·hi and the correction
    products in tiles of their own): values within a tenth of the f32
    tolerance, gradients within 1e-5·max(1, |g|), and the trace's masks
    and depths as the plain route's tolerances of chip_smoke.py allow."""
    got, ref = _igr_reference(dev)
    for name in ("f32 value", "f32 value+grad: value"):
        torch.testing.assert_close(got[name], ref[name], atol=2e-6, rtol=0)
    g = ref["f32 value+grad: grad"]
    torch.testing.assert_close(got["f32 value+grad: grad"], g, rtol=0,
                               atol=1e-5 * max(1.0, float(g.abs().max())))
    for route in ("sampler", "march"):
        key = f"f32 trace ({route}): "
        hit = got[key + "network_object_mask"] == ref[key + "network_object_mask"]
        assert float(hit.float().mean()) >= 0.995
        near = (got[key + "dists"] - ref[key + "dists"]).abs() <= 1e-4
        assert float(near[hit].float().mean()) >= 0.99


# ---------------------------------------------------------------------------
# SIREN: the bf16 mode, the sampler (fine and coarse) and the march
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,n_layers,n", [(256, 3, 4096), (256, 3, 40000),
                                               (128, 2, 1000), (64, 1, 77),
                                               (512, 3, 4096), (512, 3, 40000),
                                               (300, 2, 1000)])
def test_fused_mlp_bf16_matches_plain(dev, hidden, n_layers, n):
    field, _ = _sdf(dev, hidden, n_layers)
    sdf = fused_mlp.make_fused_siren_sdf(field, "bf16")
    x = torch.rand(n, 3, device=dev) * 2 - 1
    before = fused_mlp.KERNEL.launches
    v = sdf(x)
    v2, g = sdf.sdf_and_grad(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 2
    torch.testing.assert_close(v, v2, atol=0, rtol=0)
    ref = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x, True)
    own = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x)
    for a, b, c in zip((v, g), ref, own):
        assert float((a - b).abs().max()) <= float((b - c).abs().max())
    gen = torch.Generator(device=dev).manual_seed(n)
    xs = torch.rand(8192, 3, generator=gen, device=dev) * 2 - 1
    plain = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, xs, True)
    exact = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, xs, True, True)
    for a, b, e in zip(sdf.sdf_and_grad(xs), plain, exact):
        assert _close_frac(a, e, 1e-5) >= min(0.99, _close_frac(b, e, 1e-5))


@pytest.mark.parametrize("hidden,n_layers,n,n_steps", [
    (256, 3, 2048, 100),     # a uni warm-up step's rays: 16 rays a block
    (256, 3, 4099, 37),      # 32 rays a block, a ragged last block and tile
    (256, 3, 24576, 100),    # 64 rays a block
    (96, 2, 777, 1000),      # 8 rays a block, past the old proposal-buffer limit
    (32, 1, 65, 5),
    (512, 3, 2048, 100),     # 32-row tiles: 16 rays a block
    (512, 3, 4099, 37),      # a ragged last block and tile
    (320, 2, 777, 100)])     # padded to the 384-wide instance
@pytest.mark.parametrize("coarse", [False, True])
def test_fused_sampler_siren_equals_sweep_plain_over_fused(dev, hidden, n_layers,
                                                           n, n_steps, coarse):
    """The SIREN sampler evaluates every point on fused_mlp's tile: all four
    outputs equal `sweep_plain` over the fused callables bit for bit."""
    field, sdf = _sdf(dev, hidden, n_layers)
    fn_c = fused_mlp.make_fused_siren_sdf(field, "bf16") if coarse else None
    cam, d, t_lo, t_hi = _rays(dev, n)
    steps = linspace01(n_steps, device=dev)
    margin = 2e-3 if coarse else 0.0
    before = fused_sampler.KERNEL.launches
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=8,
                                margin=margin, coarse_sweep=coarse)
    torch.cuda.synchronize()
    assert fused_sampler.KERNEL.launches == before + 1
    ref = fused_sampler.sweep_plain(sdf, cam, d, t_lo, t_hi, steps, 8, margin,
                                    sdf_fn_coarse=fn_c)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int((ref[1] < 0).sum()) > 0


def _bracketed(fine, cam, d, t_lo, t_hi, steps, out):
    """Rays whose picked bracket [z_low, t_pick] holds a root of `fine`:
    f(z_low) > 0 > f(t_pick), z_low the proposal before the pick."""
    ts = fma(steps, (t_hi - t_lo)[:, None], t_lo[:, None])
    idx = torch.argmax((ts == out[0][:, None]).int(), dim=-1)
    z_low = torch.gather(ts, 1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    f_low = fine(fma(z_low[:, None], d, cam))
    return (f_low > 0) & (out[1] < 0)


def test_fused_sampler_siren_coarse_matches_plain(dev):
    _, sdf = _sdf(dev, 256, 3)
    cam, d, t_lo, t_hi = _rays(dev, 4096)
    steps = linspace01(100, device=dev)
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=8,
                                margin=2e-3, coarse_sweep=True)
    ref = fused_sampler.sweep_plain(
        lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p), cam, d, t_lo, t_hi,
        steps, 8, 2e-3,
        sdf_fn_coarse=lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p, True))
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(out[1][same], ref[1][same], atol=1e-5, rtol=0)
    hit = same & (ref[1] < 0)
    assert int(hit.sum()) > 100
    # chip_smoke.py's conditioned bar: within 1e-4, or within the f32 value
    # tolerance 2e-5 over the plain field's slope along the ray at the plain
    # root (a grazing ray's root moves by the fields' difference over its
    # slope: ROADMAP Queue 3, Known differences), on the rays whose fine
    # bracket holds the root (f(z_low) > 0 > f(t_pick)): the coarse pick is
    # the first step below -margin, so on this random-init field (|f| ~
    # 0.03) most picks' re-validated ends both lie inside, the secant
    # extrapolates, and neither version's z_secant is a root
    z = ref[3]
    _, g = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, cam + z[:, None] * d)
    slope = (g * d).sum(-1).abs()
    dz = (out[3] - z).abs()
    root = hit & _bracketed(lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p),
                            cam, d, t_lo, t_hi, steps, ref)
    assert int(root.sum()) >= 100
    assert float(((dz <= 1e-4) | (dz * slope <= 2e-5))[root].float().mean()) >= 0.999


def test_trace_march_siren_matches_plain(dev):
    _, sdf = _sdf(dev, 256, 3)
    cam, d, st = _march_state(dev, sdf, 8192)
    before = fused_trace.KERNEL.launches
    out = sdf.fused_trace_stepper(cam, d, st, 3, 5e-5, 0.5, 1, True)
    torch.cuda.synchronize()
    assert fused_trace.KERNEL.launches == before + 1
    ref = march_plain(lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p), cam, d,
                      st, 3, 5e-5, 0.5, 1, True)
    for i in (4, 5, 6, 7):
        assert float((out[i] == ref[i]).float().mean()) >= 0.999
    for i in (0, 1):
        assert _close_frac(out[i], ref[i], 1e-5) >= 0.999
    loop = march_plain(sdf, cam, d, st, 3, 5e-5, 0.5, 1, True)
    for a, b in zip(out, loop):
        assert torch.equal(a, b)
    coarse = fused_mlp.make_fused_siren_sdf(_sdf(dev, 256, 3)[0], "bf16")
    out_c = coarse.fused_trace_stepper(cam, d, st, 3, 5e-5, 0.5, 1, True)
    for a, b in zip(out_c, march_plain(coarse, cam, d, st, 3, 5e-5, 0.5, 1, True)):
        assert torch.equal(a, b)


def test_ray_trace_siren_uni_schedule_kernels(dev):
    """The uni arm's schedule (configs/ablation_compound_uni.yml) on the
    SIREN kernels: trace_in_kernel equals the loop over the fused kernel,
    and the loop agrees with every plain version."""
    field, sdf = _sdf(dev, 256, 3)
    coarse = fused_mlp.make_fused_siren_sdf(field, "bf16")
    cam, d, _, _ = _rays(dev, 2048)
    cam, d = cam.reshape(2, -1, 3), d.reshape(2, -1, 3)
    gt = torch.ones(d.shape[:2], dtype=torch.bool, device=dev)
    cfg = RayTracingConfig(
        sphere_tracing_iters=21, sampler_fraction=0.5,
        trace_compact_after=(8, 12), trace_compact_fraction=(0.8, 0.55),
        coarse_trace_iters=6, sampler_coarse=True, sampler_coarse_margin=2e-3,
        coarse_stall_on_cross=True, fused_backstep=True,
        trace_gate_end_front=True, sampler_in_kernel=True)
    with torch.no_grad():
        a = ray_trace(sdf, cam, d, gt, None, cfg, training=False,
                      sdf_fn_coarse=coarse)
        before = fused_trace.KERNEL.launches
        b = ray_trace(sdf, cam, d, gt, None,
                      dataclasses.replace(cfg, trace_in_kernel=True),
                      training=False, sdf_fn_coarse=coarse)
        assert fused_trace.KERNEL.launches > before
        p = ray_trace(fused_mlp.PlainSDF(sdf.pack), cam, d, gt, None, cfg,
                      training=False,
                      sdf_fn_coarse=fused_mlp.PlainSDF(sdf.pack, "bf16"))
    assert torch.equal(a.network_object_mask, b.network_object_mask)
    assert torch.equal(a.sampler_mask, b.sampler_mask)
    assert torch.equal(a.dists, b.dists)
    agree = a.network_object_mask == p.network_object_mask
    assert float(agree.float().mean()) >= 0.99
    assert _close_frac(a.dists, p.dists, 1e-4) >= 0.98


def _saliency_shapes(dev):
    """The lossS arm's three kNN calls at its shapes, as (label, query,
    points, query mask, points mask, k): the statistics (3000 reference
    points over the 2 x 3000 iso-points of a step), the hot-point lookup
    (6000 resampled points over 50 hot reference points, some unselected)
    and the mothers (64 fathers, some unused, over the 6000 points)."""
    ref, _, ref_m = _sphere_cloud(dev, 3000, seed=21)
    iso, _, iso_m = _sphere_cloud(dev, 6000, seed=22, frac=0.7)
    pts, _, pts_m = _sphere_cloud(dev, 6000, seed=23)
    hot_m = ref_m[:, :50] & (torch.arange(50, device=dev) < 41)
    fathers_m = torch.arange(64, device=dev)[None] < 57
    return [("statistics", ref, iso, ref_m, iso_m, 8),
            ("hot-point lookup", pts, ref[:, :50], pts_m, hot_m, 1),
            ("mothers", pts[:, 100:164], pts, fathers_m, pts_m, 8)]


@pytest.mark.parametrize("case", range(3), ids=["statistics", "hot", "mothers"])
def test_knn_kernel_saliency_shapes(dev, case):
    _, q, pts, qm, pm, k = _saliency_shapes(dev)[case]
    before = knn.KERNEL.launches
    a = knn.knn_points(q, pts, qm, pm, k=k)
    assert knn.KERNEL.launches == before + 1
    b = knn.knn_points(q, pts, qm, pm, k=k, method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)
    assert a.mask.any()


def test_knn_kernel_saliency_empty_and_sparse_databases(dev):
    """An all-masked database (no hot reference point): no neighbour at
    all; a database of 5 valid points at k = 8: at most 5 a query."""
    _, q, pts, qm, pm, _ = _saliency_shapes(dev)[1]
    none = torch.zeros_like(pm)
    a = knn.knn_points(q, pts, qm, none, k=1)
    b = knn.knn_points(q, pts, qm, none, k=1, method="dense")
    assert not a.mask.any() and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists) and torch.equal(a.mask, b.mask)
    _, q, pts, qm, pm, k = _saliency_shapes(dev)[2]
    few = torch.zeros_like(pm)
    few[:, :5] = pm[:, :5]
    a = knn.knn_points(q, pts, qm, few, k=k)
    b = knn.knn_points(q, pts, qm, few, k=k, method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)
    assert int(a.mask.sum(-1).max()) == int(few.sum())


def test_update_ref_metric_kernel_matches_plain(dev, monkeypatch):
    """The lossS statistics on the card: seeding by FPS of a 3000-point iso
    set, then three updates over 2 x 3000 iso-points, with the kNN kernel
    and with its plain version: the reference cloud and the running mean and
    count bit-equal (the kNN is exact and the sums keep one order)."""
    from isopoints_torch.training.trainer import MVRTrainer, TrainerConfig
    g = torch.Generator(device=dev).manual_seed(31)
    steps = []
    for _ in range(3):
        iso, _, mask = _sphere_cloud(dev, 6000, seed=len(steps) + 40, frac=0.7)
        loss = torch.rand(1, 6000, generator=g, device=dev)
        steps.append((iso.reshape(2, 3000, 3), loss.reshape(2, 3000),
                      mask.reshape(2, 3000)))
    states = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(knn, "knn_points_cuda", knn.knn_points_dense)
        tr = MVRTrainer(None, TrainerConfig(saliency_sampling=True,
                                            n_ref_points=4096), device=dev)
        before = knn.KERNEL.launches
        for args in steps:
            tr.update_ref_metric(*args)
        torch.cuda.synchronize()
        assert knn.KERNEL.launches - before == (0 if plain else 3)
        states.append(tr.saliency_state())
    for key, v in states[0].items():
        assert (v == states[1][key]).all(), key
    assert states[0]["ref_points"].shape == (1, 3000, 3)
    assert states[0]["ref_stat_n"].max() == 3


def test_dtu_projected_step_kernels_match_plain(dev, tmp_path, monkeypatch):
    """The uni arm (isopoints_torch/configs/mvr_uni_dtu.yml) on a 4-view
    128-px DTU-layout torus written on the card: 2 warm-up steps and the
    resample through the training entry, then one projected step's loss on
    the same draws with every kernel and with every plain version (the fused
    MLP off, the plain raster stages, the dense kNN, the plain SIREN in the
    trace): iso-point counts within 0.5% of the capacity and each loss term
    within rtol 1e-2 (chip_smoke.py phase 4's bars); the kernel run launches
    the fused MLP, the kNN, the selection and the fine stage, the plain run
    none of them."""
    from isopoints_torch import create_mvr_data, train_mvr
    from isopoints_torch.factories import create_model
    from isopoints_torch.training.trainer import compute_loss
    data_dir = tmp_path / "dtu"
    create_mvr_data.main(["torus", str(data_dir), "--dtu", "--n-views", "4",
                          "--image-size", "128"])
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(
        f"inherit_from: {os.path.join(os.path.dirname(os.path.dirname(__file__)), 'isopoints_torch', 'configs', 'mvr_uni_dtu.yml')}\n"
        f"data:\n  data_dir: {data_dir}\n")
    run = train_mvr.main([str(cfg_path), "--max-iters", "3", "--out-dir",
                          str(tmp_path / "out"), "--print-every", "100"])
    trainer, state, model = run.trainer, run.state, run.trainer.model
    assert bool((run.views([0])[2].focal_length < 0).all())
    it = state.it
    img, mask, cam = run.views(train_mvr.draw_views(0, it, 4))
    draws = trainer.draw(trainer.scheduler.at(it)["n_rays"], tuple(img.shape[1:3]),
                         2, n_points=state.points.shape[1])
    hp = {k: float(v) for k, v in trainer.scheduler.at(it).items()
          if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied", "sdf_alpha")}
    hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
    plain_model = create_model(run.cfg, device=dev)
    plain_model.load_state_dict(model.state_dict())
    plain_model.cfg = dataclasses.replace(model.cfg, use_fused_mlp=False)
    plain_model.raster_settings = dataclasses.replace(model.raster_settings,
                                                      use_pallas=False)
    plain_model.trace_sdf_fn = lambda: fused_mlp.PlainSDF(
        fused_mlp.SirenPack(plain_model.decoder))
    plain_model.trace_sdf_fn_coarse = lambda: fused_mlp.PlainSDF(
        fused_mlp.SirenPack(plain_model.decoder), "bf16")
    kernels = (fused_mlp.KERNEL, knn.KERNEL, select.KERNEL, splat.KERNEL)
    res = {}
    for name, m in (("kernels", model), ("plain", plain_model)):
        if name == "plain":
            monkeypatch.setattr(knn, "knn_points_cuda", knn.knn_points_dense)
        before = [k.launches for k in kernels]
        with torch.no_grad():
            _, met, _, _, _ = compute_loss(
                m, state.points, state.points_mask, draws.pixels, img, mask, cam,
                draws.eikonal, draws.u_minsdf, hp, project=True,
                proj_draws=draws.projected, spacing=state.spacing)
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert all(n > 0 for n in launched) if name == "kernels" else not any(launched)
        res[name] = {k: float(v) for k, v in met.items()}
    k_, p_ = res["kernels"], res["plain"]
    assert p_["n_iso"] > 0
    assert abs(k_["n_iso"] - p_["n_iso"]) <= 0.005 * model.ccfg.max_iso_per_batch
    for key in ("loss", "loss_rgb", "loss_freespace", "loss_occupied", "loss_eikonal"):
        assert abs(k_[key] - p_[key]) <= 1e-2 * abs(p_[key]) + 1e-6, key


def test_checkpoint_on_the_card_feeds_the_fused_mlp(dev, tmp_path):
    """A combined SIREN model's weights saved on the card and loaded into
    another model: the fused MLP (f32 and the bf16 coarse mode) evaluates
    the loaded weights bit for bit as the saving model does, since
    `trace_sdf_fn` / `trace_sdf_fn_coarse` build their packs from the
    decoder at every call (models/implicit.py:100-118); a callable made
    before the load keeps the old weights."""
    from isopoints_torch.config import default_config_path, load_config
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                   "isopoints_torch", "configs", "mvr_uni_siren.yml"),
                      default_config_path())
    a, b = (create_model(cfg, generator=torch.Generator(device=dev).manual_seed(s),
                         device=dev) for s in (0, 1))
    x = torch.rand(5000, 3, generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev) * 2 - 1
    stale = b.trace_sdf_fn()
    before = fused_mlp.KERNEL.launches
    va, (va2, ga) = a.trace_sdf_fn()(x), a.trace_sdf_fn().sdf_and_grad(x)
    ca = a.trace_sdf_fn_coarse()(x)
    vb0 = stale(x)
    assert not torch.equal(va, vb0)
    CheckpointIO(str(tmp_path), model=a.state_dict()).save("model.npz")
    ck = CheckpointIO(str(tmp_path), model=b.state_dict())
    ck.load("model.npz")
    assert all(v.is_cuda for v in ck.registry["model"].values())
    b.load_state_dict(ck.registry["model"])
    vb, (vb2, gb) = b.trace_sdf_fn()(x), b.trace_sdf_fn().sdf_and_grad(x)
    cb = b.trace_sdf_fn_coarse()(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches - before == 7
    assert torch.equal(vb, va) and torch.equal(vb2, va2) and torch.equal(gb, ga)
    assert torch.equal(cb, ca)
    assert torch.equal(stale(x), vb0)


def test_fused_mlp_on_a_grid_chunk(dev):
    """Row 1 at the mesh extraction's shape: the value on one 262,144-point
    chunk of a 256³ grid (utils/meshing.eval_sdf_grid), and a whole 64³ grid
    through `eval_sdf_grid` (chunks of 262,144, the last padded) against the
    plain version's grid, at the MLP tolerance."""
    from isopoints_torch.utils.meshing import eval_sdf_grid
    field, sdf = _sdf(dev, 256, 3)
    ax = torch.linspace(-1.0, 1.0, 256, device=dev)
    idx = torch.arange(32 * 262_144, 33 * 262_144, device=dev)
    x = torch.stack([ax[idx // 65536], ax[(idx // 256) % 256], ax[idx % 256]], -1)
    before = fused_mlp.KERNEL.launches
    v = sdf(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 1
    torch.testing.assert_close(v, fused_mlp.siren_sdf_plain(sdf.pack, x),
                               atol=2e-5, rtol=0)
    before = fused_mlp.KERNEL.launches
    grid = eval_sdf_grid(sdf, 70, (-1.0,) * 3, (1.0,) * 3, device=dev)
    assert fused_mlp.KERNEL.launches == before + 2   # 343,000 points
    ref = eval_sdf_grid(fused_mlp.PlainSDF(sdf.pack), 70, (-1.0,) * 3,
                        (1.0,) * 3, device=dev)
    np.testing.assert_allclose(grid, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,p,k", [(50_000, 48_000, 1), (262_144, 5000, 8)],
                         ids=["chamfer", "imls"])
def test_knn_kernel_evaluation_shapes(dev, n, p, k):
    """Row 4 at the chamfer's shape (50,000 samples against ~50,000 GT
    points, k=1, past knn.SORT_MIN: the Morton route) and at an IMLS grid
    chunk's (262,144 queries against a 5000-point cloud, k=8): distances,
    indices and masks bit for bit against the plain version."""
    g = torch.Generator(device=dev).manual_seed(n + p)
    q = torch.rand(1, n, 3, generator=g, device=dev) * 2 - 1
    pts = torch.randn(1, p, 3, generator=g, device=dev)
    pts = 0.5 * pts / pts.norm(dim=-1, keepdim=True)
    before = knn.KERNEL.launches
    a = knn.knn_points(q, pts, k=k)
    torch.cuda.synchronize()
    assert knn.KERNEL.launches == before + 1
    b = knn.knn_points(q, pts, k=k, method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("n,p,k,self_", [(5000, 4000, 1, False),
                                         (4000, 4000, 16, True),
                                         (4000, 4000, 8, False),
                                         (20000, 20000, 16, False)],
                         ids=["sal", "repulsion", "frames", "data-normals"])
def test_knn_kernel_dtu_shapes(dev, n, p, k, self_):
    """Row 4 at the DTU workload's shapes: the SAL match and the weights'
    radius search (5000 space or surface points against 4000 iso-points,
    k=1), a refresh's repulsion and denoising (4000, self-excluded, k=16)
    and frames (k=8), the data normals of the 20,000-point default cloud
    (k=16, past knn.SORT_MIN: the Morton route); masked iso-points; bit for
    bit against the plain version."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    pts = torch.randn(1, p, 3, generator=g, device=dev)
    pts = 0.5 * pts / pts.norm(dim=-1, keepdim=True)
    pm = torch.rand(1, p, generator=g, device=dev) < 0.9
    q = pts if self_ or n == p else torch.rand(1, n, 3, generator=g, device=dev) * 2 - 1
    qm = pm if q is pts else torch.ones(1, n, dtype=torch.bool, device=dev)
    before = knn.KERNEL.launches
    a = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=self_)
    torch.cuda.synchronize()
    assert knn.KERNEL.launches == before + 1
    b = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=self_, method="dense")
    assert torch.equal(a.mask, b.mask) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("ear", [True, False], ids=["2 rounds", "5 rounds"])
def test_dtu_refresh_on_the_card(dev, ear):
    """A DTU refresh (perturbation, Newton, 2 or 5 repulsion rounds, frames,
    denoising) of 4000 iso-points on a SIREN 3x256 through the fused kernel
    and through the plain versions (`PlainSDF`, the plain kNN): both kernels
    launch; fused_mlp's value+grad at the 4000 points within the MLP
    tolerances; valid counts within 0.5% of the capacity; with 2 rounds 99%
    of the points valid in both within 1e-4 (Newton stops at |f| <= 1e-5).
    Five rounds amplify rounding past that on a random field
    (tests/test_torch_dtu_refresh.py), so there only the counts."""
    from isopoints_torch.workloads import dtu_points as tw
    field, sdf = _sdf(dev, 256, 3)
    cfg = tw.DTUPointsConfig(ear=ear)
    g = torch.Generator(device=dev).manual_seed(3)
    # seeds near the field's level set: a first projection
    x0 = torch.rand(1, 4000, 3, generator=g, device=dev) * 1.5 - 0.75
    from isopoints_torch.models.levelset import project_points_newton
    seed = project_points_newton(sdf, x0, torch.ones(1, 4000, dtype=torch.bool,
                                                     device=dev))
    u = torch.rand(1, 4000, 3, generator=g, device=dev)
    v, gr = sdf.sdf_and_grad(seed.points[0])
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, seed.points[0])
    torch.testing.assert_close(v, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(gr, g_ref, atol=1e-4, rtol=1e-4)
    b_mlp, b_knn = fused_mlp.KERNEL.launches, knn.KERNEL.launches
    a = tw.refresh_iso(sdf, seed.points, seed.mask, u, cfg)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches > b_mlp and knn.KERNEL.launches > b_knn
    knn_cuda = knn.knn_points_cuda
    knn.knn_points_cuda = knn.knn_points_dense
    try:
        b = tw.refresh_iso(fused_mlp.PlainSDF(sdf.pack), seed.points, seed.mask,
                           u, cfg)
    finally:
        knn.knn_points_cuda = knn_cuda
    assert int(b.mask.sum()) > 1000
    assert abs(int(a.mask.sum()) - int(b.mask.sum())) <= 0.005 * 4000
    if ear:
        both = a.mask & b.mask
        d = (a.points - b.points).abs().amax(-1)[both]
        assert float((d <= 1e-4).float().mean()) >= 0.99


# ---------------------------------------------------------------------------
# The mesh ray-caster (csrc/raymesh.cu)
# ---------------------------------------------------------------------------

def _raymesh_scene(dev, n_rays, n_faces, seed=0):
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-1, 1, (n_faces, 3)).astype(np.float32)
    faces = rng.randint(0, n_faces, (n_faces, 3))
    faces = np.concatenate([faces, faces[: n_faces // 10]])   # duplicates: lowest index wins
    orig = (np.array([[0.0, 0.0, -3.0]]) + rng.normal(0, 0.05, (n_rays, 3))).astype(np.float32)
    dirs = rng.normal(0, 0.3, (n_rays, 3)).astype(np.float32)
    dirs[:, 2] = rng.uniform(0.5, 2.0, n_rays)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(orig), t(dirs), t(verts), t(faces).long()


@pytest.mark.parametrize("n_rays,n_faces", [(1, 5), (2047, 513), (20_000, 3000)])
def test_raymesh_kernel_equals_plain(dev, n_rays, n_faces):
    """Kernel and plain version round the same operations in the same
    order: t, faces, points and normals bit for bit, with ragged blocks
    (2048 rays a block) and ragged face tiles (512 a tile)."""
    from isopoints_torch.ops import raymesh
    o, d, v, f = _raymesh_scene(dev, n_rays, n_faces)
    before = raymesh.KERNEL.launches
    a = raymesh.ray_mesh_intersect(o, d, v, f)
    assert raymesh.KERNEL.launches == before + 1
    b = raymesh.ray_mesh_intersect_plain(o, d, v, f)
    torch.cuda.synchronize()
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if n_rays > 1:
        assert 0 < int(a.hit.sum()) < n_rays


def test_raymesh_kernel_refuses_bad_inputs(dev):
    from isopoints_torch.ops import raymesh
    o, d, v, f = _raymesh_scene(dev, 64, 40)
    packed = raymesh.pack_faces(v, f)
    with pytest.raises(TypeError):
        raymesh.intersect_cuda(o.double(), d.double(), packed)
    with pytest.raises(ValueError):
        raymesh.intersect_cuda(o.cpu(), d, packed)
    with pytest.raises(ValueError):
        raymesh.intersect_cuda(o, d, packed[:, :6])


# ---------------------------------------------------------------------------
# The wide tile (csrc/mlp_wide.cuh): 384 and 512, both modes
# ---------------------------------------------------------------------------

def test_wide_instances_do_not_spill(dev):
    """ptxas spills in no kernel of the four wide libraries (their -Xptxas
    -v logs, kept beside them)."""
    libs = _build.build_all()
    for name in ("fused_igr_wide", "fused_mlp_wide", "fused_sampler_wide",
                 "fused_trace_wide"):
        with open(libs[name] + ".log") as f:
            log = f.read()
        assert log.count("0 bytes spill stores, 0 bytes spill loads") == log.count(
            "bytes spill stores") > 0, name


@pytest.mark.parametrize("hidden,n_layers,skip", [(512, 8, (4,)), (384, 4, (2,)),
                                                  (288, 3, (3,))])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_tile_tails_and_rows(dev, hidden, n_layers, skip, bf16):
    """Ragged tiles: n = 1, 63, 65 and tile counts that leave a cluster's
    second unit empty (3 units of 64 value rows, 5 of 16 points with the
    gradient) against the plain version, and every point's bits the same
    whatever tile it falls in (evaluated alone, and shifted by one row),
    the value column of value+grad equal to the value."""
    field, _ = _igr(dev, hidden, n_layers, skip_in=skip)
    sdf = fused_mlp.make_fused_igr_sdf(field, "bf16" if bf16 else "f32")
    gen = torch.Generator(device=dev).manual_seed(hidden)
    xs = torch.rand(200, 3, generator=gen, device=dev) * 2 - 1
    v_all, g_all = sdf.sdf_and_grad(xs)
    assert torch.equal(sdf(xs), v_all)
    for n in (1, 63, 65, 3 * 64, 5 * 16):
        x = xs[:n]
        v, (v2, g) = sdf(x), sdf.sdf_and_grad(x)
        assert torch.equal(v, v_all[:n]) and torch.equal(v2, v) and torch.equal(g, g_all[:n])
        assert torch.equal(sdf(xs[1:n + 1]), v_all[1:n + 1])
    v_ref, g_ref = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, xs, bf16)
    own = fused_mlp.igr_sdf_and_grad_plain(sdf.pack, xs)
    if bf16:
        for a, b, c in zip((v_all, g_all), (v_ref, g_ref), own):
            assert float((a - b).abs().max()) <= float((b - c).abs().max())
    else:
        torch.testing.assert_close(v_all, v_ref, atol=2e-5, rtol=0)
        torch.testing.assert_close(g_all, g_ref, atol=1e-4, rtol=1e-4)
    one = torch.cat([sdf(xs[i:i + 1]) for i in range(0, 200, 37)])
    assert torch.equal(one, v_all[::37])


@pytest.mark.parametrize("hidden,n_layers", [(512, 3), (384, 2)])
def test_wide_siren_value_and_gradient(dev, hidden, n_layers):
    """The SIREN wide instances: value+grad's value column equal to the
    value, both modes; f32 within the narrow tolerances of the plain
    version."""
    _, sdf = _sdf(dev, hidden, n_layers)
    coarse = fused_mlp.make_fused_siren_sdf(_sdf(dev, hidden, n_layers)[0], "bf16")
    x = torch.rand(1000, 3, device=dev) * 2 - 1
    for fn in (sdf, coarse):
        v, (v2, g) = fn(x), fn.sdf_and_grad(x)
        assert torch.equal(v, v2)
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x)
    torch.testing.assert_close(sdf(x), v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(sdf.sdf_and_grad(x)[1], g_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hidden,n_layers,skip,n", [(384, 4, (2,), 97), (288, 3, (3,), 33),
                                                    (512, 8, (4,), 1)])
@pytest.mark.parametrize("coarse", [False, True])
def test_wide_sampler_and_march_equal_the_fused_callables(dev, hidden, n_layers, skip, n,
                                                          coarse):
    """On the wide tile the IGR sampler equals `sweep_plain` over the fused
    callables and the march `march_plain` over the fused callable (f32, and
    the bf16 callable's own), bit for bit, at ragged ray counts (a unit's
    masked rays, an empty second unit)."""
    field, sdf = _igr(dev, hidden, n_layers, skip_in=skip)
    fn_c = fused_mlp.make_fused_igr_sdf(field, "bf16")
    cam, d, t_lo, t_hi = _igr_rays(dev, n)
    steps = linspace01(37, device=dev)
    margin = 2e-3 if coarse else 0.0
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=8, margin=margin,
                                coarse_sweep=coarse)
    ref = fused_sampler.sweep_plain(sdf, cam, d, t_lo, t_hi, steps, 8, margin,
                                    sdf_fn_coarse=fn_c if coarse else None)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    fn = fn_c if coarse else sdf
    cam, d, st = _march_state(dev, fn, max(n, 2))
    out = fn.fused_trace_stepper(cam, d, st, 3, 5e-5, 0.5, 1, True)
    for a, b in zip(out, march_plain(fn, cam, d, st, 3, 5e-5, 0.5, 1, True)):
        assert torch.equal(a, b)
