"""Port parity: the splat rasterizer's forward against the JAX package, on
the CPU.

The port's coarse and fine stages on CPU tensors are their plain versions
(the CUDA kernels are held against them on the card in
tests/test_torch_kernels_cuda.py). The JAX side runs its XLA path and its
Pallas path (`use_pallas`, interpret mode on the CPU). Inputs are made with
numpy from a seed, or derived from such inputs by the JAX package, and
handed to both as numpy arrays.

The JAX functions run under `jax.jit`, as in the JAX training step: XLA
then divides by a constant as a product with its reciprocal
((S − 2i − 1)/S for the pixel centers), and the port forms them that way.

Tolerances. Candidate selection: each tile's candidate SET and the overflow
count equal (the kernel and the Pallas path list candidates in another
order than the XLA path). Fragment maps from identical splat parameters:
`idx`, `occupancy`, `visibility` and `tile_overflow` equal; `zbuf` and
`qvalue` within 1e-6 (equal in practice: both packages form q with the
same fused multiply-adds). Splat parameters from identical points,
normals and cameras: masks equal, positions within 1e-6, conics and radii
within rtol 1e-3 (the 3×3 products run in another summation order and the
conic divides by det(GV), whose cancellation lifts their ~1e-6 to ~1e-4
on a few splats), spacings within 1e-7 of squared distances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.rendering.pallas_select import select_candidates_pallas
from isopoints_tpu.rendering.rasterizer import (
    RasterizationSettings as JSettings,
    _pixel_ndc as j_pixel_ndc,
    _tile_candidates as j_tile_candidates,
    compute_splat_params as j_splat_params,
    rasterize_splats as j_rasterize,
    splat_spacing as j_splat_spacing,
)
from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.rendering import select, splat
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  compute_splat_params,
                                                  rasterize_splats,
                                                  splat_spacing)
from isopoints_torch.rendering.select import pixel_ndc, select_candidates_plain
from isopoints_torch.rendering.splat import rasterize_fine_plain


def _random_splats(rng, P, z_ties=False):
    px = rng.uniform(-1.1, 1.1, P).astype(np.float32)
    py = rng.uniform(-1.1, 1.1, P).astype(np.float32)
    z = rng.uniform(0.5, 3.0, P).astype(np.float32)
    if z_ties:
        z = (np.round(z * 8.0) / 8.0).astype(np.float32)
    rx = rng.uniform(0.01, 0.25, P).astype(np.float32)
    ry = rng.uniform(0.01, 0.25, P).astype(np.float32)
    valid = rng.uniform(size=P) > 0.1
    return px, py, z, rx, ry, valid


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _jax_xla_selection(px, py, z, rx, ry, valid, S, T, R, M):
    nt = S // T
    xs = j_pixel_ndc(jnp.arange(S), S)
    cx = 0.5 * (xs[::T] + xs[T - 1::T])
    rows = []
    for ti in range(nt):
        ys = j_pixel_ndc(ti * T + jnp.arange(T), S)
        rows.append(j_tile_candidates(px, py, z, rx, ry, valid,
                                      0.5 * (ys[0] + ys[-1]), cx,
                                      float(T - 1) / S, M, strip_cap=R))
    return (jnp.concatenate([r[0] for r in rows]),
            jnp.concatenate([r[1] for r in rows]), sum(r[2] for r in rows))


def _sets(ci, ok):
    return [set(c[o].tolist()) for c, o in zip(ci, ok)]


def test_pixel_ndc_matches_jax():
    for S in (48, 64, 256):
        np.testing.assert_array_equal(
            pixel_ndc(torch.arange(S), S).numpy(),
            np.asarray(jax.jit(j_pixel_ndc, static_argnums=1)(jnp.arange(S), S)))


@pytest.mark.parametrize("seed,z_ties,S,R", [(0, False, 64, 256),
                                             (1, True, 64, 256),
                                             (2, False, 48, 2048)])
def test_selection_sets_match_jax(seed, z_ties, S, R):
    rng = np.random.RandomState(seed)
    T, P, M = 16, 640, 48
    arrays = _random_splats(rng, P, z_ties)
    px, py, z, rx, ry, valid = (jnp.asarray(a) for a in arrays)
    valid = valid & (z >= 0)
    ci_x, ok_x, ovf_x = (np.asarray(a) for a in _jax_xla_selection(
        px, py, z, rx, ry, valid, S, T, R, M))
    ci_p, ok_p, ovf_p = select_candidates_pallas(
        px, py, z, rx, ry, valid, S=S, T=T, nt=S // T, R=R, M=M,
        interpret=True)
    t = [torch.from_numpy(a)[None] for a in arrays]
    ci_t, ok_t, ovf_t = select.select_candidates(*t, S, T, R, M)
    assert ci_t.shape == (1, (S // T) ** 2, M)
    assert int(ovf_t[0]) == int(ovf_x) == int(ovf_p) > 0
    assert _sets(ci_t[0].numpy(), ok_t[0].numpy()) == _sets(ci_x, ok_x)
    assert _sets(ci_t[0].numpy(), ok_t[0].numpy()) == _sets(
        np.asarray(ci_p), np.asarray(ok_p))
    # the plain version keeps the XLA path's depth order too
    np.testing.assert_array_equal(np.where(ok_t[0].numpy(), ci_t[0].numpy(), -1),
                                  np.where(ok_x, ci_x, -1))
    assert select.KERNEL.launches == 0


def _sphere_scene(n_points, S, seed=0, n_views=2):
    """JAX splat parameters of a radius-0.5 sphere cloud seen from n_views
    cameras at distance 2 (numpy outputs), plus the inputs that made them."""
    rng = np.random.RandomState(seed)
    v = rng.randn(1, n_points, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = np.repeat(0.5 * v, n_views, axis=0).astype(np.float32)
    normals = np.repeat(v, n_views, axis=0).astype(np.float32)
    mask = np.repeat(rng.uniform(size=(1, n_points)) > 0.05, n_views, axis=0)
    R, T = j_look_at(2.0, np.array([10.0, -25.0])[:n_views],
                     np.array([30.0, 200.0])[:n_views])
    R, T = np.asarray(R), np.asarray(T)
    return pts, normals, mask, R, T


def _cameras(R, T):
    return (JCam.create(R=R, T=T, focal_length=2.0),
            PerspectiveCamera.create(R=R, T=T, focal_length=2.0))


@pytest.mark.parametrize("S,P,M,R", [(48, 512, 128, 2048),
                                     (64, 900, 64, 256)])
def test_splat_params_and_spacing_match_jax(S, P, M, R):
    pts, normals, mask, Rm, Tm = _sphere_scene(P, S)
    jcam, tcam = _cameras(Rm, Tm)
    js = JSettings(image_size=S, max_points_per_tile=M, max_points_per_strip=R)
    ts = RasterizationSettings(image_size=S, max_points_per_tile=M,
                               max_points_per_strip=R)
    j_sp = j_splat_spacing(jnp.asarray(pts), jnp.asarray(mask), js)
    t_sp = splat_spacing(torch.from_numpy(pts), torch.from_numpy(mask), ts)
    np.testing.assert_allclose(t_sp.numpy(), np.asarray(j_sp), atol=1e-7, rtol=0)
    j = jax.jit(j_splat_params, static_argnums=4)(
        *(jnp.asarray(a) for a in (pts, normals, mask)), jcam, js)
    t = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                             tcam, ts)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert 0.3 < t.mask.numpy().mean() < 0.7        # backface culling at work
    np.testing.assert_allclose(t.pts_ndc.numpy(), np.asarray(j.pts_ndc), atol=1e-6)
    for name in ("ellipse", "radii", "cutoff", "scaler"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-3,
                                   err_msg=name)
    # a cached spacing gives the same parameters
    t2 = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                              tcam, ts, spacing=t_sp[:1])
    np.testing.assert_array_equal(t2.ellipse.numpy(), t.ellipse.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("S,P,M,R", [(48, 512, 128, 2048),
                                     (64, 900, 64, 256)])
def test_fragments_match_jax(use_pallas, S, P, M, R):
    """The port's rasterizer (plain stages on the CPU, with or without
    `use_pallas`) against JAX's XLA path and its Pallas path, on identical
    splat parameters."""
    pts, normals, mask, Rm, Tm = _sphere_scene(P, S, seed=P)
    jcam, _ = _cameras(Rm, Tm)
    js = JSettings(image_size=S, max_points_per_tile=M, max_points_per_strip=R,
                   use_pallas=use_pallas)
    sp = jax.jit(j_splat_params, static_argnums=4)(
        *(jnp.asarray(a) for a in (pts, normals, mask)), jcam, js)
    args = (sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask)
    jf = jax.jit(j_rasterize, static_argnums=5)(*args, js)
    ts = RasterizationSettings(image_size=S, max_points_per_tile=M,
                               max_points_per_strip=R, use_pallas=use_pallas)
    tf = rasterize_splats(*(torch.from_numpy(np.asarray(a)) for a in args), ts)
    np.testing.assert_array_equal(tf.idx.numpy(), np.asarray(jf.idx))
    np.testing.assert_array_equal(tf.occupancy.numpy(), np.asarray(jf.occupancy))
    np.testing.assert_allclose(tf.zbuf.numpy(), np.asarray(jf.zbuf), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tf.qvalue.numpy(), np.asarray(jf.qvalue), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(tf.visibility.numpy(), np.asarray(jf.visibility))
    np.testing.assert_array_equal(tf.tile_overflow.numpy(),
                                  np.asarray(jf.tile_overflow))
    assert tf.visibility.numpy().sum() > 0.2 * P
    assert splat.KERNEL.launches == 0


def test_fine_stage_ignores_candidate_order():
    """Depth ties break by global index, so shuffling each tile's candidate
    list permutes `used` and `slots` and changes nothing else."""
    rng = np.random.RandomState(7)
    S, T, M = 32, 16, 48
    arrays = _random_splats(rng, 300, z_ties=True)
    t = [torch.from_numpy(a)[None] for a in arrays]
    ci, ok = select_candidates_plain(*t, S, T, 0, M)[:2]
    px, py, z, rx, ry, _ = t
    ell = torch.from_numpy(rng.uniform(5.0, 40.0, (1, 300, 3)).astype(np.float32))
    ell[..., 1] = 0.0
    table = torch.stack([px, py, z, ell[..., 0], ell[..., 1], ell[..., 2], rx,
                         ry, torch.ones_like(px)], -1)
    perm = torch.from_numpy(np.stack([rng.permutation(M) for _ in range(ci.shape[1])]))[None]
    shuf = lambda x: torch.gather(x, 2, perm)
    a = rasterize_fine_plain(table, ci, ok, S, T, 5, 0.05)
    b = rasterize_fine_plain(table, shuf(ci), shuf(ok), S, T, 5, 0.05)
    assert int((a.idx >= 0).sum()) > 100
    for name in ("idx", "zbuf", "qvalue", "occ"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(shuf(a.used), b.used)


def test_rasterizer_refuses_what_is_not_ported():
    """The anisotropic Vrk path, which raised before it was ported: splat
    parameters against JAX's from identical points, normals and cameras,
    with the tolerances of the isotropic ones (masks equal, positions
    within 1e-6, conics, radii and scalers within rtol 1e-3 on at least 99%
    of the splats and 1e-2 on all); its tangent frames come from each
    package's own eigh, whose eigenvectors may differ in sign, which
    Vrk = Σ λ t tᵀ and |det Mk| do not see, and on a neighbourhood whose two
    smallest eigenvalues nearly meet, in how they mix the normal and a
    tangent (an eigenvector's error grows as round-off over the eigenvalue
    gap: one scaler of 1024 is 1.5e-3 apart here). A cached spacing changes
    nothing (the anisotropic Vrk reads no spacing)."""
    S, P = 48, 512
    pts, normals, mask, Rm, Tm = _sphere_scene(P, S, seed=3)
    pts = pts * np.array([1.0, 0.6, 1.3], np.float32)       # an ellipsoid
    jcam, tcam = _cameras(Rm, Tm)
    js = JSettings(image_size=S, Vrk_isotropic=False)
    ts = RasterizationSettings(image_size=S, Vrk_isotropic=False)
    j = jax.jit(j_splat_params, static_argnums=4)(
        *(jnp.asarray(a) for a in (pts, normals, mask)), jcam, js)
    t = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                             tcam, ts)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.pts_ndc.numpy(), np.asarray(j.pts_ndc), atol=1e-6)
    for name in ("ellipse", "radii", "cutoff", "scaler"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        assert np.mean(rel <= 1e-3) >= 0.99, name
        np.testing.assert_allclose(a, b, rtol=1e-2, err_msg=name)
    iso = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                               tcam, RasterizationSettings(image_size=S))
    assert not torch.allclose(iso.ellipse, t.ellipse)     # another Vrk
    t2 = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                              tcam, ts, spacing=torch.ones(1, P))
    assert torch.equal(t2.ellipse, t.ellipse)


def test_visible_point_mask_matches_jax():
    from isopoints_tpu.rendering.rasterizer import visible_point_mask as j_vis
    from isopoints_torch.rendering.rasterizer import visible_point_mask
    rng = np.random.RandomState(4)
    idx = rng.randint(-1, 60, (2, 16, 16, 5))
    idx[1] = -1
    np.testing.assert_array_equal(visible_point_mask(torch.from_numpy(idx), 60).numpy(),
                                  np.asarray(j_vis(jnp.asarray(idx), 60)))


def test_weighted_sum_composite_and_render_match_jax():
    """The unnormalised compositor, and `render_pointcloud` with
    `normalize_weights=False` against JAX's on identical clouds (rgba
    within rtol 1e-5: the weights' exponentials and sums in another order;
    unnormalised sums reach tens)."""
    from isopoints_tpu.core.cloud import PointCloud as JCloud
    from isopoints_tpu.rendering.compositor import weighted_sum_composite as j_ws
    from isopoints_tpu.rendering.renderer import render_pointcloud as j_render
    from isopoints_torch.core.cloud import PointCloud
    from isopoints_torch.rendering.compositor import weighted_sum_composite
    from isopoints_torch.rendering.renderer import render_pointcloud
    rng = np.random.RandomState(5)
    idx = rng.randint(-1, 40, (2, 8, 8, 5))
    w = rng.uniform(size=idx.shape).astype(np.float32)
    feat = rng.uniform(size=(2, 40, 3)).astype(np.float32)
    T_ = torch.from_numpy
    np.testing.assert_allclose(
        weighted_sum_composite(T_(idx), T_(w), T_(feat)).numpy(),
        np.asarray(j_ws(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(feat))),
        atol=1e-6, rtol=0)
    S, P = 48, 512
    pts, normals, mask, Rm, Tm = _sphere_scene(P, S, seed=5)
    colors = rng.uniform(size=pts.shape).astype(np.float32)
    jcam, tcam = _cameras(Rm, Tm)
    for norm in (False, True):
        j = j_render(JCloud.create(*(jnp.asarray(a) for a in (pts, normals, colors)),
                                   mask=jnp.asarray(mask)), jcam,
                     JSettings(image_size=S), normalize_weights=norm)
        t = render_pointcloud(PointCloud.create(*(T_(a) for a in (pts, normals, colors)),
                                                mask=T_(mask)), tcam,
                              RasterizationSettings(image_size=S),
                              normalize_weights=norm)
        np.testing.assert_allclose(t.rgba.numpy(), np.asarray(j.rgba), atol=1e-6,
                                   rtol=1e-5)
        assert float(t.rgba[..., 3].sum()) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_clip_planes_match_jax(use_pallas):
    """A camera with znear 0.5 and zfar 3.0 on a cloud with splats on both
    sides of each plane: the renderable masks of both packages equal, the
    planes cull exactly the splats outside [0.5, 3.0] that the default
    planes keep, and the fragments rasterized from identical splat
    parameters equal JAX's exactly (`qvalue` exactly against the Pallas
    path, within 1e-6 against the XLA path)."""
    S, P, M, R = 48, 700, 128, 2048
    rng = np.random.RandomState(11)
    Rm, Tm = (np.array(a) for a in j_look_at(2.0, [15.0, -35.0], [40.0, 210.0]))
    center = -np.einsum("bi,bji->bj", Tm, Rm)
    # view depths 0.2..3.8 along each camera's axis, laterally within the
    # frustum at that depth
    depth = rng.uniform(0.2, 3.8, (2, P)).astype(np.float32)
    lateral = rng.uniform(-0.45, 0.45, (2, P, 2)).astype(np.float32) * depth[..., None]
    view = np.concatenate([lateral, depth[..., None]], -1)
    pts = (np.einsum("bpi,bji->bpj", view - Tm[:, None], Rm)).astype(np.float32)
    normals = (center[:, None] - pts).astype(np.float32)    # facing the camera
    mask = rng.uniform(size=(2, P)) > 0.05
    clipped = [(JCam.create(R=Rm, T=Tm, focal_length=2.0, znear=0.5, zfar=3.0),
                PerspectiveCamera.create(R=Rm, T=Tm, focal_length=2.0, znear=0.5,
                                         zfar=3.0)), _cameras(Rm, Tm)]
    js = JSettings(image_size=S, max_points_per_tile=M, max_points_per_strip=R,
                   use_pallas=use_pallas)
    ts = RasterizationSettings(image_size=S, max_points_per_tile=M,
                               max_points_per_strip=R, use_pallas=use_pallas)
    counts = []
    for jcam, tcam in clipped:
        sp = jax.jit(j_splat_params, static_argnums=4)(
            *(jnp.asarray(a) for a in (pts, normals, mask)), jcam, js)
        t = compute_splat_params(*(torch.from_numpy(a) for a in (pts, normals, mask)),
                                 tcam, ts)
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(sp.mask))
        args = (sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask)
        jf = jax.jit(j_rasterize, static_argnums=5)(*args, js)
        tf = rasterize_splats(*(torch.from_numpy(np.array(a)) for a in args), ts)
        for name in ("idx", "zbuf", "occupancy", "visibility", "tile_overflow"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)),
                                          err_msg=name)
        # q exactly as JAX's Pallas path forms it; its XLA path fuses q
        # otherwise (within the file's 1e-6)
        np.testing.assert_allclose(tf.qvalue.numpy(), np.asarray(jf.qvalue),
                                   atol=0 if use_pallas else 1e-6, rtol=0)
        counts.append(int(t.mask.sum()))
    view_z = np.einsum("bpi,bij->bpj", pts, Rm)[..., 2] + Tm[:, None, 2]
    inside = (view_z >= 0.5) & (view_z <= 3.0)
    assert (mask & (view_z < 0.5)).sum() > 50 and (mask & (view_z > 3.0)).sum() > 50
    assert counts[0] < counts[1]
    assert counts[1] - counts[0] == int((mask & ~inside & (view_z >= 0.1)).sum())
