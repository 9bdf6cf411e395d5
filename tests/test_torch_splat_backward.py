"""Port parity: the splat rasterizer's backward against the JAX package, on
the CPU.

The port's backward on CPU tensors runs the plain versions of its two
kernels (the CUDA kernels are held against them on the card in
tests/test_torch_kernels_cuda.py): the zbuf backward to the points
(`zbuf_backward_points_plain`: the tile sums of JAX `_zbuf_bwd_kernel`,
`zbuf_backward_tile_plain`, then the scatter of JAX's tiled backward
route) and the occupancy backward (`occ_backward_one_plain`, JAX
`_occ_backward_one` and `occ_backward_pallas_one`). The JAX side runs its
XLA path and its Pallas path (`use_pallas`, interpret mode on the CPU)
under `jax.jit`. Inputs are made with numpy from a seed, or derived from
such inputs by the JAX package, and handed to both as numpy arrays.

Tolerances. zbuf tile sums: within 1e-6 (the same terms, summed in another
order); the points' z gradient against JAX's tiled route within 1e-5 +
1e-6 relative (a point's sum runs over the slots of several tiles, in
another order). Occupancy xy gradient: |Δ| ≤ 1e-6·max|g| (the same pixel set and
the same per-pixel arithmetic, summed in another order). Gradients through
`rasterize_splats` under random cotangents: xy |Δ| ≤ 5e-5·max(1, max|g|)
(a point's sum runs over up to S² terms of both signs, each up to 1/dist,
in another order than XLA's: measured 1.8e-5·max|g| at S = 48, where a
single term is exact), z within 1e-5 relative + 1e-6 (the JAX XLA route
scatters per fragment, the port per candidate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.rendering.pallas_occ_bwd import occ_backward_pallas_one
from isopoints_tpu.rendering.pallas_splat import zbuf_backward_tile_pallas
from isopoints_tpu.rendering.rasterizer import (
    Fragments as JFragments,
    RasterizationSettings as JSettings,
    _occ_backward_one as j_occ_backward_one,
    _rasterize_bwd as j_rasterize_bwd,
    compute_splat_params as j_splat_params,
    rasterize_splats as j_rasterize,
    visible_point_mask as j_visible_point_mask,
)
from isopoints_torch.rendering import occ_bwd, select, splat
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  rasterize_splats)
from isopoints_torch.rendering.splat import (to_tiles,
                                             zbuf_backward_points_plain,
                                             zbuf_backward_tile_plain)


@pytest.mark.parametrize("seed,n_tiles,T,K,M", [(0, 16, 8, 5, 48),
                                                (1, 9, 4, 3, 7)])
def test_zbuf_tile_plain_matches_jax(seed, n_tiles, T, K, M):
    rng = np.random.RandomState(seed)
    slots = rng.randint(-1, M, (n_tiles, T * T, K)).astype(np.int32)
    slots[0] = -1                                # an empty tile
    gz = rng.randn(n_tiles, T * T, K).astype(np.float32)
    j = np.asarray(zbuf_backward_tile_pallas(jnp.asarray(slots), jnp.asarray(gz),
                                             M=M, interpret=True))
    t = zbuf_backward_tile_plain(torch.from_numpy(slots), torch.from_numpy(gz),
                                 M).numpy()
    assert t.shape == (n_tiles, M)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[0], 0.0)
    # the dispatcher of the points entry takes the plain version for CPU
    # tensors: these tile sums, read back from the image layout, scattered
    # to the candidates' points
    P = 3 * M
    cand = rng.randint(0, P, (1, n_tiles, M))
    img = _untile_np(gz, T, int(np.sqrt(n_tiles)))
    before = splat.ZBUF_KERNEL.launches
    got = splat.zbuf_backward_points(torch.from_numpy(slots)[None],
                                     torch.from_numpy(img),
                                     torch.from_numpy(cand), P).numpy()
    assert splat.ZBUF_KERNEL.launches == before
    want = torch.zeros(P).index_add_(0, torch.from_numpy(cand[0].reshape(-1)),
                                     torch.from_numpy(t).reshape(-1)).numpy()
    np.testing.assert_array_equal(got[0], want)


def _untile_np(tiles, T, nt):
    """(nt², T², K) tiles -> (1, nt·T, nt·T, K) image layout."""
    k = tiles.shape[-1]
    img = tiles.reshape(nt, nt, T, T, k).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(1, nt * T, nt * T, k))


def _zbuf_case(rng, b, nt, T, K, M, P):
    """Random slots (B, nt², T², K) with empty fragments, image-layout
    cotangents (B, S, S, K) and candidate ids (B, nt², M) in [0, P)."""
    slots = rng.randint(-1, M, (b, nt * nt, T * T, K)).astype(np.int32)
    g = rng.randn(b, nt * T, nt * T, K).astype(np.float32)
    cand = rng.randint(0, P, (b, nt * nt, M)).astype(np.int64)
    return slots, g, cand


@pytest.mark.parametrize("seed,nt,T,K,M,P", [(0, 4, 8, 5, 48, 150),
                                             (1, 3, 4, 3, 7, 20)])
def test_zbuf_points_plain_matches_jax_tiled_route(seed, nt, T, K, M, P):
    """`zbuf_backward_points_plain` against the z gradient of JAX's tiled
    backward route (`_rasterize_bwd`, rasterizer.py:613-643: the Pallas
    tile reduction in interpret mode, then the per-cloud scatter), on
    B = 2 clouds with a zero occupancy cotangent."""
    rng = np.random.RandomState(seed)
    b, S = 2, nt * T
    slots, g, cand = _zbuf_case(rng, b, nt, T, K, M, P)
    js = JSettings(image_size=S, tile_size=T, points_per_pixel=K,
                   max_points_per_tile=M, use_pallas=True,
                   use_pallas_backward=False)
    pts = rng.uniform(-1, 1, (b, P, 3)).astype(np.float32)
    radii = rng.uniform(0.01, 0.05, (b, P, 2)).astype(np.float32)
    mask = np.ones((b, P), bool)
    res = (jnp.asarray(pts), jnp.asarray(radii), jnp.asarray(mask), None,
           jnp.asarray(mask), (jnp.asarray(slots), jnp.asarray(cand)))
    cot = JFragments(idx=None, zbuf=jnp.asarray(g), qvalue=None,
                     occupancy=jnp.zeros((b, S, S), jnp.float32),
                     visibility=None, tile_overflow=None)
    j = np.asarray(j_rasterize_bwd(js, res, cot)[0])
    np.testing.assert_array_equal(j[..., :2], 0.0)
    t = zbuf_backward_points_plain(torch.from_numpy(slots), torch.from_numpy(g),
                                   torch.from_numpy(cand), P).numpy()
    assert t.shape == (b, P) and np.abs(t).max() > 1.0
    np.testing.assert_allclose(t, j[..., 2], atol=1e-5, rtol=1e-6)
    # the image layout is read as the tiles the fine stage wrote
    tiles = to_tiles(torch.from_numpy(g), T).numpy()
    np.testing.assert_array_equal(tiles.reshape(b, nt * nt, T * T, K)[1, nt + 1],
                                  g[1, T:2 * T, T:2 * T].reshape(T * T, K))


def test_zbuf_points_padded_slots_leave_point_zero_its_sum():
    """The selection pads a tile's unfilled candidate slots with point 0;
    no fragment hits them, so point 0's gradient is its own fragments' sum
    and every point's is the per-fragment sum over its fragments."""
    rng = np.random.RandomState(7)
    b, nt, T, K, M, P = 2, 3, 8, 5, 32, 40
    slots = np.full((b, nt * nt, T * T, K), -1, np.int32)
    cand = np.zeros((b, nt * nt, M), np.int64)          # padding: point 0
    for i in range(b):
        for t in range(nt * nt):
            n_ok = rng.randint(4, 12)
            ids = rng.choice(np.arange(1, P), n_ok, replace=False)
            if t % 2 == 0:
                ids[0] = 0                               # point 0 for real
            cand[i, t, :n_ok] = ids
            used = rng.uniform(size=(T * T, K)) < 0.7
            slots[i, t][used] = rng.randint(0, n_ok, int(used.sum()))
    g = rng.randn(b, nt * T, nt * T, K).astype(np.float32)
    got = splat.zbuf_backward_points(torch.from_numpy(slots), torch.from_numpy(g),
                                     torch.from_numpy(cand), P).numpy()
    tiles = to_tiles(torch.from_numpy(g), T).numpy().reshape(slots.shape)
    for i in range(b):
        pid = np.where(slots[i] >= 0,
                       np.take_along_axis(cand[i][:, None, :],
                                          np.maximum(slots[i], 0).reshape(
                                              nt * nt, 1, -1), -1
                                          ).reshape(slots[i].shape), -1)
        hit = pid >= 0
        want = np.bincount(pid[hit], weights=tiles[i][hit].astype(np.float64),
                           minlength=P)
        assert (pid == 0).sum() > 0 and (cand[i] == 0).sum() > 50
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=1e-6)
    assert splat.ZBUF_KERNEL.launches == 0


def _occ_case(n=600, S=128, seed=0, edge_cluster=False, visible_frac=0.85):
    """tests/test_pallas_occ_bwd.py's cases, drawn with numpy: points on a
    0.7-sphere at depth 2.5, radii 0.01 + 0.02·|N(0,1)|, a sparse cotangent."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    v = 0.7 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    if edge_cluster:
        v[: n // 3, 0] = 0.98                    # patches clipped at the border
    pts = np.stack([v[:, 0], v[:, 1], 2.5 + v[:, 2]], -1).astype(np.float32)
    radii = (np.abs(rng.randn(n, 2)) * 0.02 + 0.01).astype(np.float32)
    visible = rng.uniform(size=n) < visible_frac
    grad = (rng.randn(S, S) * (rng.uniform(size=(S, S)) < 0.3)).astype(np.float32)
    return pts, radii, visible, grad


_j_occ = jax.jit(j_occ_backward_one, static_argnums=4)


def _assert_occ_close(a, b):
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,S,seed,edge,pallas", [
    (600, 128, 0, False, True),
    (600, 128, 7, False, False),
    (600, 128, 3, True, True),      # border cluster
    (200, 64, 5, False, True),      # W = S: the patch is the image
    (400, 256, 8, True, True),      # S = 256: the TPU kernel's column strips
])
def test_occ_plain_matches_both_jax_routes(n, S, seed, edge, pallas):
    case = _occ_case(n, S, seed, edge)
    js = JSettings(image_size=S)
    t = occ_bwd.occ_backward_one_plain(*(torch.from_numpy(a) for a in case),
                                       RasterizationSettings(image_size=S)).numpy()
    assert np.abs(t).max() > 0
    _assert_occ_close(t, np.asarray(_j_occ(*(jnp.asarray(a) for a in case), js)))
    if pallas:
        _assert_occ_close(t, np.asarray(occ_backward_pallas_one(
            *(jnp.asarray(a) for a in case), js, interpret=True)))


def test_occ_invisible_points_get_zero():
    pts, radii, _, grad = _occ_case(n=100, S=64, seed=6)
    out = occ_bwd.occ_backward_one(torch.from_numpy(pts), torch.from_numpy(radii),
                                   torch.zeros(100, dtype=torch.bool),
                                   torch.from_numpy(grad),
                                   RasterizationSettings(image_size=64))
    np.testing.assert_array_equal(out.numpy(), 0.0)
    assert occ_bwd.KERNEL.launches == 0


def test_nanmedian_mid_is_numpys_median():
    rng = np.random.RandomState(4)
    for n, n_nan in ((10, 3), (9, 4), (8, 0), (5, 5), (1, 0)):
        x = rng.uniform(size=n).astype(np.float32)
        x[rng.permutation(n)[:n_nan]] = np.nan
        got = float(occ_bwd.nanmedian_mid(torch.from_numpy(x)))
        want = np.float32(np.nanmedian(x)) if n_nan < n else np.nan
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(jnp.asarray(x))))


def test_occ_search_radius_takes_the_midpoint_median():
    """Four renderable points whose sorted radii put 0.01 and 0.05 in the
    middle: the search radius is 10·0.03 (JAX's midpoint), not 10·0.01
    (torch.nanmedian's lower value), and pixels between the two radii
    contribute."""
    S = 64
    pts = np.array([[0.0, 0.0, 2.0], [0.5, 0.5, 2.0], [-0.5, 0.5, 2.0],
                    [0.5, -0.5, 2.0]], np.float32)
    radii = np.array([[0.005, 0.006], [0.007, 0.01], [0.05, 0.06],
                      [0.07, 0.08]], np.float32)
    visible = np.ones(4, bool)
    grad = np.zeros((S, S), np.float32)
    grad[:, : S // 2] = -1.0     # one half-plane, so the sums do not cancel
    case = (pts, radii, visible, grad)
    ts = RasterizationSettings(image_size=S)
    t = occ_bwd.occ_backward_one_plain(*(torch.from_numpy(a) for a in case), ts)
    j = np.asarray(_j_occ(*(jnp.asarray(a) for a in case), JSettings(image_size=S)))
    _assert_occ_close(t.numpy(), j)
    _, sr2, _ = occ_bwd.backward_window(*(torch.from_numpy(a) for a in case[:3]), ts)
    np.testing.assert_allclose(float(sr2), (10 * 0.03) ** 2, rtol=1e-6)
    lower = torch.nanmedian(torch.from_numpy(radii.reshape(-1)))
    assert float(lower) == pytest.approx(0.01)
    # the lower median's window gives another gradient
    narrow = RasterizationSettings(image_size=S, radii_backward_scaler=10 * 0.01 / 0.03)
    t_low = occ_bwd.occ_backward_one_plain(*(torch.from_numpy(a) for a in case), narrow)
    assert np.abs(t.numpy() - t_low.numpy()).max() > 0.1 * np.abs(j).max()


def _sphere_splats(n_points, S, seed=0, n_views=2):
    """JAX splat parameters (numpy) of a radius-0.5 sphere cloud seen from
    n_views cameras at distance 2."""
    rng = np.random.RandomState(seed)
    v = rng.randn(1, n_points, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = np.repeat(0.5 * v, n_views, axis=0)
    mask = np.repeat(rng.uniform(size=(1, n_points)) > 0.05, n_views, axis=0)
    R, T = j_look_at(2.0, np.array([10.0, -25.0])[:n_views],
                     np.array([30.0, 200.0])[:n_views])
    cam = JCam.create(R=np.asarray(R), T=np.asarray(T), focal_length=2.0)
    sp = jax.jit(j_splat_params, static_argnums=4)(
        jnp.asarray(pts), jnp.asarray(np.repeat(v, n_views, axis=0)),
        jnp.asarray(mask), cam, JSettings(image_size=S))
    return tuple(np.array(a) for a in (sp.pts_ndc, sp.ellipse, sp.radii,
                                       sp.cutoff, sp.mask))


@functools.partial(jax.jit, static_argnums=(5, 8))
def _jax_vjp(pts_ndc, ellipse, radii, cutoff, mask, js, g_zbuf, g_occ, with_frags):
    def f(p):
        fr = j_rasterize(p, ellipse, radii, cutoff, mask, js)
        return fr.zbuf, fr.occupancy
    out, vjp = jax.vjp(f, pts_ndc)
    g = vjp((g_zbuf, g_occ))[0]
    return (g, out) if with_frags else g


def _cotangents(rng, b, S, K):
    g_zbuf = rng.randn(b, S, S, K).astype(np.float32)
    g_occ = (rng.randn(b, S, S) * (rng.uniform(size=(b, S, S)) < 0.5)).astype(np.float32)
    zero = np.zeros_like
    return {"occupancy": (zero(g_zbuf), g_occ), "zbuf": (g_zbuf, zero(g_occ)),
            "mixed": (g_zbuf, g_occ)}


def _assert_grad_close(t, j):
    xy_tol = 5e-5 * max(1.0, np.abs(j[..., :2]).max())
    np.testing.assert_allclose(t[..., :2], j[..., :2], atol=xy_tol, rtol=0)
    np.testing.assert_allclose(t[..., 2], j[..., 2], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("use_pallas,clip", [(False, -1.0), (True, -1.0),
                                             (False, 0.5)])
def test_autograd_matches_jax_grad(use_pallas, clip):
    """torch.autograd.grad through the port's rasterize_splats against
    jax.vjp of the JAX package's, for occupancy-only, zbuf-only and mixed
    cotangents, on the JAX XLA route (use_pallas False, whose zbuf part is
    the untiled per-fragment scatter) and the Pallas route."""
    S, P, M, R = 48, 512, 128, 2048
    args = _sphere_splats(P, S, seed=P)
    js = JSettings(image_size=S, tile_size=8, max_points_per_tile=M,
                   max_points_per_strip=R, use_pallas=use_pallas,
                   clip_pts_grad=clip)
    ts = RasterizationSettings(image_size=S, tile_size=8, max_points_per_tile=M,
                               max_points_per_strip=R, use_pallas=use_pallas,
                               clip_pts_grad=clip)
    rng = np.random.RandomState(1)
    j_args = tuple(jnp.asarray(a) for a in args)
    pts = torch.from_numpy(args[0]).requires_grad_(True)
    t_args = (pts,) + tuple(torch.from_numpy(a) for a in args[1:])
    frags = rasterize_splats(*t_args, ts)
    assert frags.idx.grad_fn is None and frags.zbuf.grad_fn is not None
    for name, (g_zbuf, g_occ) in _cotangents(rng, 2, S, 5).items():
        j, (j_zbuf, j_occ) = _jax_vjp(*j_args, js, jnp.asarray(g_zbuf),
                                      jnp.asarray(g_occ), True)
        np.testing.assert_array_equal(frags.occupancy.detach().numpy(),
                                      np.asarray(j_occ))
        np.testing.assert_allclose(frags.zbuf.detach().numpy(), np.asarray(j_zbuf),
                                   atol=1e-6, rtol=0)
        (t,) = torch.autograd.grad((frags.zbuf, frags.occupancy), pts,
                                   (torch.from_numpy(g_zbuf),
                                    torch.from_numpy(g_occ)), retain_graph=True)
        t, j = t.numpy(), np.asarray(j)
        assert np.abs(j).max() > 0, name
        if name == "occupancy" and clip < 0:
            np.testing.assert_array_equal(t[..., 2], 0.0)
        if name == "zbuf" and clip < 0:
            np.testing.assert_array_equal(t[..., :2], 0.0)
        if clip > 0:
            assert np.linalg.norm(t, axis=-1).max() <= clip * (1 + 1e-6)
        _assert_grad_close(t, j)
    assert splat.ZBUF_KERNEL.launches == 0 and occ_bwd.KERNEL.launches == 0


def test_zbuf_gradient_is_the_fragment_count():
    """dL/dz of L = Σ_valid zbuf is the number of fragments a point
    appears in (tests/test_rendering.py:189-209); no xy gradient. The
    visibility output is JAX's `visible_point_mask` of the idx maps."""
    S = 32
    args = [torch.from_numpy(a) for a in _sphere_splats(256, S, seed=3, n_views=1)]
    args[0].requires_grad_(True)
    ts = RasterizationSettings(image_size=S, tile_size=8, use_pallas=True)
    frags = rasterize_splats(*args, ts)
    loss = torch.sum(torch.where(frags.idx >= 0, frags.zbuf, 0.0))
    (g,) = torch.autograd.grad(loss, args[0])
    counts = np.bincount(frags.idx[frags.idx >= 0].numpy(), minlength=256)
    assert counts.sum() > 100
    np.testing.assert_allclose(g[0, :, 2].numpy(), counts, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(g[..., :2].numpy(), 0.0)
    np.testing.assert_array_equal(frags.visibility.numpy(), counts[None] > 0)
    np.testing.assert_array_equal(
        frags.visibility.numpy(),
        np.asarray(j_visible_point_mask(jnp.asarray(frags.idx.numpy()), 256)))


def test_no_gradient_builds_no_graph():
    """Without a gradient the rasterizer runs its forward alone: no
    autograd node, no residuals (the combined model's visibility rasters)."""
    args = [torch.from_numpy(a) for a in _sphere_splats(256, 32, seed=3, n_views=1)]
    ts = RasterizationSettings(image_size=32, tile_size=8)
    frags = rasterize_splats(*args, ts)
    assert all(t.grad_fn is None for t in frags)
    args[0].requires_grad_(True)
    with torch.no_grad():
        frags = rasterize_splats(*args, ts)
    assert all(t.grad_fn is None for t in frags)
    assert select.KERNEL.launches == 0 and splat.KERNEL.launches == 0


def test_splat_bench_runs_on_cpu():
    """The bench's splat section end to end at a small size on the CPU:
    lossless capacities, a finite gradient, no kernel launched."""
    from isopoints_torch import bench
    out = bench.run_splat("cpu", n=512, image_size=32, reps=1, log=lambda m: None)
    assert out["splat_tile_overflow"] == 0 and out["grad_finite"]
    assert out["frame_ms"] > 0 and out["spacing_ms"] > 0
    scene = bench.splat_scene(512, 32, "cpu")
    loss, grad, grad_ndc, frags = bench.splat_step(scene)
    assert float(loss) > 0 and bool(torch.isfinite(grad).all())
    assert float(grad_ndc[..., :2].abs().max()) > 0
    # d loss / d z_ndc: the count of fragments in front (zbuf > 0) per point
    counts = torch.bincount(frags.idx[frags.idx >= 0], minlength=512)
    assert torch.equal(grad_ndc[0, :, 2], counts.float())
    assert splat.ZBUF_KERNEL.launches == 0 and occ_bwd.KERNEL.launches == 0
