"""The occupancy backward for B clouds, and models of its CUDA kernels'
design, on the CPU.

The kernels (isopoints_torch/csrc/occ_bwd.cu) cannot run here; they are
held against the plain version on the card in
tests/test_torch_kernels_cuda.py. Here:

- the batched `occ_backward` (on CPU tensors, the plain version cloud by
  cloud) against `jax.vmap` of the JAX package's `_occ_backward_one` and
  against `occ_backward_pallas_one` (interpret mode) at B = 2, on
  tests/test_torch_splat_backward.py's numpy-drawn cases; tolerance
  |Δ| ≤ 1e-6·max|g| (the same pixel set and per-pixel arithmetic, summed
  in another order);
- `window_model`, a numpy model of the window kernel: the renderable flags,
  the order-preserving keys of the renderable radii (NaN left out, −0 as
  +0), two 4-round 8-bit radix selections of the middle keys, the midpoint,
  `nan_to_num`, the scaler and the clamp, each in float32: its search
  radius bit for bit equal to `backward_window`'s and its median to
  `np.nanmedian`'s, on all-NaN, single, even, odd, tied, signed-zero,
  infinite and NaN-radius clouds, at W = S and W < S;
- `bucket_model`, `chunk_model` and `walk_model`, the window kernel's list
  (the renderable ids bucketed by the cell of their patch origin, cut into
  chunks of at most 16 points of one cell, a walk block each) and the walk kernel's
  per-point sum in its order (each lane's two columns of a 64-column pair,
  rows ascending, the chosen rows, then the shuffle tree): the rows it skips
  change no sum (bit for bit against the same walk over every row of the
  patch, and against the columns cut to the window), the order in which
  points are walked
  changes none (bit for bit), and the sums agree with the plain version and
  JAX within the tolerance above, NaN where they give NaN.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.rendering.pallas_occ_bwd import occ_backward_pallas_one
from isopoints_tpu.rendering.rasterizer import (
    RasterizationSettings as JSettings,
    _occ_backward_one as j_occ_backward_one,
)
from isopoints_torch.rendering import occ_bwd
from isopoints_torch.rendering.rasterizer import RasterizationSettings
from isopoints_torch.rendering.select import pixel_ndc

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _occ_case(n=600, S=128, seed=0, edge_cluster=False, visible_frac=0.85):
    """tests/test_torch_splat_backward.py's cases: points on a 0.7-sphere
    at depth 2.5, radii 0.01 + 0.02·|N(0,1)|, a sparse cotangent."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(F32)
    v = 0.7 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    if edge_cluster:
        v[: n // 3, 0] = 0.98                    # patches clipped at the border
    pts = np.stack([v[:, 0], v[:, 1], 2.5 + v[:, 2]], -1).astype(F32)
    radii = (np.abs(rng.randn(n, 2)) * 0.02 + 0.01).astype(F32)
    visible = rng.uniform(size=n) < visible_frac
    grad = (rng.randn(S, S) * (rng.uniform(size=(S, S)) < 0.3)).astype(F32)
    return pts, radii, visible, grad


def _assert_occ_close(a, b):
    scale = max(np.nanmax(np.abs(b)), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, rtol=0)


_j_occ_batched = jax.jit(jax.vmap(j_occ_backward_one, in_axes=(0, 0, 0, 0, None)),
                         static_argnums=4)

CASES = [(600, 128, 0, False, True), (600, 128, 7, False, False),
         (600, 128, 3, True, True), (200, 64, 5, False, True),
         (400, 256, 8, True, True)]


@pytest.mark.parametrize("n,S,seed,edge,pallas", CASES)
def test_batched_matches_jax_vmap_and_pallas(n, S, seed, edge, pallas):
    """Two clouds in one call against jax.vmap of the XLA formulation and
    the Pallas kernel cloud by cloud; no kernel launched on the CPU."""
    clouds = [_occ_case(n, S, seed + 100 * i, edge) for i in range(2)]
    batch = [np.stack(a) for a in zip(*clouds)]
    before = occ_bwd.KERNEL.launches
    t = occ_bwd.occ_backward(*(torch.from_numpy(a) for a in batch),
                             RasterizationSettings(image_size=S)).numpy()
    assert occ_bwd.KERNEL.launches == before
    assert t.shape == (2, n, 2) and np.abs(t).max() > 0
    js = JSettings(image_size=S)
    _assert_occ_close(t, np.asarray(_j_occ_batched(*(jnp.asarray(a) for a in batch), js)))
    for i, case in enumerate(clouds):
        one = occ_bwd.occ_backward_one(*(torch.from_numpy(a) for a in case),
                                       RasterizationSettings(image_size=S)).numpy()
        np.testing.assert_array_equal(one, t[i])
        if pallas:
            _assert_occ_close(t[i], np.asarray(occ_backward_pallas_one(
                *(jnp.asarray(a) for a in case), js, interpret=True)))


# ---------------------------------------------------------------------------
# The window kernel: flags, the two middle radii by radix selection, search_r²
# ---------------------------------------------------------------------------

def order_key(r: np.ndarray) -> np.ndarray:
    """The kernel's unsigned keys that order as the floats (no NaN) do;
    −0 maps to +0."""
    u = np.asarray(r, F32).view(np.uint32).copy()
    u[np.asarray(r) == 0] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key_value(k) -> F32:
    k = np.uint32(k)
    u = np.uint32(k & 0x7FFFFFFF) if k & 0x80000000 else np.uint32(~k)
    return np.array(u, np.uint32).view(F32)[()]


def radix_select(keys: np.ndarray, k: int) -> int:
    """The k-th smallest key (1-based) by four rounds of 8-bit radix
    selection over 256-bin histograms (common.cuh radix_pick's rule: the
    first bin whose running count reaches k)."""
    prefix, mask = 0, 0
    for shift in (24, 16, 8, 0):
        sel = keys[(keys.astype(np.int64) & mask) == prefix].astype(np.int64)
        cum = np.cumsum(np.bincount((sel >> shift) & 255, minlength=256))
        b = int(np.searchsorted(cum, k))
        k -= int(cum[b - 1]) if b else 0
        prefix |= b << shift
        mask |= 255 << shift
    return prefix


def window_model(pts, radii, visible, S, W, scaler=10.0):
    """(renderable (P,), the median of the renderable radii as the kernel
    forms it, search_r² float32) as the window kernel computes them."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    with np.errstate(invalid="ignore"):
        ren = visible & (z >= 0) & (np.abs(x) <= 1) & (np.abs(y) <= 1)
    r = radii[ren].reshape(-1)
    keys = order_key(r[~np.isnan(r)])
    n = len(keys)
    mid = F32(np.nan)
    if n:
        lo = key_value(radix_select(keys, (n - 1) // 2 + 1))
        hi = key_value(radix_select(keys, n // 2 + 1))
        with np.errstate(invalid="ignore", over="ignore"):
            mid = F32(F32(lo + hi) * F32(0.5))
    with np.errstate(over="ignore", invalid="ignore"):
        rr = F32(np.nan_to_num(mid, nan=F32(1e-3)) * F32(scaler))
        if W < S:
            cap = F32((W / 2.0 - 2.0) * 2.0 / S)
            rr = cap if rr > cap else rr
        return ren, mid, F32(rr * rr)


def _window_case(name, S, seed=0):
    rng = np.random.RandomState(seed)
    n = 41
    pts = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(1, 3, n)], -1).astype(F32)
    radii = rng.uniform(0.005, 0.05, (n, 2)).astype(F32)
    vis = np.ones(n, bool)
    vis[::7] = False                                   # some points not visible
    pts[3, 2] = -1.0                                   # behind the camera
    pts[5, 0] = 1.5                                    # off the image
    pts[6, 1] = np.nan                                 # not renderable
    radii[~vis] = 1e4                                  # left out with them
    if name == "all NaN":
        radii[:] = np.nan
    elif name == "none renderable":
        vis[:] = False
    elif name == "one value":
        radii[:] = np.nan
        radii[10, 1] = 0.0213
    elif name == "odd count":
        radii[11, 0] = np.nan                          # 2·(renderable) − 1 values
    elif name == "ties":
        radii[:] = rng.choice(np.array([0.01, 0.02, 0.03], F32), (n, 2))
    elif name == "signed zeros":
        radii[:] = rng.choice(np.array([-0.0, 0.0], F32), (n, 2))
        radii[::3, 0] = 0.5
        radii[1::3, 1] = -0.5
    elif name == "+inf":
        radii[: 2 * n // 3] = np.inf                   # the median is +inf
    elif name == "±inf":
        radii[:, 0] = -np.inf
        radii[:, 1] = np.inf                           # (−inf + inf)·0.5 is NaN
    elif name == "NaN radius of a renderable point":
        radii[10] = np.nan
        radii[12, 0] = np.nan
    elif name != "even count":
        raise ValueError(name)
    return pts, radii, vis


WINDOW_CASES = ["even count", "odd count", "all NaN", "none renderable",
                "one value", "ties", "signed zeros", "+inf", "±inf",
                "NaN radius of a renderable point"]


@pytest.mark.parametrize("S", [64, 256])         # W = S, and W = 64 < S
@pytest.mark.parametrize("name", WINDOW_CASES)
def test_window_model_is_backward_window_bit_for_bit(name, S):
    pts, radii, vis = _window_case(name, S, seed=len(name))
    st = RasterizationSettings(image_size=S)
    W = min(st.backward_patch_pixels, S)
    ren, mid, sr2 = window_model(pts, radii, vis, S, W, st.radii_backward_scaler)
    t_ren, t_sr2, t_w = occ_bwd.backward_window(
        *(torch.from_numpy(a) for a in (pts, radii, vis)), st)
    assert t_w == W
    np.testing.assert_array_equal(ren, t_ren.numpy())
    assert np.asarray(sr2).view(np.uint32) == t_sr2.numpy().view(np.uint32), \
        (sr2, float(t_sr2))
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)   # an all-NaN slice
        ref = F32(np.nanmedian(np.where(ren[:, None], radii, np.nan)))
    assert (np.isnan(mid) and np.isnan(ref)) or mid == ref, (mid, ref)


def test_radix_select_picks_every_rank():
    """Both selections on keys with heavy ties, signed values and ±inf,
    against a sort of the keys."""
    rng = np.random.RandomState(3)
    r = rng.choice(np.array([-np.inf, -2.0, -0.0, 0.0, 1e-30, 0.5, 0.5, 3.0,
                             np.inf], F32), 301)
    keys = order_key(r)
    ref = np.sort(keys)
    for k in (1, 2, 150, 151, 300, 301):
        assert radix_select(keys, k) == ref[k - 1]
    np.testing.assert_array_equal(np.sort(r), [key_value(k) for k in ref])


# ---------------------------------------------------------------------------
# The list bucketed by cell, and the walk kernel's per-point sum
# ---------------------------------------------------------------------------

MAX_CELLS = 8192     # csrc/occ_bwd.cu kMaxCells: cells a cloud at most


def cell_layout(S, W, cell=32):
    """(cell side, cells an axis, halo side) as occ_backward sets them."""
    cs = cell
    while ((S - W) // cs + 1) ** 2 > MAX_CELLS:
        cs *= 2
    return cs, (S - W) // cs + 1, min(cs + W - 1, S)


def bucket_model(pts, renderable, S, W):
    """(the renderable ids bucketed by the cell of their patch origin,
    index order inside a cell, (ncell + 1,) offsets)."""
    cs, nca, _ = cell_layout(S, W)
    ids = torch.nonzero(renderable)[:, 0]
    c0 = occ_bwd._patch_origin(pts[ids, 0], S, W)
    r0 = occ_bwd._patch_origin(pts[ids, 1], S, W)
    cell = (r0 // cs) * nca + c0 // cs
    counts = torch.bincount(cell, minlength=nca * nca)
    return ids[torch.argsort(cell, stable=True)], torch.cat(
        [torch.zeros(1, dtype=torch.long), torch.cumsum(counts, 0)])


CHUNK_POINTS = 16    # csrc/occ_bwd.cu kChunk: points a walk block takes at most


def chunk_model(offsets):
    """(cell, first slot) of each chunk the window kernel lists: each cell's
    slots cut into runs of at most CHUNK_POINTS, a walk block each."""
    return [(c, s0) for c in range(len(offsets) - 1)
            for s0 in range(int(offsets[c]), int(offsets[c + 1]), CHUNK_POINTS)]


def walk_model(pts, radii, ids, grad, sr2, S, W, skip=True, cut=False):
    """(len(ids), 2): each point's sum as a warp of the walk kernel forms it,
    in float32: lane l's columns l and l + 32 of each 64-column pair, rows
    ascending, the column term before the next column's; then the shuffle
    tree. With `skip`, the kernel's choice of rows: those out of the
    window, or without a nonzero cotangent in the cell's halo row, or
    outside the splat's y-extent with no cotangent there that is not
    positive, are left out; without it every row is visited. With `cut`,
    the columns whose fl(dx²) exceeds sr2 are left out too."""
    cs, _, hs = cell_layout(S, W)
    px, py, rx, ry = pts[ids, 0], pts[ids, 1], radii[ids, 0], radii[ids, 1]
    c0, r0 = occ_bwd._patch_origin(px, S, W), occ_bwd._patch_origin(py, S, W)
    hc0 = (c0 // cs) * cs
    # each halo row's flags over the cell's halo columns
    hcols = hc0[:, None] + torch.arange(hs)
    in_halo = hcols < S
    gh = grad[(r0[:, None] + torch.arange(W))[:, :, None],
              hcols.clamp(max=S - 1)[:, None, :]]
    nz = ((gh != 0) & in_halo[:, None, :]).any(-1)
    neg = ((gh != 0) & ~(gh > 0) & in_halo[:, None, :]).any(-1)
    n, lane = len(ids), torch.arange(32)
    eps = torch.tensor(1e-10, dtype=torch.float32)
    gx = torch.zeros((n, 32))
    gy = torch.zeros((n, 32))
    for jp in range(0, W, 64):
        cols = []
        for j in (jp + lane, jp + 32 + lane):
            col = c0[:, None] + j
            dx = pixel_ndc(col, S) - px[:, None]
            dx2 = dx * dx
            inn = (j < W)[None, :] & (~(dx2 > sr2) if cut else True)
            cols.append((col.clamp(max=S - 1), dx, dx2, inn, dx.abs() > rx[:, None]))
        for i in range(W):
            row = r0 + i
            dy = pixel_ndc(row, S) - py
            dy2 = dy * dy
            oy = dy.abs() > ry
            take = torch.ones_like(oy)
            if skip:
                take = ~(dy2 > sr2) & nz[:, i] & (neg[:, i] | ~oy)
            for col, dx, dx2, inn, ox in cols:
                g = grad[row[:, None], col]
                dist2 = dx2 + dy2[:, None]
                use = (take[:, None] & inn & (g != 0) & (dist2 <= sr2)
                       & ~((g > 0) & (ox | oy[:, None])))
                denom = torch.maximum(dist2, eps)
                gx = torch.where(use, gx + (dx / denom) * g, gx)
                gy = torch.where(use, gy + (dy[:, None] / denom) * g, gy)
    for o in (16, 8, 4, 2, 1):
        gx, gy = gx[:, :o] + gx[:, o:2 * o], gy[:, :o] + gy[:, o:2 * o]
    return torch.cat([gx, gy], dim=-1)


def _walk_cases():
    pos = _occ_case(600, 128, 2)
    pos = pos[:3] + (np.abs(pos[3]),)                 # the splat frame's kind
    nan = _occ_case(300, 128, 4)
    nan[3][40:44, 50] = np.nan                        # NaN cotangents
    nan[3][60, 70] = np.nan
    return {"sparse signed": _occ_case(600, 128, 0),
            "border cluster": _occ_case(600, 128, 3, True),
            "W = S": _occ_case(200, 64, 5),
            "positive where nonzero": pos,
            "NaN pixels": nan,
            "S = 256": _occ_case(400, 256, 8, True)}


WALK_CASES = _walk_cases()


@functools.lru_cache(maxsize=None)
def _walked(name):
    pts, radii, vis, grad = (torch.from_numpy(a) for a in WALK_CASES[name])
    S = grad.shape[0]
    st = RasterizationSettings(image_size=S)
    ren, sr2, W = occ_bwd.backward_window(pts, radii, vis, st)
    ids, offsets = bucket_model(pts, ren, S, W)
    return pts, radii, vis, grad, st, ren, sr2, W, ids, offsets


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_bucketed_list_covers_each_renderable_point_once(name):
    """The list holds each renderable point once, each cell's patches lie in
    its halo, and the chunks cover the list once, each inside one cell and
    no more than the walk's grid (ceil(P / CHUNK_POINTS) + cells blocks)."""
    pts, _, _, _, st, ren, _, W, ids, offsets = _walked(name)
    S = st.image_size
    cs, nca, hs = cell_layout(S, W)
    assert torch.equal(torch.sort(ids).values, torch.nonzero(ren)[:, 0])
    assert int(offsets[-1]) == int(ren.sum())
    chunks = chunk_model(offsets)
    assert len(chunks) <= -(-pts.shape[0] // CHUNK_POINTS) + nca * nca
    covered = []
    for c, s0 in chunks:
        end = min(s0 + CHUNK_POINTS, int(offsets[c + 1]))
        assert int(offsets[c]) <= s0 < end
        covered += range(s0, end)
    assert covered == list(range(len(ids)))
    c0 = occ_bwd._patch_origin(pts[ids, 0], S, W)
    r0 = occ_bwd._patch_origin(pts[ids, 1], S, W)
    for c in range(nca * nca):
        sl = slice(int(offsets[c]), int(offsets[c + 1]))
        hr0, hc0 = (c // nca) * cs, (c % nca) * cs
        # each patch lies in its cell's halo
        assert bool(((r0[sl] >= hr0) & (r0[sl] + W <= min(hr0 + hs, S))).all())
        assert bool(((c0[sl] >= hc0) & (c0[sl] + W <= min(hc0 + hs, S))).all())


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_walk_skips_and_order_leave_each_sum_unchanged(name):
    pts, radii, _, grad, st, _, sr2, W, ids, _ = _walked(name)
    S = st.image_size
    got = walk_model(pts, radii, ids, grad, sr2, S, W)
    every = walk_model(pts, radii, ids, grad, sr2, S, W, skip=False)
    torch.testing.assert_close(got, every, rtol=0, atol=0, equal_nan=True)
    cut = walk_model(pts, radii, ids, grad, sr2, S, W, cut=True)
    torch.testing.assert_close(got, cut, rtol=0, atol=0, equal_nan=True)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(len(ids)))
    again = walk_model(pts, radii, ids[perm], grad, sr2, S, W)
    torch.testing.assert_close(again, got[perm], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_walk_model_matches_plain_and_jax(name):
    pts, radii, vis, grad, st, _, sr2, W, ids, _ = _walked(name)
    out = torch.zeros((pts.shape[0], 2))
    out[ids] = walk_model(pts, radii, ids, grad, sr2, st.image_size, W)
    plain = occ_bwd.occ_backward_one_plain(pts, radii, vis, grad, st).numpy()
    j = np.asarray(jax.jit(j_occ_backward_one, static_argnums=4)(
        *(jnp.asarray(a.numpy()) for a in (pts, radii, vis, grad)),
        JSettings(image_size=st.image_size)))
    got = out.numpy()
    for ref in (plain, j):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert np.abs(ref[ok]).max() > 0
        _assert_occ_close(np.where(ok, got, 0), np.where(ok, ref, 0))
    if name == "NaN pixels":
        assert np.isnan(got).any()


# ---------------------------------------------------------------------------
# The work the sums need (the bound's count)
# ---------------------------------------------------------------------------

def work_model(pts, radii, grad, ren, sr2, S, W):
    """(terms, nonzero window pixels) of one cloud, point by point in
    float32 numpy: a renderable point's patch pixel with a nonzero
    cotangent and dist² ≤ sr2 is a window pixel, and a term unless its
    cotangent is positive outside the splat's box."""
    inv = F32(1.0 / S)
    terms = window = 0
    for q in np.nonzero(ren)[0]:
        x, y = pts[q, 0], pts[q, 1]
        o = [int(np.clip(np.rint(F32(F32(F32(S) * F32(1 - v)) - 1) * F32(0.5))
                         - W // 2, 0, S - W)) for v in (x, y)]
        idx = np.arange(W)
        dx = (F32(S - 2.0 * (o[0] + idx) - 1) * inv - x).astype(F32)[None, :]
        dy = (F32(S - 2.0 * (o[1] + idx) - 1) * inv - y).astype(F32)[:, None]
        g = grad[o[1]:o[1] + W, o[0]:o[0] + W]
        win = ((dx * dx + dy * dy) <= sr2) & (g != 0)
        outside = (np.abs(dx) > radii[q, 0]) | (np.abs(dy) > radii[q, 1])
        terms += int((win & ~((g > 0) & outside)).sum())
        window += int(win.sum())
    return terms, window


@pytest.mark.parametrize("name", ["sparse signed", "border cluster", "W = S",
                                  "positive where nonzero", "NaN pixels"])
def test_occ_work_counts_terms_and_window_pixels(name):
    """`occ_work` (the bound's count) against a point-by-point count; two
    clouds in one call count as the sum of each; a cotangent that is nowhere
    positive makes every window pixel a term."""
    pts, radii, vis, grad, st, ren, sr2, W, _, _ = _walked(name)
    S = st.image_size
    want = work_model(pts.numpy(), radii.numpy(), grad.numpy(), ren.numpy(),
                      sr2.numpy(), S, W)
    got = occ_bwd.occ_work(pts[None], radii[None], vis[None], grad[None], st)
    assert got == want and 0 < got[0] <= got[1]
    two = occ_bwd.occ_work(torch.stack([pts, pts]), torch.stack([radii, radii]),
                           torch.stack([vis, vis]), torch.stack([grad, -grad.abs()]), st)
    assert two == (got[0] + got[1], 2 * got[1])
    if name == "positive where nonzero":
        assert got[0] < got[1]       # the gate leaves pixels out of the box

