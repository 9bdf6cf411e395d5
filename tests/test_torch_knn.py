"""Port parity: exact masked kNN and midpoint upsampling against the JAX
package, on the CPU.

The port's kNN on a CPU tensor is its plain version (the dense path); the
JAX side runs its dense path and its Pallas kernel (interpret mode on the
CPU). Inputs are made with numpy from a seed and handed to both.

Tolerances. kNN, on clouds at the iso-points' scale (the cube of side 1.5
the buffers start in, |p|² ≤ 1.7): masks equal; squared distances within
1e-6; indices equal except at near-ties, where two neighbours' distances
differ by less than 1e-6 (the packages round the |q|² + |p|² − 2q·p
expansion in different orders, ~1e-7 at this scale, as
tests/test_pallas_knn.py allows between the JAX paths).
midpoint_upsample: identical to JAX's, slot by slot and bit for bit. The
port rounds the clearances as XLA's CPU build of the JAX function does
(mid − nn with x after rounding mid and y, z as one fma each, the squares
as an fma chain, a correctly rounded root); with PyTorch's own rounding
two near-equal clearances swapped after a few rounds and every later
insert landed one slot off (60% of the slots equal at 6000 points, k 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.ops.neighbors import knn_gather as j_knn_gather
from isopoints_tpu.ops.neighbors import knn_points as j_knn_points
from isopoints_tpu.ops.pallas_knn import knn_points_pallas
from isopoints_tpu.ops.points import midpoint_upsample as j_midpoint_upsample
from isopoints_torch.ops import knn
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.points import midpoint_upsample
from isopoints_torch.utils import top_k


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(seed, b=2, n=300, p=700, frac=0.9):
    rng = np.random.RandomState(seed)
    # iso-point scale: inside the cube of side 1.5 the clouds live in
    q = rng.uniform(-0.75, 0.75, (b, n, 3)).astype(np.float32)
    pts = rng.uniform(-0.75, 0.75, (b, p, 3)).astype(np.float32)
    qm = rng.uniform(size=(b, n)) < frac
    pm = rng.uniform(size=(b, p)) < frac
    return q, pts, qm, pm


def _assert_same_knn(t_res, j_res, tol=1e-6):
    td, jd = t_res.dists.numpy(), np.asarray(j_res.dists)
    np.testing.assert_array_equal(t_res.mask.numpy(), np.asarray(j_res.mask))
    np.testing.assert_allclose(td, jd, atol=tol, rtol=0)
    ti, ji = t_res.idx.numpy(), np.asarray(j_res.idx)
    diff = ti != ji
    assert np.abs(td[diff] - jd[diff]).max(initial=0.0) < tol, \
        "index mismatch at non-tied distances"


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("k,exclude_self", [(6, True), (8, False),
                                            (16, True), (20, False),
                                            (17, True), (24, False),
                                            (31, True), (32, True),
                                            (32, False)])
def test_knn_matches_jax_dense(k, exclude_self):
    q, pts, qm, pm = _clouds(k)
    if exclude_self:
        q, qm = pts, pm
    j_res = j_knn_points(*_jax(q, pts, qm, pm), k=k, exclude_self=exclude_self,
                         method="dense")
    t_res = knn_points(*(torch.from_numpy(a) for a in (q, pts, qm, pm)), k=k,
                       exclude_self=exclude_self)
    assert t_res.idx.dtype == torch.int64
    _assert_same_knn(t_res, j_res)
    assert knn.KERNEL.launches == 0  # CPU tensors take the plain version


def test_knn_matches_jax_pallas_kernel():
    _, pts, _, pm = _clouds(3, b=1, p=2500)
    j_res = knn_points_pallas(*_jax(pts, pts, pm, pm), k=8, exclude_self=True)
    t_res = knn_points(*(torch.from_numpy(a) for a in (pts, pts, pm, pm)),
                       k=8, exclude_self=True)
    _assert_same_knn(t_res, j_res)


def test_knn_k_exceeds_points_and_duplicates():
    rng = np.random.RandomState(9)
    pts = rng.randn(1, 4, 3).astype(np.float32)
    pts[0, 2] = pts[0, 0]                       # a coincident pair
    q = rng.randn(1, 5, 3).astype(np.float32)
    q[0, 1] = pts[0, 0]
    for method in ("auto", "dense"):
        t_res = knn_points(torch.from_numpy(q), torch.from_numpy(pts), k=6,
                           method=method)
        j_res = j_knn_points(*_jax(q, pts), k=6, method="dense")
        np.testing.assert_array_equal(t_res.idx.numpy(), np.asarray(j_res.idx))
        np.testing.assert_array_equal(t_res.mask.numpy(), np.asarray(j_res.mask))
    # the lower index of the coincident pair comes first
    assert t_res.idx[0, 1, :2].tolist() == [0, 2]


def test_knn_gather_matches_jax():
    _, pts, _, pm = _clouds(4, b=2, p=50)
    idx = np.random.RandomState(5).randint(-1, 50, size=(2, 7, 4))
    ref = np.asarray(j_knn_gather(jnp.asarray(pts), jnp.asarray(idx), fill=-3.0))
    out = knn_gather(torch.from_numpy(pts), torch.from_numpy(idx), fill=-3.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_knn_rejects_unknown_method():
    x = torch.zeros(1, 3, 3)
    with pytest.raises(ValueError):
        knn_points(x, x, method="grid")


def test_top_k_keeps_lax_tie_order():
    x = np.array([[0.5, -1.0, 0.5, 0.9, -1.0, 0.5]], np.float32)
    vals, idx = top_k(torch.from_numpy(x), 5)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def _sphere_seed(seed, n, cap, frac):
    rng = np.random.RandomState(seed)
    v = rng.randn(1, n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.5 * v).astype(np.float32)
    mask = rng.uniform(size=(1, n)) < frac
    return pts, mask


@pytest.mark.parametrize("n,cap,k", [(40, 256, 8), (300, 512, 16),
                                     (100, 100, 8), (160, 1200, 8),
                                     (500, 3000, 8)])
def test_midpoint_upsample_matches_jax(n, cap, k):
    pts, mask = _sphere_seed(n + cap, n, cap, 0.8)
    j_pts, j_mask = j_midpoint_upsample(jnp.asarray(pts), jnp.asarray(mask),
                                        cap, neighborhood_size=k)
    t_pts, t_mask = midpoint_upsample(torch.from_numpy(pts),
                                      torch.from_numpy(mask), cap,
                                      neighborhood_size=k)
    j_pts, j_mask = np.asarray(j_pts), np.asarray(j_mask)
    t_pts, t_mask = t_pts.numpy(), t_mask.numpy()
    assert t_pts.shape == (1, cap, 3)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_pts, j_pts)
    # the seeds come first, front-compacted, and are kept unchanged
    n_seed = int(mask.sum())
    np.testing.assert_array_equal(t_pts[0, :n_seed], pts[0][mask[0]])


def test_midpoint_upsample_refuses_wide_seed():
    pts = torch.zeros(1, 10, 3)
    with pytest.raises(ValueError, match="exceeds target capacity"):
        midpoint_upsample(pts, torch.ones(1, 10, dtype=torch.bool), 8)
