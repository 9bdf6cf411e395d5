"""Port parity: the loss zoo against the JAX package, on the CPU.

The regressions, the SDF losses (SAL, exp, SALD), the cosine and IoU
losses, the RIMLS projection and repulsion regularizers of the DSS point
model (on the kNN's plain version at knn_k 32 on CPU tensors) and the
mesh-supervised `signed_distance_loss`. Inputs are made with numpy from a
seed and handed to both packages.

Tolerances. Values within rtol 1e-5; where `jax.grad` differentiates the
JAX loss, the gradient too: the RIMLS losses' to the points, and
`signed_distance_loss`'s to `sdf` and the points, each element within 1e-5
of max|g| (the same terms summed in another order). The RIMLS losses'
debug taps record the points and the gradient the loss sends them.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.training import losses as JLo
from isopoints_torch import debug
from isopoints_torch.ops import knn
from isopoints_torch.training import losses as TLo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


def _close(t, j, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), rtol=rtol,
                               atol=1e-7)


def _grad_close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * max(np.abs(j).max(), 1e-12))


_RNG = np.random.RandomState(0)
_A = _RNG.randn(2, 50, 3).astype(np.float32)
_B = _RNG.randn(2, 50, 3).astype(np.float32)
_M = _RNG.uniform(size=(2, 50)) < 0.8
_S = _RNG.randn(2, 50).astype(np.float32) * 0.1


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "smape_loss"])
def test_regressions_match_jax(name, reduction):
    jf, tf = getattr(JLo, name), getattr(TLo, name)
    for mask in (None, _M):
        j = jf(J(_A), J(_B), None if mask is None else J(mask), reduction)
        t = tf(T(_A), T(_B), None if mask is None else T(mask), reduction)
        _close(t, j)


@pytest.mark.parametrize("absolute", [True, False])
def test_normal_cos_loss_matches_jax(absolute):
    _close(TLo.normal_cos_loss(T(_A), T(_B), T(_M), absolute=absolute),
           JLo.normal_cos_loss(J(_A), J(_B), J(_M), absolute=absolute))


def test_space_losses_match_jax():
    d = np.abs(_S) ** 2
    _close(TLo.sal_space_loss(T(_S), T(d), T(_M)),
           JLo.sal_space_loss(J(_S), J(d), J(_M)))
    _close(TLo.exp_space_loss(T(_S), 30.0, T(_M)),
           JLo.exp_space_loss(J(_S), 30.0, J(_M)))
    _close(TLo.sald_offnormal_loss(T(_A), T(_B), T(_M)),
           JLo.sald_offnormal_loss(J(_A), J(_B), J(_M)))
    _close(TLo.eikonal_loss(T(_A), T(_M)), JLo.eikonal_loss(J(_A), J(_M)))


def test_iou_loss_matches_jax():
    p = _RNG.uniform(size=(3, 16, 16)).astype(np.float32)
    t = (_RNG.uniform(size=(3, 16, 16)) > 0.5).astype(np.float32)
    for reduction in ("mean", "none"):
        _close(TLo.iou_loss(T(p), T(t), reduction),
               JLo.iou_loss(J(p), J(t), reduction))


def _dss_clouds(seed, n=400):
    """Two noisy spheres with perturbed normals, some points masked."""
    rng = np.random.RandomState(seed)
    v = rng.randn(2, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.5 * v + 0.005 * rng.randn(2, n, 3)).astype(np.float32)
    nrm = (v + 0.1 * rng.randn(2, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, n)) < 0.9
    return pts, nrm, mask


@pytest.mark.parametrize("knn_k", [32, 8])
@pytest.mark.parametrize("name,tap", [("projection_loss", "proj"),
                                      ("repulsion_loss", "repel")])
def test_rimls_losses_match_jax(name, tap, knn_k):
    pts, nrm, mask = _dss_clouds(1)
    jf, tf = getattr(JLo, name), getattr(TLo, name)
    jv, jg = jax.value_and_grad(
        lambda p: jf(p, J(nrm), J(mask), knn_k=knn_k))(J(pts))
    tp = T(pts).requires_grad_(True)
    debug.set_debugging_mode_(True)
    try:
        tv = tf(tp, T(nrm), T(mask), knn_k=knn_k)
        tv.backward()
        tapped = debug.get_debugging_tensor().pts_world_grad[tap]
    finally:
        debug.set_debugging_mode_(False)
    _close(tv, jv)
    _grad_close(tp.grad, jg)
    assert torch.equal(tapped, tp.grad)
    assert float(tp.grad.abs().max()) > 0
    assert knn.KERNEL.launches == 0


def _box_mesh():
    v = np.array(list(itertools.product([-0.5, 0.5], repeat=3)), np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


@pytest.mark.parametrize("scale,face_chunk", [(1.0, 5), (1.0, 2048), (4.0, 5)])
def test_signed_distance_loss_matches_jax(scale, face_chunk):
    """A closed box, points in and around it; `scale` 4 puts the mesh past
    the default anchors, which the loss then scales out."""
    v, f = _box_mesh()
    v = v * scale
    rng = np.random.RandomState(2)
    p = (rng.uniform(-0.8, 0.8, (300, 3)) * scale).astype(np.float32)
    sdf = (rng.uniform(-0.1, 0.1, 300) * scale).astype(np.float32)
    mask = rng.uniform(size=300) < 0.9
    jv, (jgp, jgs) = jax.value_and_grad(
        lambda a, b: JLo.signed_distance_loss(a, b, J(v), J(f), J(mask),
                                              face_chunk=face_chunk),
        argnums=(0, 1))(J(p), J(sdf))
    tp, ts = T(p).requires_grad_(True), T(sdf).requires_grad_(True)
    tv = TLo.signed_distance_loss(tp, ts, T(v), T(f), T(mask),
                                  face_chunk=face_chunk)
    tv.backward()
    _close(tv, jv)
    _grad_close(tp.grad, jgp)
    _grad_close(ts.grad, jgs)
    # the magnitude: the distance to the box
    per = TLo.signed_distance_loss(T(p), torch.zeros(300), T(v), T(f),
                                   reduction="none")
    q = np.abs(p.astype(np.float64)) - 0.5 * scale
    d_box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
             + np.minimum(q.max(axis=-1), 0.0))         # the box's exact SDF
    far = np.abs(d_box) > 1e-3 * scale
    np.testing.assert_allclose(np.sqrt(per.numpy())[far], np.abs(d_box)[far],
                               rtol=1e-4, atol=1e-6)
    assert (d_box < -1e-3 * scale).sum() > 10
    # the sign: the loss against the exact SDF vanishes (negative inside)
    per = TLo.signed_distance_loss(T(p), T(d_box.astype(np.float32)), T(v),
                                   T(f), reduction="none")
    assert np.sqrt(per.numpy())[far].max() < 1e-4 * scale
