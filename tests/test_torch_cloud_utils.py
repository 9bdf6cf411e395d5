"""Port parity: the padded point cloud, its filters, the tensor utilities,
the fields' output heads and latent codes, the factory's dotted decoder
path and the misc thread helper, against the JAX package on the CPU.

`PointCloud` (capacity, lengths, with_*, compact, normalize_to_sphere,
subsample_randomly on JAX's own uniform draws), `PointCloudFilters`, the
masking helpers of `utils`, `scaler_to_color` (the port carries
matplotlib's "jet" table; the JAX package asks matplotlib), the image grid,
`get_class_from_string`, `slice_dict`; `SirenField`, `SDFField` and
`RenderingNetwork` with other `out_dims` heads, output activations and a
latent code, from JAX's initial parameters carried across by `convert`;
`TimedThread` and `run_async`.

Tolerances: exact for masks, counts, orders and the colour map; float
results within 1e-6 (one float32 operation apart); the fields' heads
within 1e-5 (sums of 64-wide products in another order; ω = 30 sines).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu import utils as JU
from isopoints_tpu.core.cloud import PointCloud as JCloud
from isopoints_tpu.core.cloud import PointCloudFilters as JFilters
from isopoints_tpu.models import fields as JF
from isopoints_torch import misc, utils as TU
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.cloud import PointCloud, PointCloudFilters
from isopoints_torch.models import fields as TF
from isopoints_torch.models.fields import FieldOutput


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

_RNG = np.random.RandomState(0)
_P = _RNG.randn(2, 40, 3).astype(np.float32)
_N = _RNG.randn(2, 40, 3).astype(np.float32)
_F = _RNG.uniform(size=(2, 40, 4)).astype(np.float32)
_M = _RNG.uniform(size=(2, 40)) < 0.6


def _clouds():
    return (JCloud.create(J(_P), J(_N), J(_F), J(_M)),
            PointCloud.create(T(_P), T(_N), T(_F), T(_M)))


def _same(t, j, atol=0.0):
    if j is None:
        assert t is None
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _same_cloud(t, j, atol=0.0):
    for name in ("points", "mask", "normals", "features"):
        _same(getattr(t, name), getattr(j, name), atol)


def test_cloud_structure_matches_jax():
    j, t = _clouds()
    assert t.capacity == j.capacity == 40
    _same(t.lengths(), j.lengths())
    _same_cloud(t.compact(), j.compact())
    _same_cloud(t.with_points(T(_N)), j.with_points(J(_N)))
    _same_cloud(t.with_normals(T(_P)), j.with_normals(J(_P)))
    _same_cloud(t.with_mask(T(~_M)), j.with_mask(J(~_M)))
    # a cloud without normals or features compacts too
    jc = JCloud.create(J(_P), mask=J(_M)).compact()
    tc = PointCloud.create(T(_P), mask=T(_M)).compact()
    _same_cloud(tc, jc)


@pytest.mark.parametrize("radius", [1.0, 0.5])
def test_normalize_to_sphere_matches_jax(radius):
    j, t = _clouds()
    jc, jcen, jsc = j.normalize_to_sphere(radius)
    tc, tcen, tsc = t.normalize_to_sphere(radius)
    _same(tcen, jcen, 1e-6)
    _same(tsc, jsc, 1e-6)
    _same_cloud(tc, jc, 1e-6)
    r = np.linalg.norm(tc.points.numpy(), axis=-1)[_M]
    assert r.max() <= radius * (1 + 1e-6)


def test_subsample_randomly_matches_jax():
    j, t = _clouds()
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, _M.shape))
    _same_cloud(t.subsample_randomly(0.5, u=T(u)), j.subsample_randomly(key, 0.5))
    g = torch.Generator().manual_seed(0)
    sub = t.subsample_randomly(0.5, generator=g)
    assert 0 < int(sub.lengths().sum()) < int(t.lengths().sum())


def test_filters_match_jax():
    j, t = _clouds()
    rng = np.random.RandomState(1)
    masks = [rng.uniform(size=_M.shape) < 0.7 for _ in range(3)]
    for keep in ((0, 1, 2), (0,), (), (1, 2)):
        kw = {name: masks[i] for i, name in enumerate(("inmask", "activation",
                                                        "visibility")) if i in keep}
        jf = JFilters(**{k: J(v) for k, v in kw.items()})
        tf = PointCloudFilters(**{k: T(v) for k, v in kw.items()})
        _same(tf.combined(T(_M)), jf.combined(J(_M)))
        _same_cloud(tf.filter_cloud(t), jf.filter_cloud(j))


def test_masking_helpers_match_jax():
    lengths = np.array([3, 0, 7])
    _same(TU.lengths_to_mask(T(lengths), 7), JU.lengths_to_mask(J(lengths), 7))
    _same(TU.mask_to_lengths(T(_M)), JU.mask_to_lengths(J(_M)))
    _same(TU.num_valid(T(_M)), JU.num_valid(J(_M)))
    for axis, keep in ((None, False), (1, False), (1, True), (-2, True)):
        _same(TU.masked_mean(T(_P), T(_M), axis, keep),
              JU.masked_mean(J(_P), J(_M), axis, keep), 1e-6)
        _same(TU.masked_sum(T(_P), T(_M), axis, keep),
              JU.masked_sum(J(_P), J(_M), axis, keep), 1e-5)
    for a, b in zip(TU.compact_padded(T(_P), T(_M)), JU.compact_padded(J(_P), J(_M))):
        _same(a, b)
    idx = np.array([[0, 5, -1], [39, -3, 2]])
    _same(TU.gather_padded(T(_P), T(idx)), JU.gather_padded(J(_P), J(idx)))
    for new_p in (40, 50, 10):
        for a, b in zip(TU.resize_padded(T(_P), T(_M), new_p),
                        JU.resize_padded(J(_P), J(_M), new_p)):
            _same(a, b)
    x = np.array([1.0, np.inf, -np.inf, np.nan, 0.0], np.float32)
    _same(TU.valid_value_mask(T(x)), JU.valid_value_mask(J(x)))
    d = {"a": T(_P), "b": None}
    out = TU.slice_dict(d, 1)
    assert out["b"] is None and torch.equal(out["a"], T(_P)[1])


@pytest.mark.parametrize("case", ["normal", "constant", "nan", "tiny range"])
def test_scaler_to_color_matches_matplotlib(case):
    x = np.random.RandomState(2).randn(3000)
    if case == "constant":
        x = np.full(50, 2.5)
    elif case == "nan":
        x[::7] = np.nan
    elif case == "tiny range":
        x = 1.0 + 1e-9 * x
    np.testing.assert_array_equal(TU.scaler_to_color(x), JU.scaler_to_color(x))
    with pytest.raises(ValueError, match="jet"):
        TU.scaler_to_color(x, cmap="viridis")


def test_make_image_grid_matches_jax():
    rng = np.random.RandomState(3)
    ims = [rng.uniform(size=(8, 6, 3)).astype(np.float32),
           rng.uniform(size=(5, 6)).astype(np.float32),
           rng.uniform(size=(8, 4, 4)).astype(np.float32)]
    for ncols, pad in ((2, 2), (4, 0), (1, 3)):
        np.testing.assert_array_equal(TU.make_image_grid(ims, ncols, pad),
                                      JU.make_image_grid(ims, ncols, pad))


def test_get_class_from_string():
    assert TU.get_class_from_string("isopoints_torch.models.fields.SDFField") is TF.SDFField
    # a path written for the JAX package names the port's class
    assert TU.get_class_from_string("isopoints_tpu.models.fields.SirenField") is TF.SirenField
    for bad in ("numpy.ndarray", "isopoints_torch.models.fields.NoSuch",
                "isopoints_torch.nosuch.Thing", "isopoints_torch.models.fields.sdf_and_grad"):
        with pytest.raises(ValueError):
            TU.get_class_from_string(bad)


def _convert(jfield, tfield, seed):
    params = jfield.init(jax.random.key(seed))
    sd = params_from_jax({"m": jax.tree.map(np.asarray, params)},
                         keep_weight_norm=True)
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return params


def _same_heads(t: FieldOutput, j, atol=1e-5):
    for name in ("sdf", "latent", "rgb", "occupancy"):
        _same(None if getattr(t, name) is None else getattr(t, name).detach(),
              getattr(j, name), atol)


_HEADS = {"sdf": 1, "latent": 4, "rgb": 3}


@pytest.mark.parametrize("kw", [
    dict(out_dims=_HEADS),
    dict(out_dims={"rgb": 3, "sdf": 1}, activation="tanh"),
    dict(out_dims=_HEADS, activation="sigmoid", outermost_linear=False),
    dict(c_dim=5), dict(dim=2)],
    ids=["heads", "tanh", "sigmoid-sine-head", "latent-code", "2d-points"])
def test_siren_heads_match_jax(kw):
    jf = JF.SirenField(hidden_size=64, n_layers=2, **kw)
    tf = TF.SirenField(hidden_size=64, n_layers=2, device="cpu", **kw)
    params = _convert(jf, tf, 1)
    x = np.random.RandomState(4).uniform(-0.7, 0.7, (50, kw.get("dim", 3))).astype(
        np.float32)
    c = np.random.RandomState(5).randn(50, 5).astype(np.float32) * 0.1
    jc, tc = (J(c), T(c)) if kw.get("c_dim") else (None, None)
    _same_heads(tf.heads(T(x), tc), jf.apply(params, J(x), jc))
    _same(tf.sdf(T(x), tc).detach(), jf.sdf(params, J(x), jc), 1e-5)
    assert tf.sdf_only is False
    assert tf.layers[0].weight.shape[1] == kw.get("dim", 3) + kw.get("c_dim", 0)
    from isopoints_torch.ops import fused_mlp
    assert fused_mlp.make_fused_sdf_fn(tf) is None       # no kernel: plain field
    with pytest.raises(ValueError, match="SDF head alone"):
        fused_mlp.make_fused_siren_sdf(tf)


def test_sdf_field_heads_match_jax():
    kw = dict(hidden_size=48, n_layers=3, skip_in=(2,), num_frequencies=2,
              out_dims={"sdf": 1, "rgb": 3})
    jf, tf = JF.SDFField(**kw), TF.SDFField(device="cpu", **kw)
    params = _convert(jf, tf, 2)
    x = np.random.RandomState(6).uniform(-0.7, 0.7, (50, 3)).astype(np.float32)
    _same_heads(tf.heads(T(x)), jf.apply(params, J(x)))
    _same(tf(T(x)).detach(), jf.sdf(params, J(x)), 1e-5)


@pytest.mark.parametrize("kw", [dict(c_dim=6), dict(c_dim=0, out_dims={"rgb": 3, "latent": 2})],
                         ids=["latent-code", "heads"])
def test_rendering_network_heads_match_jax(kw):
    jn = JF.RenderingNetwork(dim=9, hidden_size=32, n_layers=2, **kw)
    tn = TF.RenderingNetwork(dim=9, hidden_size=32, n_layers=2, device="cpu", **kw)
    params = _convert(jn, tn, 3)
    rng = np.random.RandomState(7)
    nrm, pts, view = (rng.randn(20, 3).astype(np.float32) for _ in range(3))
    c = rng.randn(20, kw.get("c_dim", 0)).astype(np.float32)
    jc, tc = (J(c), T(c)) if kw.get("c_dim") else (None, None)
    j_rgb = jn.apply_with_view(params, J(nrm), J(pts), J(view), jc).rgb
    _same(tn.apply_with_view(T(nrm), T(pts), T(view), tc).detach(), j_rgb, 1e-5)
    x = np.concatenate([nrm, pts, np.asarray(jn.embed_view(J(view)))], -1)
    _same_heads(tn.heads(T(x), tc), jn.apply(params, J(x), jc))


def test_timed_thread_and_run_async():
    out, done = [], threading.Event()

    def task(a, b=0):
        out.append(a + b)
        done.set()

    t = misc.run_async(task, 2, b=3)
    t.join(10)
    assert done.is_set() and out == [5] and isinstance(t, misc.TimedThread)
    assert t.daemon

    def boom():
        raise RuntimeError("no")

    t = misc.TimedThread(boom, name="boom")   # logged, never raised
    t.start()
    t.join(10)
    assert not t.is_alive()
