"""Port parity: the DVR pieces (isopoints_torch/models/raytracing.py
`sphere_trace_along_rays`, `find_zero_crossing_between_point_pairs`, and
`ImplicitModel.pixels_to_world`) against the JAX package's, on the CPU, on
a SIREN 2x64 converted from JAX parameters.

- `sphere_trace_along_rays` from points inside and outside the padded
  sphere, with a mask: converged masks equal; points and final values
  within 1e-5 (float32 round-off of two summation orders of the MLP,
  carried through up to 10 steps); the gradient at the first iterate
  within 1e-4 (ω = 30 amplifies the MLP's round-off in its derivative).
- `find_zero_crossing_between_point_pairs` in the SDF convention, with and
  without `allow_in_to_out`, and in the occupancy one (logits = −10·sdf):
  masks equal, points within 1e-5; the ones fill where there is no
  crossing exactly; the sweep in chunks of rays bit for bit against one
  chunk.
- `pixels_to_world` with `training` False and True, on the plain field
  and on the fused callable (its plain version here), against JAX on the
  plain field: masks equal on at least 99% of rays (a ray whose sphere
  trace ends within round-off of the tolerance, or whose normal is within
  round-off of the grazing bound, may flip), points within 1e-4 where both
  hit; in training the points carry θ-gradients to the decoder.
- `sample_world_points` (JAX's tests/test_models.py:107-116 on the port,
  and the port against JAX) at `n_points_per_ray` 100 and 37, on the plain
  field and on the fused callable, with and without `mask_pred`: the free
  and occupancy masks equal exactly; the picks equal (points within 1e-6,
  the rays' camera centres and directions round differently by ~1e-7),
  except where the two picks' SDF values lie within 1e-6 of each other (a
  tie); the pick stays differentiable in the camera and carries no
  gradient to the decoder.
- `decode` (every head within 1e-6) and `get_point_clouds` with and
  without projection: masks equal, points within 1e-5, normals within
  1e-4 (ω = 30, as above); the projected points carry θ-gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.models import raytracing as jrt
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.implicit import ImplicitConfig as JCfg
from isopoints_tpu.models.implicit import ImplicitModel as JModel
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import PerspectiveCamera as TCam
from isopoints_torch.models import raytracing as trt
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.implicit import ImplicitConfig, ImplicitModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def field():
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(3))
    tfield = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    jf = lambda x: jfield.sdf(params, x)
    return jfield, params, tfield, jf


def test_sphere_trace_along_rays(field):
    _, _, tfield, jf = field
    rng = np.random.RandomState(0)
    ray0 = rng.uniform(-1.2, 1.2, (2, 300, 3)).astype(np.float32)
    dirs = rng.normal(size=(2, 300, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 300)) < 0.8
    j = jrt.sphere_trace_along_rays(jf, jnp.asarray(ray0), jnp.asarray(dirs),
                                    jnp.asarray(mask))
    t = trt.sphere_trace_along_rays(tfield.sdf, torch.tensor(ray0), torch.tensor(dirs),
                                    torch.tensor(mask))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5)
    np.testing.assert_allclose(t.sdf.numpy(), np.asarray(j.sdf), atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad), atol=1e-4)
    assert 0 < int(t.mask.sum()) < int(mask.sum())
    # points outside the padded sphere never move
    out = np.linalg.norm(ray0, axis=-1) >= 1.1
    np.testing.assert_array_equal(t.points.numpy()[out], ray0[out])


def segments(seed=1, n=400):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(0, 0.6, p0.shape)).astype(np.float32)
    return p0, p1


@pytest.mark.parametrize("mode", ["sdf", "in_to_out", "occupancy"])
def test_zero_crossing(field, mode):
    _, _, tfield, jf = field
    p0, p1 = segments()
    kw = dict(is_occupancy=mode == "occupancy", allow_in_to_out=mode == "in_to_out")
    if mode == "occupancy":
        jfn, tfn = (lambda x: -10.0 * jf(x)), (lambda x: -10.0 * tfield.sdf(x))
    else:
        jfn, tfn = jf, tfield.sdf
    jp, jm = jrt.find_zero_crossing_between_point_pairs(jfn, jnp.asarray(p0),
                                                        jnp.asarray(p1), **kw)
    tp, tm = trt.find_zero_crossing_between_point_pairs(tfn, torch.tensor(p0),
                                                        torch.tensor(p1), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert 0.1 < tm.float().mean() < 0.95
    np.testing.assert_array_equal(tp.numpy()[~tm.numpy()], 1.0)
    # the sweep in chunks of 37 segments gives the same values
    tp2, tm2 = trt.find_zero_crossing_between_point_pairs(
        tfn, torch.tensor(p0), torch.tensor(p1), chunk_rays=37, **kw)
    assert torch.equal(tp2, tp) and torch.equal(tm2, tm)


def cameras():
    R, T = j_look_at([2.0, 2.2], [15.0, -30.0], [40.0, 210.0])
    return (JCam.create(R=R, T=T, focal_length=1.6),
            TCam.create(R=torch.tensor(np.asarray(R)), T=torch.tensor(np.asarray(T)),
                        focal_length=1.6, device="cpu"))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_pixels_to_world(field, fused, training):
    jfield, params, tfield, _ = field
    jcam, tcam = cameras()
    ndc = np.random.RandomState(2).uniform(-0.7, 0.7, (2, 500, 2)).astype(np.float32)
    jm = JModel(jfield, cfg=JCfg())
    jp, jmask = jm.pixels_to_world({"decoder": params}, jnp.asarray(ndc), jcam,
                                   training=training)
    tm = ImplicitModel(tfield, ImplicitConfig(use_fused_mlp=fused))
    tp, tmask = tm.pixels_to_world(torch.tensor(ndc), tcam, training=training)
    jmask, jp = np.asarray(jmask), np.asarray(jp)
    agree = tmask.numpy() == jmask
    assert agree.mean() >= 0.99
    both = tmask.numpy() & jmask
    assert both.sum() > 100
    np.testing.assert_allclose(tp.detach().numpy()[both], jp[both], atol=1e-4)
    if training:
        tp[tmask].sum().backward()
        g = tfield.layers[0].weight.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
        tfield.zero_grad()
    else:
        assert not tp.requires_grad


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("n,with_pred", [(100, False), (37, True)])
def test_sample_world_points(field, fused, n, with_pred):
    jfield, params, tfield, _ = field
    jcam, tcam = cameras()
    rng = np.random.RandomState(6)
    ndc = rng.uniform(-1.15, 1.15, (2, 300, 2)).astype(np.float32)
    mask_gt = rng.uniform(size=(2, 300)) < 0.5
    pred = rng.uniform(size=(2, 300)) < 0.3 if with_pred else None
    jp, jfree, jocc = JModel(jfield, cfg=JCfg(n_points_per_ray=n)).sample_world_points(
        {"decoder": params}, jnp.asarray(ndc), jcam, jnp.asarray(mask_gt),
        None if pred is None else jnp.asarray(pred))
    tm = ImplicitModel(tfield, ImplicitConfig(n_points_per_ray=n,
                                              use_fused_mlp=fused))
    tp, tfree, tocc = tm.sample_world_points(
        torch.tensor(ndc), tcam, torch.tensor(mask_gt),
        None if pred is None else torch.tensor(pred))
    np.testing.assert_array_equal(tfree.numpy(), np.asarray(jfree))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    assert tfree.sum() > 50 and tocc.sum() > 30
    assert (~tfree & ~tocc).sum() > 20        # rays out of the image or the cube
    jp = np.asarray(jp)
    differ = np.abs(tp.numpy() - jp).max(-1) > 1e-6
    assert differ.mean() <= 0.02
    with torch.no_grad():
        f_t, f_j = tfield.sdf(tp[differ]), tfield.sdf(torch.tensor(jp[differ]))
    np.testing.assert_allclose(f_t.numpy(), f_j.numpy(), atol=1e-6, rtol=0)
    assert not tp.requires_grad


def test_sample_world_points_min_sdf_and_camera_gradient(field):
    """JAX's test_sample_world_points_min_sdf on the port (an 8x8 pixel
    grid, no mask): the min-SDF candidates of the free rays reach below
    0.1; and the picks stay differentiable in the camera only."""
    from isopoints_torch.ops.images import arange_pixels
    _, _, tfield, _ = field
    _, tcam = cameras()
    _, ndc = arange_pixels((8, 8), 2)
    tm = ImplicitModel(tfield, ImplicitConfig())
    pts, free_m, occ_m = tm.sample_world_points(
        ndc, tcam, torch.zeros(ndc.shape[:2], dtype=torch.bool))
    assert not occ_m.any() and free_m.sum() > 0
    with torch.no_grad():
        assert float(tfield.sdf(pts)[free_m].min()) < 0.1
    T = tcam.T.clone().requires_grad_(True)
    import dataclasses
    pts, _, _ = tm.sample_world_points(
        ndc, dataclasses.replace(tcam, T=T),
        torch.zeros(ndc.shape[:2], dtype=torch.bool))
    pts.sum().backward()
    assert T.grad is not None and torch.isfinite(T.grad).all() and T.grad.abs().sum() > 0
    assert all(p.grad is None for p in tfield.parameters())


def test_decode_and_get_point_clouds(field):
    jfield, params, tfield, _ = field
    rng = np.random.RandomState(7)
    pts = rng.uniform(-0.8, 0.8, (2, 200, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 200)) < 0.9
    jm, tm = JModel(jfield, cfg=JCfg()), ImplicitModel(tfield, ImplicitConfig())
    jd, td = jm.decode({"decoder": params}, jnp.asarray(pts)), tm.decode(torch.tensor(pts))
    assert td._fields == jd._fields
    for name in jd._fields:
        if getattr(jd, name) is None:
            assert getattr(td, name) is None
        else:
            np.testing.assert_allclose(getattr(td, name).detach().numpy(),
                                       np.asarray(getattr(jd, name)), atol=1e-6)
    for project in (False, True):
        jp, jn, jmk = jm.get_point_clouds({"decoder": params}, jnp.asarray(pts),
                                          jnp.asarray(mask), do_project=project)
        tp, tn, tmk = tm.get_point_clouds(torch.tensor(pts), torch.tensor(mask),
                                          do_project=project)
        np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), atol=1e-4)
        assert tp.requires_grad == project
    assert 0.5 < tmk.float().mean() < 1.0
    tp[tmk].sum().backward()
    g = tfield.layers[0].weight.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    tfield.zero_grad()
    tp, _, _ = tm.get_point_clouds(torch.tensor(pts), torch.tensor(mask),
                                   do_project=True, attach_gradient=False)
    assert not tp.requires_grad
