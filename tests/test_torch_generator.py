"""Port parity: generation (isopoints_torch/models/generator.py, ops/imls.py,
`PointModel.generate_mesh`) against the JAX package, on the CPU.

A small SIREN (2 x 32) from JAX's init, converted. The port runs the model
with `use_fused_mlp` (on the CPU the fused callable's plain version); the
JAX side runs its plain field, which its own tests hold to its kernel.

- `generate_mesh` (one stage at 32³): grid values within 2e-6 (two float32
  evaluations of the same SIREN), face counts and faces equal, vertices
  within 1e-5 (the grid's difference over the slope at each crossing).
- `refine_mesh`, 5 RMSprop steps on 1500 vertices: within 1e-5 (optax's
  update, the second derivative of the field through autograd).
- `estimate_normals`: within 1e-5 of JAX's unit gradients.
- `raytrace_images`, 2 views x 24 px in chunks of 128 rays (the last one
  padded): alpha equal on >= 99% of the pixels, RGB within 1e-4 where both
  hit; also the neural texture.
- `generate_iso_contour` at plot_cuts' defaults (3 axes x 3 cuts x 100²)
  against JAX's: both payloads (the fallback HTML of misc/visualize.py)
  trace by trace, SDF values within 1e-5, the grids within 1e-6;
  `generate_mvr --iso-contours` writes iso_contour.html, held the same way
  against JAX's generator on the checkpoint's parameters.
- `imls_sdf` on 300 oriented points, k = 8: within 1e-6; `PointModel.
  generate_mesh` at 24³ against JAX's on the same cloud: faces equal,
  vertices within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import RenderingNetwork as JRenderNet
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.generator import Generator as JGen
from isopoints_tpu.models.generator import GeneratorConfig as JGC
from isopoints_tpu.models.implicit import ImplicitConfig as JIC
from isopoints_tpu.models.point import PointModel as JPointModel
from isopoints_tpu.models.point import PointModelConfig as JPointConfig
from isopoints_tpu.ops import imls as j_imls
from isopoints_tpu.utils import meshing as jmesh
from isopoints_torch.convert import params_from_jax, point_params_from_jax
from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
from isopoints_torch.models.combined import CombinedModel
from isopoints_torch.models.fields import RenderingNetwork, SirenField
from isopoints_torch.models.generator import Generator, GeneratorConfig
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.models.point import PointModel, PointModelConfig
from isopoints_torch.ops import imls
from isopoints_torch.utils import meshing as tmesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(texture="lighting"):
    neural = texture == "neural"
    jm = JCombined(JSiren(hidden_size=32, n_layers=2),
                   cfg=JIC(texture_type=texture),
                   rendering_net=JRenderNet(dim=9, c_dim=0, hidden_size=32,
                                            n_layers=2) if neural else None)
    params = jm.init(jax.random.key(0))
    tm = CombinedModel(
        SirenField(hidden_size=32, n_layers=2, device="cpu"),
        ImplicitConfig(use_fused_mlp=True, texture_type=texture),
        rendering_net=RenderingNetwork(dim=9, c_dim=0, hidden_size=32,
                                       n_layers=2, device="cpu") if neural else None)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def test_generate_mesh_one_stage(models):
    jm, params, tm = models
    t_grid = tmesh.eval_sdf_grid(tm.trace_sdf_fn(), 32, (-1.0,) * 3, (1.0,) * 3,
                                 device="cpu")
    j_grid = jmesh.eval_sdf_grid(jm.trace_sdf_fn(params), 32, (-1.0,) * 3,
                                 (1.0,) * 3)
    np.testing.assert_allclose(t_grid, j_grid, rtol=0, atol=2e-6)
    v, f = Generator(tm, GeneratorConfig(mesh_resolution=32)).generate_mesh(
        two_stage=False)
    jv, jf = JGen(jm, JGC(mesh_resolution=32)).generate_mesh(params,
                                                             two_stage=False)
    assert len(f) == len(jf) > 1000
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)


def test_refine_mesh(models):
    jm, params, tm = models
    v, _ = jmesh.extract_mesh(jm.sdf_fn(params), resolution=20)
    v = v[np.random.RandomState(0).permutation(len(v))[:1500]]
    got = Generator(tm, GeneratorConfig(refine_steps=5, refine_lr=1e-3)
                    ).refine_mesh(v)
    ref = JGen(jm, JGC(refine_steps=5, refine_lr=1e-3)).refine_mesh(params, v)
    assert np.abs(got - v).max() > 1e-4   # the steps moved the vertices
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_estimate_normals(models):
    jm, params, tm = models
    p = np.random.RandomState(1).uniform(-0.8, 0.8, (2, 400, 3)).astype(np.float32)
    got = Generator(tm).estimate_normals(torch.from_numpy(p))
    ref = JGen(jm).estimate_normals(params, jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _cameras():
    R, T = look_at_view_transform([2.0, 2.2], [15.0, -20.0], [30.0, 200.0])
    return (PerspectiveCamera.create(R=R, T=T, focal_length=2.0),
            JCam.create(R=R.numpy(), T=T.numpy(), focal_length=2.0))


@pytest.mark.parametrize("texture", ["lighting", "neural"])
def test_raytrace_images(texture):
    jm, params, tm = _pair(texture)
    cam, jcam = _cameras()
    gen = Generator(tm, GeneratorConfig(image_size=24, rays_per_chunk=128))
    got = gen.raytrace_images(cam)
    ref = JGen(jm, JGC(image_size=24, rays_per_chunk=128)).raytrace_images(
        params, jcam)
    assert got.shape == (2, 24, 24, 4) and gen.overflow == 0
    alpha, j_alpha = got[..., 3], np.asarray(ref)[..., 3]
    assert 0.05 < alpha.mean() < 0.98
    assert np.mean(alpha == j_alpha) >= 0.99
    both = (alpha > 0) & (j_alpha > 0)
    np.testing.assert_allclose(got[..., :3][both], np.asarray(ref)[..., :3][both],
                               rtol=0, atol=1e-4)
    assert np.all(got[..., :3][alpha == 0] == 1.0)


def test_iso_contours_raise(models, tmp_path):
    """No longer raises: the contours against JAX's, from the generator and
    from `generate_mvr --iso-contours` (the name is kept from when both
    raised)."""
    import os

    from isopoints_tpu.config import load_config as j_load
    from isopoints_tpu.factories import create_model as j_create_model
    from isopoints_torch import generate_mvr
    from isopoints_torch.config import load_config
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from test_torch_visualize import assert_payloads_close

    jm, params, tm = models
    Generator(tm).generate_iso_contour(str(tmp_path / "port.html"))
    JGen(jm).generate_iso_contour(params, str(tmp_path / "jax.html"))
    got = assert_payloads_close(str(tmp_path / "port.html"),
                                str(tmp_path / "jax.html"), z=1e-5)
    assert len(got) == 9 and np.asarray(got[0][0]["z"]).shape == (100, 100)

    cfg_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "synthetic_sphere_iso.yml")
    jm2 = j_create_model(j_load(cfg_path))
    params2 = jm2.init(jax.random.key(3))
    tm2 = create_model(load_config(cfg_path), device="cpu")
    tm2.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params2)))
    run = tmp_path / "run"
    CheckpointIO(str(run), model=tm2.state_dict()).save("model.npz")
    generate_mvr.main([cfg_path, "--checkpoint", str(run / "model.npz"),
                       "--mesh-resolution", "24", "--image-size", "16",
                       "--n-views", "1", "--iso-contours", "--device", "cpu"])
    JGen(jm2).generate_iso_contour(params2, str(tmp_path / "jax2.html"))
    assert_payloads_close(str(run / "generation" / "iso_contour.html"),
                          str(tmp_path / "jax2.html"), z=1e-5)


def _cloud(n=300, seed=5):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (d * [0.5, 0.4, 0.3] + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    return pts, d.astype(np.float32)


def test_imls_sdf():
    pts, nrm = _cloud()
    q = np.random.RandomState(6).uniform(-0.9, 0.9, (1, 500, 3)).astype(np.float32)
    got = imls.imls_sdf(torch.from_numpy(q), torch.from_numpy(pts)[None],
                        torch.from_numpy(nrm)[None], k=8)
    ref = j_imls.imls_sdf(jnp.asarray(q), jnp.asarray(pts)[None],
                          jnp.asarray(nrm)[None], k=8)
    assert got.shape == (1, 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_point_model_generate_mesh():
    pts, nrm = _cloud()
    n = len(pts)
    jm = JPointModel(JPointConfig(n_points_per_cloud=n))
    params = jm.init(jax.random.key(0), points=jnp.asarray(pts)[None],
                     normals=jnp.asarray(nrm)[None])
    tm = PointModel(PointModelConfig(n_points_per_cloud=n), device="cpu")
    tm.load_state_dict(point_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    active = np.ones((1, n), bool)
    active[0, ::7] = False
    v, f = tm.generate_mesh(resolution=24,
                            activation_mask=torch.from_numpy(active))
    jv, jf = jm.generate_mesh(params, resolution=24,
                              activation_mask=jnp.asarray(active))
    assert len(f) > 100
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)
