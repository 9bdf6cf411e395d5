"""Port parity: point lights, the light rigs and `create_lights`
(isopoints_torch/rendering/lighting.py, rendering/lightrigs.py,
factories.py) against the JAX package's, on the CPU.

- `apply_lighting` with `PointLights` (two sources a batch, batch 2):
  ambient exact, diffuse and specular within 1e-6 (float32 Phong terms;
  the specular power 64 of a cosine amplifies its rounding, so 1e-6 is
  absolute on values at most the light's colour), also through
  `lighting_texture`.
- `apply_lighting(with_specular=False)` for both light types: ambient and
  diffuse as with the specular term, the specular term exact zeros in both
  packages; `DirectionalLights.light_direction` exact.
- Both rigs, directional and point, with and without specular, on cameras
  from `look_at_view_transform`: every light array within 1e-6.
- `create_lights` on no block, a directional block and a point block.
- `create_animation` over saved `*_iso.ply` / `*_mesh.ply` snapshots (and a
  point cloud named `_mesh.ply` without faces, which both skip), with and
  without `show_max`: pts_animation.html and mesh_animation.html against
  JAX's, trace by trace, arrays within 1e-6; an empty directory writes
  nothing in either.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.factories import create_lights as j_create_lights
from isopoints_tpu.rendering import lighting as jl
from isopoints_tpu.rendering import lightrigs as jr
from isopoints_tpu.rendering.texture import lighting_texture as j_tex
from isopoints_torch.config import AttrDict
from isopoints_torch.core.camera import PerspectiveCamera as TCam
from isopoints_torch.core.camera import look_at_view_transform as t_look_at
from isopoints_torch.factories import create_lights as t_create_lights
from isopoints_torch.rendering import lighting as tl
from isopoints_torch.rendering import lightrigs as tr
from isopoints_torch.rendering.texture import lighting_texture as t_tex

FIELDS = {"DirectionalLights": ("ambient_color", "diffuse_color",
                                "specular_color", "direction"),
          "PointLights": ("ambient_color", "diffuse_color", "specular_color",
                          "location")}


def assert_lights_close(j, t):
    assert type(j).__name__ == type(t).__name__
    for f in FIELDS[type(t).__name__]:
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


def scene(seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    nrm = rng.normal(size=(2, 300, 3)).astype(np.float32)
    cam = rng.uniform(1.5, 2.5, (2, 3)).astype(np.float32)
    kw = dict(ambient_color=rng.uniform(0, 0.5, (2, 2, 3)),
              diffuse_color=rng.uniform(0, 1, (2, 2, 3)),
              specular_color=rng.uniform(0, 0.5, (2, 2, 3)),
              location=rng.uniform(-3, 3, (2, 2, 3)))
    return pts, nrm, cam, kw


def test_point_lights_apply_lighting():
    pts, nrm, cam, kw = scene()
    jlights = jl.PointLights.create(**kw)
    tlights = tl.PointLights.create(**kw)
    assert_lights_close(jlights, tlights)
    ja = jl.apply_lighting(jnp.asarray(pts), jnp.asarray(nrm), jlights, jnp.asarray(cam))
    ta = tl.apply_lighting(torch.tensor(pts), torch.tensor(nrm), tlights, torch.tensor(cam))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    for a, b in zip(ta[1:], ja[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert float(ta[2].abs().max()) > 1e-3   # some highlight
    rgb = np.random.RandomState(1).uniform(size=pts.shape).astype(np.float32)
    np.testing.assert_allclose(
        t_tex(torch.tensor(pts), torch.tensor(nrm), tlights, torch.tensor(cam),
              torch.tensor(rgb)).numpy(),
        np.asarray(j_tex(jnp.asarray(pts), jnp.asarray(nrm), jlights, jnp.asarray(cam),
                         jnp.asarray(rgb))), rtol=0, atol=2e-6)


@pytest.mark.parametrize("point_lights", [False, True], ids=["directional", "point"])
def test_apply_lighting_without_specular(point_lights):
    pts, nrm, cam, kw = scene()
    if not point_lights:
        kw["direction"] = kw.pop("location")
    jcls, tcls = ((jl.PointLights, tl.PointLights) if point_lights
                  else (jl.DirectionalLights, tl.DirectionalLights))
    jlights, tlights = jcls.create(**kw), tcls.create(**kw)
    targs = (torch.tensor(pts), torch.tensor(nrm), tlights, torch.tensor(cam))
    jargs = (jnp.asarray(pts), jnp.asarray(nrm), jlights, jnp.asarray(cam))
    ja = jl.apply_lighting(*jargs, with_specular=False)
    ta = tl.apply_lighting(*targs, with_specular=False)
    full = tl.apply_lighting(*targs)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    np.testing.assert_allclose(ta[1].numpy(), np.asarray(ja[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ta[2].numpy(), np.zeros(pts.shape, np.float32))
    np.testing.assert_array_equal(np.asarray(ja[2]), ta[2].numpy())
    assert torch.equal(ta[0], full[0]) and torch.equal(ta[1], full[1])
    assert float(full[2].abs().max()) > 1e-3
    if not point_lights:
        np.testing.assert_array_equal(
            tlights.light_direction(torch.tensor(pts)).numpy(),
            np.asarray(jlights.light_direction(jnp.asarray(pts))))


@pytest.mark.parametrize("rig", ["tri_color", "key"])
@pytest.mark.parametrize("point_lights", [False, True], ids=["directional", "point"])
@pytest.mark.parametrize("has_specular", [False, True], ids=["diffuse", "specular"])
def test_rigs(rig, point_lights, has_specular):
    elev, azim = [10.0, -35.0, 60.0], [0.0, 130.0, 250.0]
    jR, jT = j_look_at([2.0] * 3, elev, azim)
    tR, tT = t_look_at([2.0] * 3, elev, azim, device="cpu")
    jcam, tcam = JCam.create(R=jR, T=jT), TCam.create(R=tR, T=tT, device="cpu")
    name = "get_tri_color_lights_for_view" if rig == "tri_color" else "get_light_for_view"
    j = getattr(jr, name)(jcam, has_specular=has_specular, point_lights=point_lights)
    t = getattr(tr, name)(tcam, has_specular=has_specular, point_lights=point_lights)
    assert_lights_close(j, t)
    assert t.ambient_color.shape == (3, 3 if rig == "tri_color" else 1, 3)


@pytest.mark.parametrize("block", [None, {"type": "directional", "direction": [[0.0, 0.0, 1.0]]},
                                   {"type": "point", "location": [[1.0, 2.0, 3.0]],
                                    "diffuse_color": [[0.5, 0.4, 0.3]]}],
                         ids=["default", "directional", "point"])
def test_create_lights(block):
    cfg = AttrDict({"lights": block} if block else {})
    assert_lights_close(j_create_lights(cfg), t_create_lights(cfg))


def test_create_animation_raises(tmp_path):
    """No longer raises: the animations against JAX's (the name is kept
    from when it raised)."""
    _animations_match_jax(tmp_path, -1)


def test_create_animation_show_max(tmp_path):
    _animations_match_jax(tmp_path, 2)


def _animations_match_jax(tmp_path, show_max):
    import shutil

    from isopoints_torch.utils.io import save_ply
    from test_torch_visualize import assert_payloads_close

    rng = np.random.RandomState(show_max + 2)
    src = tmp_path / "snap"
    for it in range(3):
        save_ply(str(src / f"{it:010d}_iso.ply"),
                 rng.normal(size=(20 + it, 3)).astype(np.float32))
        save_ply(str(src / f"{it:010d}_mesh.ply"),
                 rng.normal(size=(9, 3)).astype(np.float32),
                 faces=rng.randint(0, 9, (4 + it, 3)))
    save_ply(str(src / "9999999999_mesh.ply"), rng.normal(size=(5, 3)))
    shutil.copytree(src, tmp_path / "jax")
    tr.create_animation(str(src), show_max=show_max)
    jr.create_animation(str(tmp_path / "jax"), show_max=show_max)
    for name in ("pts_animation.html", "mesh_animation.html"):
        got = assert_payloads_close(str(src / name), str(tmp_path / "jax" / name))
        assert len(got[0]) == 1
    (tmp_path / "empty").mkdir()
    tr.create_animation(str(tmp_path / "empty"))
    assert not list((tmp_path / "empty").iterdir())
