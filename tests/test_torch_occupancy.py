"""Port parity: the occupancy decoder and the DVR occupancy model
(isopoints_torch/models/fields.py `OccupancyField`, `approximate_gradient`;
models/occupancy.py) against the JAX package's, on the CPU, with the
parameters converted by `isopoints_torch.convert`.

- `OccupancyField` (3 blocks x 64 and 1 x 32): raw logits within 1e-5
  (float32 products of two libraries; JAX at `highest`); its init: fc1
  zero, the other weights within ±1/√fan_in, zero biases.
- `OccupancyModel` on an analytic decoder (logits 20·(0.5 − |x|), the JAX
  test's sphere) and on a random field: `pixels_to_world` masks equal and
  points within 1e-5; `forward` with JAX's candidate draw passed in, every
  mask equal and the candidate logits within 1e-5; the BCE loss within
  rtol 1e-5 and its gradient to every parameter within 1e-5·max(1, |g|)
  (same products, other summation orders); `generate_mesh` at 32³ equal in
  size with vertices within 1e-5.
- `approximate_gradient` of a SIREN within 1e-4 (central differences
  divide float32 value round-off by 2h = 0.002).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.models import fields as jfields
from isopoints_tpu.models import occupancy as jocc
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import PerspectiveCamera as TCam
from isopoints_torch.models import fields as tfields
from isopoints_torch.models import occupancy as tocc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(params, seed):
    """JAX params with every fc1 made non-zero (the init's zero fc1 would
    make each block the identity) and the output bias shifted so that the
    level set crosses the cube."""
    rng = np.random.RandomState(seed)
    p = jax.tree.map(np.asarray, params)
    for blk in p["blocks"]:
        blk["fc1"]["w"] = rng.uniform(-0.1, 0.1, blk["fc1"]["w"].shape).astype(np.float32)
    p["fc_out"]["b"] = p["fc_out"]["b"] + np.float32(0.05)
    return p


def torch_field(jparams, **kw):
    f = tfields.OccupancyField(**kw, device="cpu")
    sd = params_from_jax({"decoder": jparams})
    f.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return f


@pytest.mark.parametrize("kw", [dict(hidden_size=64, n_blocks=3),
                                dict(hidden_size=32, n_blocks=1)],
                         ids=["3x64", "1x32"])
def test_occupancy_field(kw):
    jf = jfields.OccupancyField(**kw)
    p = perturbed(jf.init(jax.random.key(0)), 1)
    tf = torch_field(p, **kw)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 200, 3)).astype(np.float32)
    j = jf.apply(p, jnp.asarray(x)).occupancy
    t = tf(torch.tensor(x))
    assert t.shape == (2, 200, 1)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_occupancy_field_code_and_heads():
    """`c_dim` and `out_dims` (fields.py:333-376): the code's fc_c layer
    added in every block, an rgb head with its sigmoid beside the raw
    occupancy logit; each head against JAX's, with and without a code."""
    kw = dict(hidden_size=32, n_blocks=2, c_dim=4,
              out_dims={"rgb": 3, "occupancy": 1})
    jf = jfields.OccupancyField(**kw)
    p = perturbed(jf.init(jax.random.key(3)), 4)
    tf = torch_field(p, **kw)
    assert len(tf.fc_c) == 2 and tf.fc_out.weight.shape == (4, 32)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 60, 3)).astype(np.float32)
    c = rng.normal(size=(2, 60, 4)).astype(np.float32)
    for code in (c, None):
        j = jf.apply(p, jnp.asarray(x), None if code is None else jnp.asarray(code))
        t = tf.heads(torch.tensor(x), None if code is None else torch.tensor(code))
        for name in ("rgb", "occupancy"):
            np.testing.assert_allclose(getattr(t, name).detach().numpy(),
                                       np.asarray(getattr(j, name)), rtol=0,
                                       atol=1e-5, err_msg=name)
        assert t.sdf is None and j.sdf is None
    with_code = tf(torch.tensor(x), torch.tensor(c))
    assert with_code.shape == (2, 60, 1)
    assert float((with_code - tf(torch.tensor(x))).detach().abs().max()) > 1e-3


def test_occupancy_field_init():
    f = tfields.OccupancyField(hidden_size=64, n_blocks=2, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    for blk in f.blocks:
        assert not blk["fc1"].weight.any() and not blk["fc1"].bias.any()
        assert float(blk["fc0"].weight.abs().max()) <= 1 / 8
    assert float(f.fc_in.weight.abs().max()) <= 1 / np.sqrt(3)
    assert f.fc_out.weight.shape == (1, 64)


class SphereDecoder:
    """The JAX test's analytic decoder: raw logits 20·(0.5 − |x|)."""

    def init(self, key):
        return {"r": jnp.asarray(0.5)}

    def apply(self, params, x, c=None):
        return jfields.FieldOutput(
            occupancy=20.0 * (params["r"] - jnp.linalg.norm(x, axis=-1, keepdims=True)))


class TorchSphereDecoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.r = torch.nn.Parameter(torch.tensor(0.5))

    def forward(self, x):
        return 20.0 * (self.r - torch.linalg.norm(x, dim=-1, keepdim=True))


def cameras():
    R, T = j_look_at([2.0, 2.4], [20.0, -25.0], [30.0, 160.0])
    return (JCam.create(R=R, T=T, focal_length=1.5),
            TCam.create(R=torch.tensor(np.asarray(R)), T=torch.tensor(np.asarray(T)),
                        focal_length=1.5, device="cpu"))


def models(kind):
    if kind == "sphere":
        jm = jocc.OccupancyModel(SphereDecoder())
        return jm, jm.init(jax.random.key(0)), tocc.OccupancyModel(TorchSphereDecoder())
    jf = jfields.OccupancyField(hidden_size=64, n_blocks=3)
    p = perturbed(jf.init(jax.random.key(4)), 5)
    # centre the logits on the cube, so that half of it is inside, and turn
    # the field so that these views' rays enter it (outside to inside)
    x = np.random.RandomState(7).uniform(-1, 1, (4000, 3)).astype(np.float32)
    occ = np.asarray(jf.apply(p, jnp.asarray(x)).occupancy)
    p["fc_out"]["b"] = (np.median(occ) - p["fc_out"]["b"]).astype(np.float32)
    p["fc_out"]["w"] = -p["fc_out"]["w"]
    return (jocc.OccupancyModel(jf), {"decoder": p},
            tocc.OccupancyModel(torch_field(p, hidden_size=64, n_blocks=3)))


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_occupancy_model(kind):
    jm, jp, tm = models(kind)
    jcam, tcam = cameras()
    rng = np.random.RandomState(6)
    ndc = rng.uniform(-0.8, 0.8, (2, 300, 2)).astype(np.float32)
    mask_img = (rng.uniform(size=(2, 16, 16, 1)) < 0.5).astype(np.float32)
    key = jax.random.key(9)
    steps = np.asarray(jax.random.uniform(key, (100,)))

    jpts, jmask = jm.pixels_to_world(jp, jnp.asarray(ndc), jcam)
    tpts, tmask = tm.pixels_to_world(torch.tensor(ndc), tcam)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    m = tmask.numpy()
    assert 0.05 < m.mean() < 0.95
    np.testing.assert_allclose(tpts.numpy()[m], np.asarray(jpts)[m], atol=1e-5)
    if kind == "sphere":
        np.testing.assert_allclose(np.linalg.norm(tpts.numpy()[m], axis=-1), 0.5,
                                   atol=1e-4)

    def j_loss(params):
        o = jm.forward(params, jnp.asarray(ndc), jnp.asarray(mask_img), jcam, key)
        return (jocc.occupancy_bce_loss(o.logits_freespace,
                                        jnp.zeros_like(o.logits_freespace),
                                        mask=o.freespace_mask)
                + jocc.occupancy_bce_loss(o.logits_occupancy,
                                          jnp.ones_like(o.logits_occupancy),
                                          mask=o.occupancy_mask)), o

    (jl, jo), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    to = tm(torch.tensor(ndc), torch.tensor(mask_img), tcam, torch.tensor(steps))
    for name in ("surface_mask", "network_mask", "freespace_mask", "occupancy_mask"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)
    np.testing.assert_allclose(to.logits_freespace.detach().numpy(),
                               np.asarray(jo.logits_freespace), atol=1e-5)
    tl = (tocc.occupancy_bce_loss(to.logits_freespace,
                                  torch.zeros_like(to.logits_freespace),
                                  mask=to.freespace_mask)
          + tocc.occupancy_bce_loss(to.logits_occupancy,
                                    torch.ones_like(to.logits_occupancy),
                                    mask=to.occupancy_mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tl.backward()
    if kind == "sphere":
        pairs = [(tm.decoder.r.grad, jg["decoder"]["r"])]
    else:
        tg = params_from_jax({"decoder": jax.tree.map(np.asarray, jg["decoder"])})
        pairs = [(dict(tm.named_parameters())[k].grad, v) for k, v in tg.items()]
    for g, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_generate_mesh_and_bce_reductions():
    jm, jp, tm = models("sphere")
    jv, jf = jm.generate_mesh(jp, resolution=32)
    tv, tf = tm.generate_mesh(resolution=32)
    assert len(tf) == len(jf) > 100
    np.testing.assert_array_equal(tf, np.asarray(jf))
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 3, (2, 50)).astype(np.float32)
    target = rng.uniform(size=(2, 50)) < 0.5
    mask = rng.uniform(size=(2, 50)) < 0.7
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            tocc.occupancy_bce_loss(torch.tensor(logits), torch.tensor(target),
                                    torch.tensor(mask), red).numpy(),
            np.asarray(jocc.occupancy_bce_loss(jnp.asarray(logits), jnp.asarray(target),
                                               jnp.asarray(mask), red)), rtol=1e-6)


def test_approximate_gradient():
    jf = jfields.SirenField(hidden_size=32, n_layers=1)
    params = jf.init(jax.random.key(1))
    tf = tfields.SirenField(hidden_size=32, n_layers=1, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tf.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    x = np.random.RandomState(0).uniform(-1, 1, (100, 3)).astype(np.float32)
    j = jfields.approximate_gradient(lambda p: jf.sdf(params, p), jnp.asarray(x))
    t = tfields.approximate_gradient(tf.sdf, torch.tensor(x))
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-4)
    # against the autograd gradient: differences of O(h²)
    _, g = tfields.sdf_and_grad(tf.sdf, torch.tensor(x))
    assert float((t - g).abs().max()) < 0.05 * float(g.abs().max())
