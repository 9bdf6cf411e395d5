"""Port parity: the gradient taps (isopoints_torch/debug.py) against the JAX
package's debug.py, on the CPU.

- `tap_grad` on a toy loss: the stored points and gradients equal JAX's
  (the same float32 products).
- The "iso" tap of the warm-up step (test_torch_train_step.py's step on
  JAX's draws, the port's fused callables as their plain twins): points
  within 1e-5 and dL/dx within 1e-3·max|g| of JAX's capture (the
  gradient passes through the shading and the SDF losses, summed in
  other orders: the step test's bar).
- The point model's mask-image tap (test_torch_point_model.py's two
  views): within 1e-6 (the loss's own derivative of the same alpha).
- With debugging off nothing is stored, and the step's loss and
  gradients are bit-equal with debugging on and off: the taps change no
  value. `MVRTrainer.debug_dump` returns None without a capture; with the
  warm-up step's "iso" capture and the point model's mask-image capture
  it writes the 3D quiver and the mask-gradient pane, held against JAX's
  `debug_dump` on the JAX captures (misc/visualize.py's fallback payloads:
  positions within 1e-5, the cones within 1e-3·max|g|, the pane within
  1e-6, the captures' own bars) and clears the capture.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu import debug as jdebug
from isopoints_torch import debug as tdebug
from isopoints_torch.training.trainer import compute_loss
from test_torch_point_model import _cameras, _models
from test_torch_train_step import (HP, _jax_loss_and_grads, jax_step_draws,  # noqa: F401
                                   world)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _debugging_off():
    yield
    tdebug.set_debugging_mode_(False)
    jdebug.set_debugging_mode_(False)


def test_tap_grad_toy():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 50, 3)).astype(np.float32)
    w = rng.normal(size=(2, 50, 3)).astype(np.float32)
    jdebug.set_debugging_mode_(True)
    tdebug.set_debugging_mode_(True)
    jax.grad(lambda a: jnp.sum(jdebug.tap_grad("p", a) ** 2 * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tdebug.tap_grad("p", xt * 1.0) ** 2 * torch.tensor(w)).sum().backward()
    js, ts = jdebug.get_debugging_tensor(), tdebug.get_debugging_tensor()
    np.testing.assert_array_equal(ts.pts_world["p"].numpy(), js.pts_world["p"])
    np.testing.assert_array_equal(ts.pts_world_grad["p"].numpy(), js.pts_world_grad["p"])
    # off: nothing is stored, and the state is cleared
    tdebug.set_debugging_mode_(False)
    assert not ts.pts_world
    xt.grad = None
    (tdebug.tap_grad("p", xt * 1.0) ** 2).sum().backward()
    assert not ts.pts_world and xt.grad is not None


def _port_step(world, draws):
    tmodel = world["tmodel"]
    total, *_ = compute_loss(
        tmodel, None, None, draws.pixels, torch.from_numpy(world["img"]),
        torch.from_numpy(world["mask"]), world["tcam"], draws.eikonal,
        draws.u_minsdf, HP, project=False)
    grads = torch.autograd.grad(total, list(tmodel.parameters()))
    return total.detach(), grads


def test_iso_tap_of_the_warmup_step(world):
    pixels, k_loss, draws = jax_step_draws(jax.random.key(11), 2, (16, 16))
    off_total, off_grads = _port_step(world, draws)
    assert not tdebug.get_debugging_tensor().pts_world
    jdebug.set_debugging_mode_(True)
    tdebug.set_debugging_mode_(True)
    _jax_loss_and_grads(world, pixels, k_loss)
    on_total, on_grads = _port_step(world, draws)
    # the taps change no value
    assert torch.equal(on_total, off_total)
    assert all(torch.equal(a, b) for a, b in zip(on_grads, off_grads))
    js, ts = jdebug.get_debugging_tensor(), tdebug.get_debugging_tensor()
    jp, jg = js.pts_world["iso"], js.pts_world_grad["iso"]
    tp, tg = ts.pts_world["iso"].numpy(), ts.pts_world_grad["iso"].numpy()
    assert tp.shape == jp.shape == (2, 128, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-3 * np.abs(jg).max())


def test_mask_image_tap_of_the_point_model():
    jm, params, tm, mask_img, target = _models(False)
    jcam, tcam = _cameras(2)
    jdebug.set_debugging_mode_(True)
    tdebug.set_debugging_mode_(True)

    def j_loss(p):
        out = jm.forward(p, jcam, mask_img=jnp.asarray(mask_img))
        return jnp.sum((out.rgba[..., 3] - target[..., 3]) ** 2)

    jax.grad(j_loss)(params)
    out = tm(tcam, mask_img=torch.from_numpy(mask_img))
    torch.sum((out.rgba[..., 3] - torch.from_numpy(target[..., 3])) ** 2).backward()
    jg = np.asarray(jdebug.get_debugging_tensor().img_mask_grad)
    tg = tdebug.get_debugging_tensor().img_mask_grad.numpy()
    assert tg.shape == jg.shape == (2, 32, 32, 1) and np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)


def test_debug_dump(world, tmp_path):
    from isopoints_tpu.training.trainer import MVRTrainer as JTrainer
    from isopoints_torch.training.trainer import MVRTrainer, TrainerConfig
    from test_torch_visualize import assert_payloads_close

    trainer = MVRTrainer(world["tmodel"], TrainerConfig(), device="cpu")
    assert trainer.debug_dump(str(tmp_path), 0) is None
    tdebug.set_debugging_mode_(True)
    assert trainer.debug_dump(str(tmp_path), 0) is None   # nothing captured
    jdebug.set_debugging_mode_(True)
    # the warm-up step's "iso" capture and the point model's mask capture,
    # in both packages
    pixels, k_loss, draws = jax_step_draws(jax.random.key(11), 2, (16, 16))
    _jax_loss_and_grads(world, pixels, k_loss)
    _port_step(world, draws)
    jm, params, tm, mask_img, target = _models(False)
    jcam, tcam = _cameras(2)
    jax.grad(lambda p: jnp.sum((jm.forward(p, jcam, mask_img=jnp.asarray(
        mask_img)).rgba[..., 3] - target[..., 3]) ** 2))(params)
    out = tm(tcam, mask_img=torch.from_numpy(mask_img))
    torch.sum((out.rgba[..., 3] - torch.from_numpy(target[..., 3])) ** 2).backward()
    g_max = float(np.abs(jdebug.get_debugging_tensor().pts_world_grad["iso"]).max())
    # JAX's debug_dump reads only the global capture, not the trainer
    j_path = JTrainer.debug_dump(None, str(tmp_path / "jax"), 7)
    t_path = trainer.debug_dump(str(tmp_path / "port"), 7)
    assert os.path.basename(t_path) == os.path.basename(j_path) == \
        "0000000007_grad_quiver.html"
    got = assert_payloads_close(t_path, j_path, x=1e-5, y=1e-5, z=1e-5,
                                u=1e-3 * g_max, v=1e-3 * g_max, w=1e-3 * g_max)
    assert [t["type"] for t in got[0]] == ["Scatter3d", "Cone"]
    assert_payloads_close(str(tmp_path / "port" / "0000000007_mask_grad.html"),
                          str(tmp_path / "jax" / "0000000007_mask_grad.html"))
    state = tdebug.get_debugging_tensor()
    assert not state.pts_world and state.img_mask_grad is None
