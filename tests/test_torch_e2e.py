"""Port parity end to end: the synthetic dataset and a short warm-up
training run against the JAX package, on configs/synthetic_sphere_iso.yml.

Both packages train from the same converted initial parameters on the same
views and the same random numbers: the JAX trainer's KeyChain is replayed
(two keys for init_state, then one per step) and each step's draws are
rebuilt from its key as isopoints_tpu splits it (see
tests/test_torch_train_step.py) and handed to the port.

Tolerances. Dataset: masks equal on all but 0.5% of pixels (a silhouette
pixel flips where the sphere trace stops within round-off of the
threshold), colours atol 1e-4 elsewhere. Trajectory: every loss term
within rtol 3e-4 + atol 1e-5 of the JAX value at every step (the two
float32 runs drift apart slowly through Adam's first steps, which move
each weight by ~lr·sign(g) whatever the size of g; over these 8 steps the
drift measured under 7% of rtol 1e-3 at 1 and at 4 threads).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isopoints_tpu.config import default_config_path, load_config as j_load
from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.data.synthetic import make_synthetic_mvr as j_make_mvr
from isopoints_tpu.data.synthetic import sphere_sdf as j_sphere
from isopoints_tpu.factories import create_model as j_create_model
from isopoints_tpu.factories import create_trainer as j_create_trainer
from isopoints_tpu.ops.images import sample_random_pixels as j_pixels
from isopoints_tpu.rng import KeyChain
from isopoints_torch.config import load_config
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import cameras_from_matrices
from isopoints_torch.data.synthetic import make_synthetic_mvr, sphere_sdf
from isopoints_torch.factories import create_model, create_trainer
from isopoints_torch.training.trainer import StepDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "synthetic_sphere_iso.yml")
LOSS_KEYS = ("loss", "loss_rgb", "loss_freespace", "loss_occupied",
             "loss_eikonal")


def test_synthetic_dataset_matches_jax():
    ref = j_make_mvr(j_sphere(), n_views=4, image_size=16)
    out = make_synthetic_mvr(sphere_sdf(), n_views=4, image_size=16,
                             device="cpu")
    np.testing.assert_allclose(out["camera_mat"], ref["camera_mat"], atol=1e-5)
    same = out["img.mask"] == ref["img.mask"]
    assert same.mean() >= 0.995
    assert ref["img.mask"].mean() > 0.05
    np.testing.assert_allclose(out["img.rgb"][same[..., 0]],
                               ref["img.rgb"][same[..., 0]], atol=1e-4)
    # GT surface samples: the same random seeds projected onto r = 0.5
    assert abs(len(out["points"]) - len(ref["points"])) <= 0.001 * len(ref["points"])
    np.testing.assert_allclose(np.linalg.norm(out["points"], axis=-1), 0.5,
                               atol=1e-5)


def _step_draws(key, n_rays, n_eik, n_steps, image_size):
    k_pix, k_loss = jax.random.split(key)
    pixels = j_pixels(k_pix, n_rays, image_size, batch_size=2)
    k1, k2, _ = jax.random.split(k_loss, 3)
    eik = jax.random.uniform(k2, (1, n_eik, 3), minval=-1.0, maxval=1.0)
    u = jax.random.uniform(jax.random.split(k1)[1], (n_steps,))
    return StepDraws(*(torch.from_numpy(np.array(a)) for a in (pixels, eik, u)))


def test_warmup_trajectory_tracks_jax():
    n_iters, seed = 8, 0
    jcfg = j_load(CFG, default_config_path())
    tcfg = load_config(CFG, default_config_path())
    # one dataset for both (the dataset itself is compared above)
    data = make_synthetic_mvr(sphere_sdf(), n_views=tcfg.data.n_views,
                              image_size=tcfg.data.image_size, device="cpu")
    j_trainer = j_create_trainer(j_create_model(jcfg), jcfg, seed=seed)
    j_state = j_trainer.init_state()
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        {"decoder": jax.tree.map(np.asarray, j_state.params["decoder"])}))
    trainer = create_trainer(model, tcfg, seed=seed, device="cpu")
    t_state = trainer.init_state()
    keys = KeyChain(seed)
    keys.next(), keys.next()                       # init_state's two keys
    n_rays = trainer.scheduler.at(0)["n_rays"]
    s = tcfg.data.image_size
    rows = []
    for it in range(n_iters):
        idx = np.random.RandomState((seed * 1_000_003 + it) % (2 ** 31)).choice(
            tcfg.data.n_views, size=2, replace=False)
        mats = data["camera_mat"][idx]
        jcam = JCam.create(R=mats[:, :3, :3], T=mats[:, 3, :3],
                           focal_length=data["focal_length"],
                           principal_point=data["principal_point"])
        tcam = cameras_from_matrices(mats, data["focal_length"],
                                     data["principal_point"], device="cpu")
        img, mask = data["img.rgb"][idx], data["img.mask"][idx]
        draws = _step_draws(keys.next(), n_rays,
                            trainer.cfg.n_eikonal_points,
                            model.raytrace_cfg.n_steps, (s, s))
        j_state, jm = j_trainer.train_step(j_state, jnp.asarray(img),
                                           jnp.asarray(mask), jcam)
        t_state, tm = trainer.train_step(t_state, torch.from_numpy(img),
                                         torch.from_numpy(mask), tcam,
                                         draws=draws)
        rows.append((jm, tm))
    for it, (jm, tm) in enumerate(rows):
        assert tm["n_iso"] == jm["n_iso"], it
        for k in LOSS_KEYS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=3e-4, atol=1e-5,
                                       err_msg=f"it {it} {k}")
