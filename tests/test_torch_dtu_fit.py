"""The DTU point-cloud workload end to end against the JAX package, on the
CPU: `fit_point_cloud` on the same noisy torus (2000 points, normals from
16-NN frames), with the JAX workload's random numbers replayed into the
port (`JaxDraws`: the same key chain) and the decoder converted from the
JAX initialisation of the same key, so that both runs see the same numbers.

The run: SIREN 3x256, batch 256, 200 iso-points, 8 iterations, warm-up 2,
a refresh at 2, 4 and 6 (perturbation, Newton, 5 repulsion rounds, frame
normals, bilateral denoising), bilateral weights, the SAL loss, and a
32^3 final mesh.

Tolerances. The two warm-up steps: every loss term within rtol 1e-5. The
first refresh: valid counts within 1% of the capacity. Its two projected
steps: every term within rtol 5e-2 + 1e-6 (the refresh's points follow
five repulsion rounds, which amplify rounding: see
tests/test_torch_dtu_refresh.py); measured here: normal_iso 8.3e-3
relative, sdf_iso 2.8e-7 absolute (a mean |f| of points converged to
|f| <= 1e-5), the others below 1e-3; in tests/test_torch_dtu_modes.py up
to 2.6e-2. The free run after the later refreshes, as
tests/test_torch_saliency.py's free-running lossS run: totals within rtol
0.1, counts within 15% of the capacity. final.ply against JAX's mesh of
the port's final field (the same two stages, mapped back by the same
center and scale), in the normalised frame: faces equal, 99.9% of the
vertex coordinates within 1e-5 (the one-stage SIREN bar of
tests/test_torch_generator.py) and all within 5e-5 (the two-stage bar of
tests/test_torch_meshing.py); measured 99.98% and 4.8e-5 (two float32
evaluations of the same SIREN, over the slope at each crossing).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.utils import io as j_io
from isopoints_tpu.utils import meshing as jmesh
from isopoints_tpu.workloads import dtu_points as jw
from isopoints_torch.convert import params_from_jax
from isopoints_torch.utils.io import read_ply
from isopoints_torch.workloads import dtu_points as tw

CENTER = np.array([0.1, -0.2, 0.3], np.float32)
SCALE = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """The JAX workload's key chain: key(seed) split for the decoder's init,
    then for the iso-point seeds, then each iteration one split for a
    refresh (when there is one) before the step's, which the step splits
    in four (dtu_points.py:189-356)."""

    def __init__(self, seed: int):
        self.key, self.k_init = jax.random.split(jax.random.key(seed))

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def iso_seed(self, p, n):
        return torch.from_numpy(np.array(
            jax.random.choice(self._next(), p, (n,), replace=n > p))).long()

    def perturb(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self._next(),
                                                            tuple(shape))))

    def step(self, batch, p, capacity):
        k1, k2, k3, k4 = jax.random.split(self._next(), 4)
        half = (1, batch // 2, 3)
        t = lambda a: torch.from_numpy(np.array(a))
        return tw.DTUStepDraws(
            idx=t(jax.random.randint(k1, (batch,), 0, p)).long(),
            space_u=t(jax.random.uniform(k2, half, minval=-1.0, maxval=1.0)),
            space_n=t(jax.random.normal(k3, half)),
            iso_idx=t(jax.random.randint(k4, (min(batch, capacity),), 0,
                                         capacity)).long())


def noisy_torus(n, seed, sigma=0.01):
    rng = np.random.RandomState(seed)
    u, v = rng.uniform(0, 2 * np.pi, (2, n))
    p = np.stack([(0.4 + 0.15 * np.cos(v)) * np.cos(u),
                  (0.4 + 0.15 * np.cos(v)) * np.sin(u), 0.15 * np.sin(v)], -1)
    return (p + rng.normal(scale=sigma, size=p.shape)).astype(np.float32)


def converted_decoder(cfg, draws):
    """The port's decoder with the JAX decoder's initialisation from the
    chain's init key."""
    params = jw.make_decoder(cfg).init(draws.k_init)
    dec = tw.make_decoder(cfg, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)},
                         keep_weight_norm=cfg.decoder_type == "sdf")
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    return dec


def run_jax(cfg, pts, normals, seed):
    """JAX's fit; returns (history, {it: valid iso-points of the refresh at
    it}). Its PLY writes are recorded instead of written and its final mesh
    is skipped (the tests mesh the port's field with JAX's meshing)."""
    counts = {}

    def record(path, points, **kw):
        name = os.path.basename(path)
        if name.endswith("_iso.ply"):
            counts[int(name[:10])] = len(points)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_io, "save_ply", record)
        mp.setattr(jw, "get_surface_high_res_mesh",
                   lambda *a, **kw: (np.zeros((0, 3)), np.zeros((0, 3), int)))
        _, _, jinfo = jw.fit_point_cloud(pts, normals, cfg, seed=seed,
                                         out_dir="unused", log_every=1)
    return jinfo["history"], counts


def run_both(cfg, out_dir, seed=0, normals=None, n=2000, mesh=True):
    """JAX's fit and the port's on replayed draws (the port's writes into
    `out_dir` when `mesh`); returns (port history, JAX history, port
    decoder, port info, port refresh counts, JAX's), the counts by
    iteration."""
    pts = noisy_torus(n, seed)
    jhist, jcounts = run_jax(cfg, pts, normals, seed)
    draws = JaxDraws(seed)
    found = []

    def recording(*args):
        found.append(tw_refresh(*args))
        return found[-1]
    with pytest.MonkeyPatch.context() as mp:
        tw_refresh = tw.refresh_iso
        mp.setattr(tw, "refresh_iso", recording)
        dec, info = tw.fit_point_cloud(
            pts, normals, cfg, seed=seed, out_dir=str(out_dir) if mesh else None,
            log_every=1, denormalize=(CENTER, SCALE), device="cpu", draws=draws,
            decoder=converted_decoder(cfg, draws))
    counts = dict(zip(sorted(jcounts), (int(r.mask.sum()) for r in found)))
    assert len(found) == len(jcounts)
    return info["history"], jhist, dec, info, counts, jcounts


def assert_terms(t_row, j_row, rtol, atol=1e-7):
    t_it, t_total, t_terms = t_row
    j_it, j_total, j_terms = j_row
    assert t_it == j_it and set(t_terms) == set(j_terms)
    for k in j_terms:
        assert abs(t_terms[k] - j_terms[k]) <= rtol * abs(j_terms[k]) + atol, (
            t_it, k, t_terms[k], j_terms[k])
    assert abs(t_total - j_total) <= rtol * abs(j_total)


CFG = tw.DTUPointsConfig(total_iters=8, warm_up=2, resample_every=2,
                         n_iso_points=200, batch_size=256, mesh_resolution=32)


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    out = tmp_path_factory.mktemp("dtu_fit")
    res = run_both(jw.DTUPointsConfig(**CFG.__dict__), out)
    res[3]["out_dir"] = str(out)
    return res


def test_warm_steps_refresh_and_projected_steps(fit):
    hist, jhist, _, _, counts, jcounts = fit
    assert [h[0] for h in hist] == list(range(8))
    assert sorted(jcounts) == [2, 4, 6]
    for i in (0, 1):
        assert_terms(hist[i], jhist[i], 1e-5)
    assert abs(counts[2] - jcounts[2]) <= 0.01 * CFG.n_iso_points
    assert jcounts[2] > 0.5 * CFG.n_iso_points
    for i in (2, 3):
        assert set(hist[i][2]) == {"eikonal", "sdf", "normals", "sdf_iso",
                                   "normal_iso", "inter"}
        assert_terms(hist[i], jhist[i], 5e-2, atol=1e-6)


def test_free_run_after_later_refreshes(fit):
    hist, jhist, _, info, counts, jcounts = fit
    for it in (4, 6):
        assert abs(counts[it] - jcounts[it]) <= 0.15 * CFG.n_iso_points
    for i in range(4, 8):
        assert abs(hist[i][1] - jhist[i][1]) <= 0.1 * abs(jhist[i][1]), (i, hist[i],
                                                                       jhist[i])
    assert info["iso_points"].shape == (1, CFG.n_iso_points, 3)
    assert int(info["iso_mask"].sum()) == counts[6]
    assert len(read_ply(os.path.join(info["out_dir"], "0000000006_iso.ply"))[
        "points"]) == counts[6]


def test_final_mesh_matches_jax_mesh_of_the_same_field(fit):
    _, _, dec, info, _, _ = fit
    ply = read_ply(os.path.join(info["out_dir"], "final.ply"))
    verts, faces = ply["points"], ply["faces"]
    np.testing.assert_array_equal(verts, info["mesh"][0].astype(np.float32))
    params = {"layers": [{"w": lin.weight.detach().numpy(),
                          "b": lin.bias.detach().numpy()} for lin in dec.layers]}
    jdec = jw.make_decoder(CFG)
    jv, jf = jmesh.get_surface_high_res_mesh(
        lambda x: jdec.sdf(jax.tree.map(jnp.asarray, params), x),
        resolution=CFG.mesh_resolution)
    jv = jv * SCALE + CENTER
    assert len(faces) == len(jf) > 500
    np.testing.assert_array_equal(faces, jf)
    err = np.abs(verts - jv)
    assert np.mean(err <= 1e-5 * SCALE) >= 0.999 and err.max() <= 5e-5 * SCALE, (
        np.mean(err <= 1e-5 * SCALE), err.max())
