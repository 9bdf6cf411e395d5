"""Port parity: the debug plots (isopoints_torch/misc/visualize.py) and
`plot_evaluations` against the JAX package's misc/visualize.py and
scripts/plot_evaluations.py, on the CPU.

Neither package finds plotly here, so both write the data-only HTML of
their `_FallbackGo`: one `<pre data-format='fallback-plotly-json'>` a
figure, holding each trace's keyword arguments as JSON. Each test writes
the same inputs through both packages, parses both payloads and compares
them trace by trace: the same kinds and keys, strings and integers equal,
arrays within 1e-6. SDF values of a converted SIREN (2 x 32, JAX's init)
are held within 1e-5 (two float32 evaluations of one field);
`plot_iso_surface`'s mesh as PR 13 holds meshes: faces equal, vertices
within 1e-5.
"""

import csv
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.misc import visualize as jv
from isopoints_torch import plot_evaluations
from isopoints_torch.misc import visualize as tv
from test_torch_generator import _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRE = re.compile(r"<pre data-format='fallback-plotly-json'>(.*?)</pre>", re.S)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def payloads(path):
    """The figures of a fallback HTML file: a list a figure of its traces'
    JSON objects."""
    with open(path) as f:
        html = f.read()
    assert html.startswith("<html><head></head><body>\n")
    assert html.endswith("</body></html>\n")
    return [json.loads(m) for m in PRE.findall(html)]


def _close(a, b, atol, tol, key=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (key, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], tol.get(k, atol), tol, k)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), key
        try:
            x, y = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        except (TypeError, ValueError):
            for u, v in zip(a, b):
                _close(u, v, atol, tol, key)
            return
        assert x.shape == y.shape, key
        np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=key)
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=key)
    else:
        assert a == b, (key, a, b)


def assert_payloads_close(port_path, jax_path, atol=1e-6, **tol):
    """Both files' figures trace by trace: kinds and keys equal, numbers
    within `atol` (or `tol[key]` under that key)."""
    got, ref = payloads(port_path), payloads(jax_path)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert [t["type"] for t in g] == [t["type"] for t in r]
        _close(g, r, atol, tol)
    return got


def _both(tmp_path, name, fn_t, fn_j):
    p_t, p_j = str(tmp_path / "port" / name), str(tmp_path / "jax" / name)
    fn_t(p_t)
    fn_j(p_j)
    return p_t, p_j


def _clouds(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for n in (50, 80, 30)]


def test_animate_points(tmp_path):
    seq = _clouds()
    names = ["a_iso.ply", "b_iso.ply", "c_iso.ply"]
    p_t, p_j = _both(tmp_path, "pts.html",
                     lambda p: tv.animate_points([torch.from_numpy(s) for s in seq],
                                                 p, names=names),
                     lambda p: jv.animate_points(seq, p, names=names))
    got = assert_payloads_close(p_t, p_j)
    assert [t["type"] for t in got[0]] == ["Scatter3d"]


def test_animate_mesh(tmp_path):
    rng = np.random.RandomState(1)
    verts = [rng.normal(size=(12, 3)).astype(np.float32) for _ in range(3)]
    faces = [rng.randint(0, 12, (n, 3)).astype(np.int32) for n in (5, 7, 9)]
    p_t, p_j = _both(tmp_path, "mesh.html",
                     lambda p: tv.animate_mesh(verts, faces, p),
                     lambda p: jv.animate_mesh(verts, faces, p))
    assert_payloads_close(p_t, p_j)


def test_plot_3d_quiver(tmp_path):
    """A set above `n_pts` (subsampled by RandomState(0)), one below, one
    without gradients, and a mesh; the gradients as tensors."""
    rng = np.random.RandomState(2)
    pts = {"iso": rng.normal(size=(2, 150, 3)).astype(np.float32),
           "proj": rng.normal(size=(40, 3)).astype(np.float32),
           "seed": rng.normal(size=(10, 3)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in pts.items() if k != "seed"}
    mesh = (rng.normal(size=(8, 3)).astype(np.float32),
            rng.randint(0, 8, (6, 3)).astype(np.int32))
    p_t, p_j = _both(tmp_path, "quiver.html",
                     lambda p: tv.plot_3D_quiver(
                         {k: torch.from_numpy(v) for k, v in pts.items()},
                         {k: torch.from_numpy(v) for k, v in grads.items()}, p,
                         mesh=(torch.from_numpy(mesh[0]), mesh[1])),
                     lambda p: jv.plot_3D_quiver(pts, grads, p, mesh=mesh))
    got = assert_payloads_close(p_t, p_j)
    assert [t["type"] for t in got[0]] == ["Mesh3d", "Scatter3d", "Cone",
                                           "Scatter3d", "Cone", "Scatter3d"]
    assert len(got[0][1]["x"]) == 200


@pytest.mark.parametrize("grad_shape", [None, (2, 16, 16, 1), (16, 16, 1), (2, 16, 16)])
def test_plot_2d_quiver(tmp_path, grad_shape):
    rng = np.random.RandomState(3)
    pix = rng.uniform(0, 16, (60, 2)).astype(np.float32)
    g = rng.normal(size=(60, 2)).astype(np.float32)
    mask = (rng.uniform(size=(16, 16, 1)) > 0.5).astype(np.float32)
    mg = None if grad_shape is None else rng.normal(size=grad_shape).astype(np.float32)
    p_t, p_j = _both(tmp_path, "q2.html",
                     lambda p: tv.plot_2D_quiver(
                         torch.from_numpy(pix), torch.from_numpy(g), mask, p,
                         stride=2,
                         mask_grad_img=None if mg is None else torch.from_numpy(mg)),
                     lambda p: jv.plot_2D_quiver(pix, g, mask, p, stride=2,
                                                 mask_grad_img=mg))
    got = assert_payloads_close(p_t, p_j)
    assert len(got) == (1 if mg is None else 2)


def test_figures_to_html(tmp_path):
    """Several figures in one file, an empty one among them."""
    def figs(mod):
        go = mod._go()
        return [go.Figure(), go.Figure(data=go.Scatter(x=np.arange(3.0), y=[1.0, 2.0, 4.0],
                                                      name="s")),
                go.Figure(data=[go.Heatmap(z=np.eye(3))])]
    p_t, p_j = _both(tmp_path, "figs.html",
                     lambda p: tv.figures_to_html(figs(tv), p),
                     lambda p: jv.figures_to_html(figs(jv), p))
    got, ref = payloads(p_t), payloads(p_j)
    assert got == ref and len(got) == 3 and got[0] == []
    with open(p_t) as a, open(p_j) as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def siren():
    """The converted SIREN: (JAX's sdf callable, the same on numpy, the
    port's trace callable)."""
    jm, params, tm = _pair()
    f = jm.sdf_fn(params)
    return f, (lambda x: np.asarray(f(jnp.asarray(x)))), tm.trace_sdf_fn()


def test_plot_cuts(tmp_path, siren):
    _, j_fn, t_fn = siren
    p_t, p_j = _both(tmp_path, "cuts.html",
                     lambda p: tv.plot_cuts(t_fn, p, n_cuts=2, resolution=30,
                                            device="cpu"),
                     lambda p: jv.plot_cuts(j_fn, p, n_cuts=2, resolution=30))
    got = assert_payloads_close(p_t, p_j, z=1e-5)
    assert len(got) == 6 and all(t[0]["type"] == "Contour" for t in got)
    z = np.asarray(got[0][0]["z"])
    assert z.shape == (30, 30) and z.min() < 0 < z.max()


def test_plot_iso_surface(tmp_path, siren):
    j_fn, _, t_fn = siren
    p_t, p_j = _both(tmp_path, "iso.html",
                     lambda p: tv.plot_iso_surface(t_fn, p, resolution=24,
                                                   device="cpu"),
                     lambda p: jv.plot_iso_surface(j_fn, p, resolution=24))
    got = assert_payloads_close(p_t, p_j, x=1e-5, y=1e-5, z=1e-5)
    assert len(got[0][0]["i"]) > 0
    # an empty mesh: an empty figure in both
    p_t, p_j = _both(tmp_path, "empty.html",
                     lambda p: tv.plot_iso_surface(lambda x: torch.ones(x.shape[:-1]), p,
                                                   resolution=8, device="cpu"),
                     lambda p: jv.plot_iso_surface(lambda x: jnp.ones(x.shape[:-1]), p,
                                                   resolution=8))
    assert payloads(p_t) == payloads(p_j) == [[]]


def test_plot_evaluations(tmp_path, monkeypatch):
    """Two CSVs through the port's entry and scripts/plot_evaluations.py."""
    paths = []
    for name, rows in (("eval", [("a.ply", 0.1, 2.0), ("b.ply", 0.05, 1.5)]),
                       ("eval2", [("c.ply", 0.3, 1.0)])):
        p = tmp_path / f"{name}.csv"
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mesh", "chamfer_p", "point_face_rev"])
            w.writerows(rows)
        paths.append(str(p))
    out_t = plot_evaluations.main([*paths, "--out", str(tmp_path / "port.html")])
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import plot_evaluations as j_plot
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    monkeypatch.setattr(sys, "argv", ["plot_evaluations.py", *paths, "--out",
                                      str(tmp_path / "jax.html")])
    j_plot.main()
    got = assert_payloads_close(out_t, str(tmp_path / "jax.html"))
    assert [len(f) for f in got] == [2, 2]   # a figure a CSV, a line a metric
    # the default output: the first CSV's name with .html
    assert plot_evaluations.main(paths[:1]) == str(tmp_path / "eval.html")
