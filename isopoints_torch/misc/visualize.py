"""Debug plots as HTML (port of isopoints_tpu/misc/visualize.py).

`animate_points` / `animate_mesh` (slider animations of snapshots),
`plot_3D_quiver` (point sets with gradient cones and a mesh),
`plot_2D_quiver` (screen-space gradients over the mask, with the
mask-gradient pane), `figures_to_html`, `plot_iso_surface` (a marching
tetrahedra preview, utils/meshing.extract_mesh) and `plot_cuts` (SDF
contours on axis-aligned cross-sections).

Inputs are numpy arrays or tensors (brought to numpy); the SDF callables
of `plot_iso_surface` and `plot_cuts` take tensors and are evaluated on
`device` (on the card, the model's fused MLP kernel). plotly is imported
lazily, only when it is installed. Where it is not (neither the CPU
machine nor the GPU machine has it), every figure is written as the JAX
package writes it then: data-only HTML, one
`<pre data-format='fallback-plotly-json'>` holding each trace's keyword
arguments as JSON (`_FallbackGo`), so the data stays recoverable.
"""

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _have_plotly() -> bool:
    try:
        import plotly  # noqa: F401
        return True
    except ImportError:
        return False


def _go():
    if _have_plotly():
        import plotly.graph_objects as go
        return go
    return _FallbackGo()


def _np(x) -> np.ndarray:
    """A tensor or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _FallbackTrace:
    """A data-only trace: its kwargs, serialised to JSON in the HTML."""

    def __init__(self, kind, **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.name = kwargs.get("name", "")

    def to_json(self):
        def clean(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [clean(x) for x in v]
            return v

        return json.dumps({"type": self.kind, **clean(self.kwargs)})


class _FallbackFigure:
    def __init__(self, data=None, frames=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        self.data = list(data or [])
        self.frames = list(frames or [])

    def update_layout(self, **kwargs):
        return self

    def update_yaxes(self, **kwargs):
        return self

    def add_trace(self, tr):
        self.data.append(tr)

    def to_html(self, **kwargs):
        body = ",\n".join(t.to_json() for t in self.data
                          if hasattr(t, "to_json"))
        return ("<div><pre data-format='fallback-plotly-json'>[" + body +
                "]</pre><p>plotly unavailable; raw trace data above</p></div>")


class _FallbackGo:
    Figure = _FallbackFigure

    def __getattr__(self, kind):
        if kind == "Frame":
            return lambda data=None, name=None: _FallbackTrace(
                "frame", data=[t.kwargs for t in (data or [])], name=name)
        return lambda **kw: _FallbackTrace(kind, **kw)


def figures_to_html(figs, filename: str) -> None:
    """Concatenate figures into one HTML file (visualize.py:92-102)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write("<html><head></head><body>\n")
        for fig in figs:
            if _have_plotly() and not isinstance(fig, _FallbackFigure):
                f.write(fig.to_html(full_html=False, include_plotlyjs="cdn"))
            else:
                f.write(fig.to_html())
        f.write("</body></html>\n")


def _slider(fig, frames) -> None:
    fig.update_layout(
        sliders=[dict(steps=[dict(method="animate", args=[[fr.name]],
                                  label=fr.name) for fr in frames])],
        scene=dict(aspectmode="data"))


def animate_points(points_seq: Sequence, filename: str,
                   names: Optional[Sequence[str]] = None,
                   point_size: float = 1.5) -> None:
    """Slider animation over point-cloud snapshots (visualize.py:105-128)."""
    go = _go()
    frames = []
    for i, pts in enumerate(points_seq):
        pts = _np(pts).reshape(-1, 3)
        frames.append(go.Frame(
            data=[go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                               mode="markers", marker=dict(size=point_size))],
            name=str(names[i] if names else i)))
    first = _np(points_seq[0]).reshape(-1, 3)
    fig = go.Figure(
        data=[go.Scatter3d(x=first[:, 0], y=first[:, 1], z=first[:, 2],
                           mode="markers", marker=dict(size=point_size))],
        frames=frames)
    _slider(fig, frames)
    figures_to_html([fig], filename)


def animate_mesh(verts_seq: Sequence, faces_seq: Sequence,
                 filename: str) -> None:
    """Slider animation over mesh snapshots (visualize.py:131-151)."""
    go = _go()
    frames = []
    for i, (v, f) in enumerate(zip(verts_seq, faces_seq)):
        v, f = _np(v), _np(f)
        frames.append(go.Frame(
            data=[go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                            i=f[:, 0], j=f[:, 1], k=f[:, 2])],
            name=str(i)))
    v0, f0 = _np(verts_seq[0]), _np(faces_seq[0])
    fig = go.Figure(
        data=[go.Mesh3d(x=v0[:, 0], y=v0[:, 1], z=v0[:, 2],
                        i=f0[:, 0], j=f0[:, 1], k=f0[:, 2])],
        frames=frames)
    _slider(fig, frames)
    figures_to_html([fig], filename)


def plot_3D_quiver(pts_world: Dict[str, object],
                   pts_world_grad: Dict[str, object], filename: str,
                   mesh: Optional[Tuple] = None, n_pts: int = 200) -> None:
    """Each named point set with cones along −grad, the descent direction
    (visualize.py:154-192); sets above `n_pts` points are subsampled by
    RandomState(0)."""
    go = _go()
    traces = []
    if mesh is not None:
        v, f = _np(mesh[0]), _np(mesh[1])
        traces.append(go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                                i=f[:, 0], j=f[:, 1], k=f[:, 2],
                                opacity=0.3, name="mesh"))
    for name, pts in pts_world.items():
        pts = _np(pts).reshape(-1, 3)
        if len(pts) > n_pts:
            sel = np.random.RandomState(0).choice(len(pts), n_pts, replace=False)
            pts = pts[sel]
        else:
            sel = slice(None)
        traces.append(go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                                   mode="markers", marker=dict(size=2),
                                   name=name))
        grad = pts_world_grad.get(name)
        if grad is not None:
            grad = _np(grad).reshape(-1, 3)[sel]
            traces.append(go.Cone(
                x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                u=-grad[:, 0], v=-grad[:, 1], w=-grad[:, 2],
                sizemode="scaled", sizeref=2.0, name=name + "_grad",
                showscale=False))
    fig = go.Figure(data=traces)
    fig.update_layout(scene=dict(aspectmode="data"))
    figures_to_html([fig], filename)


def plot_2D_quiver(pixels, grads, mask_img, filename: str, stride: int = 1,
                   mask_grad_img=None) -> None:
    """Screen-space gradient arrows over the mask image, and the
    mask-image gradient as a signed heatmap when given
    (visualize.py:195-232)."""
    go = _go()
    mask = _np(mask_img).squeeze()
    pixels = _np(pixels).reshape(-1, 2)[::stride]
    grads = _np(grads).reshape(-1, 2)[::stride]
    if _have_plotly():
        import plotly.figure_factory as ff
        fig = ff.create_quiver(pixels[:, 0], pixels[:, 1], -grads[:, 0],
                               -grads[:, 1], scale=10.0, arrow_scale=0.3)
    else:
        fig = go.Figure(data=[go.Scatter(x=pixels[:, 0], y=pixels[:, 1],
                                         u=-grads[:, 0], v=-grads[:, 1],
                                         name="quiver")])
    fig.add_trace(go.Heatmap(z=mask.astype(float), showscale=False,
                             opacity=0.4))
    fig.update_yaxes(autorange="reversed")
    figs = [fig]
    if mask_grad_img is not None:
        g = _np(mask_grad_img)
        if g.ndim == 4:              # (B, S, S, 1) -> the first image
            g = g[0]
        if g.ndim == 3:              # (S, S, 1) or (B, S, S)
            g = g[..., 0] if g.shape[-1] == 1 else g[0]
        gfig = go.Figure(data=[go.Heatmap(z=g.astype(float), colorscale="RdBu",
                                          zmid=0.0, showscale=True)])
        gfig.update_yaxes(autorange="reversed")
        gfig.update_layout(title="mask-image gradient")
        figs.append(gfig)
    figures_to_html(figs, filename)


def plot_iso_surface(sdf_fn: Callable, filename: str, resolution: int = 64,
                     box_side: float = 2.0, level: float = 0.0,
                     device="cuda") -> None:
    """A marching-tetrahedra preview mesh of `sdf_fn` evaluated on `device`
    (visualize.py:235-249)."""
    from isopoints_torch.utils.meshing import extract_mesh

    go = _go()
    half = box_side / 2.0
    v, f = extract_mesh(sdf_fn, resolution, (-half,) * 3, (half,) * 3,
                        level=level, device=device)
    if len(v) == 0:
        figures_to_html([go.Figure()], filename)
        return
    fig = go.Figure(data=[go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                                    i=f[:, 0], j=f[:, 1], k=f[:, 2])])
    fig.update_layout(scene=dict(aspectmode="data"))
    figures_to_html([fig], filename)


def plot_cuts(sdf_fn: Callable, filename: str,
              box_size: Tuple[float, float, float] = (2.2, 2.2, 2.2),
              n_cuts: int = 3, resolution: int = 100, device="cuda") -> None:
    """Contours of `sdf_fn` on `n_cuts` cross-sections along each axis
    (visualize.py:252-279); a section's resolution² points are one call of
    `sdf_fn` on `device`."""
    go = _go()
    figs = []
    for axis in range(3):
        half = [s / 2.0 for s in box_size]
        offsets = np.linspace(-half[axis] * 0.6, half[axis] * 0.6, n_cuts)
        other = [i for i in range(3) if i != axis]
        u = np.linspace(-half[other[0]], half[other[0]], resolution)
        v = np.linspace(-half[other[1]], half[other[1]], resolution)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        for off in offsets:
            pts = np.zeros((resolution * resolution, 3), np.float32)
            pts[:, other[0]] = uu.ravel()
            pts[:, other[1]] = vv.ravel()
            pts[:, axis] = off
            with torch.no_grad():
                vals = _np(sdf_fn(torch.from_numpy(pts).to(device)))
            vals = vals.reshape(resolution, resolution)
            fig = go.Figure(data=go.Contour(
                x=u, y=v, z=vals.T,
                contours=dict(start=-0.2, end=0.2, size=0.02),
                contours_coloring="lines"))
            fig.update_layout(title=f"axis {'xyz'[axis]} = {off:.2f}",
                              width=500, height=500)
            figs.append(fig)
    figures_to_html(figs, filename)
