"""Whether the window's renders are right: a sample, drawn from the seed,
of the pixels of the requests the window completed, compared with the
plain reference (reference/) rendering the same pixels of the same
cameras from the same weights.

The numbers compared (each against the cell's `limits/<cell>.json`):
- `px_off`: the share of sampled pixels whose RGBA differs from the
  reference's by more than TOL = 2^-12 (a sixteenth of an 8-bit level) in
  any channel; a hit on one side and not the other counts, so it covers
  the ray engine (which rays hit) and the shading (the colour at a hit).
  TOL lies between float32's colour error here (~1e-6 at the median) and
  bfloat16's (~1e-3).
- `rgb_err_med`: the median over the pixels both sides hit of the largest
  channel gap, which the value+grad normals and the texture set.
Further readings are printed beside them and judge nothing; `f_min` in
them is the reference's least SDF along a ray, how deep a hit that the
other side missed enters the surface (or how near a miss passes).
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import fields, render

TOL = 2.0 ** -12


def sample(n_requests: int, rays_per_request: int, check: dict, seed: int
           ) -> List[Tuple[int, np.ndarray]]:
    """[(request index, flat pixel indices into views·size·size)] of the
    check: `check["requests"]` of the completed requests (the last one
    always among them), `check["rays"]` pixels split evenly."""
    g = np.random.default_rng([int(seed) % (1 << 63), 17])
    k = min(int(check["requests"]), n_requests)
    picks = {n_requests - 1}
    if k > 1:
        picks |= set(g.choice(n_requests - 1, size=k - 1,
                              replace=False).tolist())
    per = int(check["rays"]) // len(picks)
    return [(i, np.sort(g.choice(rays_per_request, size=per, replace=False)))
            for i in sorted(picks)]


def reference_rgba(model: dict, weights: dict, R: torch.Tensor,
                   T: torch.Tensor, focal: float, pixels: np.ndarray,
                   size: int, device, dtype=torch.float32,
                   n_sweep: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RGBA (N, 4), least SDF along each ray (N,)) of the reference at
    the flat pixel indices of one request (view-major, then row, then
    column)."""
    render.strict_f32()
    p = torch.as_tensor(pixels, device=device)
    view, rest = p // (size * size), p % (size * size)
    row, col = rest // size, rest % size
    sdf = fields.sdf_fn(model, weights["decoder"], dtype)
    tex = fields.texture_fn(model, weights["texture"], dtype)
    radius = model.get("implicit_kwargs", {}).get("object_bounding_sphere", 1.0)
    return render.render_pixels(sdf, tex, R.to(device), T.to(device), focal,
                                view, col, row, size, radius, n_sweep)


def numbers(ours: np.ndarray, ref: np.ndarray, f_min: np.ndarray
            ) -> Dict[str, float]:
    """The comparison's readings of (N, 4) RGBA rows and the reference's
    least SDF along each ray."""
    gap = np.abs(ours.astype(np.float64) - ref.astype(np.float64))
    worst = gap.max(axis=1)
    a_ours, a_ref = ours[:, 3] > 0.5, ref[:, 3] > 0.5
    both = a_ours & a_ref
    rgb = gap[both, :3].max(axis=1) if both.any() else np.zeros(1)
    n = max(len(ours), 1)
    near = np.abs(f_min)
    out = {
        "px_off": float(np.mean(worst > TOL)),
        "rgb_err_med": float(np.median(rgb)),
        "alpha_off": float(np.mean(a_ours != a_ref)),
        "hit_only_ref": float(np.sum(a_ref & ~a_ours) / n),
        "hit_only_ours": float(np.sum(a_ours & ~a_ref) / n),
        "rgb_err_p99": float(np.quantile(rgb, 0.99)),
        "hit_share": float(np.mean(a_ref)),
        "rays": float(len(ours)),
    }
    for side, m in (("ref", a_ref & ~a_ours), ("ours", a_ours & ~a_ref)):
        for e in (1e-4, 1e-3):
            out[f"only_{side}_beyond_{e:g}"] = float(np.sum(m & (near > e)) / n)
        if m.any():
            out[f"only_{side}_fmin_max"] = float(near[m].max())
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}): every limited number at or
    under its limit, and finite."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = readings.get(k, math.nan)
        out[k] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out


def compare(model: dict, weights: dict, outputs: List[np.ndarray],
            cams: List[Tuple[torch.Tensor, torch.Tensor]], traffic,
            check: dict, seed: int, device,
            control: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The readings of the sampled pixels of the completed requests'
    outputs ((views, S, S, 4) arrays) against the reference; with
    `control` a dtype, the reference computed in it stands in for the
    program's outputs (the control)."""
    size = traffic.size
    ours, ref, fmin = [], [], []
    for i, px in sample(len(outputs), traffic.rays_per_request, check, seed):
        R, T = cams[i]
        r, fm = reference_rgba(model, weights, R, T, traffic.focal, px, size,
                               device)
        ref.append(r.cpu().numpy())
        fmin.append(fm.cpu().numpy())
        if control is None:
            ours.append(outputs[i].reshape(-1, 4)[px])
        else:
            ours.append(reference_rgba(model, weights, R, T, traffic.focal,
                                       px, size, device, control)[0]
                        .cpu().numpy())
    return numbers(np.concatenate(ours), np.concatenate(ref),
                   np.concatenate(fmin))
