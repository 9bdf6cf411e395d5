"""FLOP and byte counts of the render's MLP evaluations: the frozen
yardstick of `mfu_pct.render` and the kernels' rooflines.

Everything here is worked out from a configuration's file and a launch's
shape, never read from the program, so it counts the same work whatever
implements it. Only products count as FLOPs (2 a multiply-add); the
activations, the encoding and the weight norm are left out, so a share
against a peak is a lower bound.

A value+grad is counted as the least any implementation needs: one
forward pass and one reverse-mode pass (2x the forward's products). The
program's kernels carry three forward-mode tangents (4x), which would let
a faster kernel read over 100% if counted so.

The trace schedule is counted as its upper bound, as the program's bench
counted it (`isopoints_torch/bench.trace_roofline`, generalised): every
front marched to the end of its stage, each compaction stage at its
capacity, the sampler buffer at its capacity, plus the value+grad and the
texture that shading makes on every ray.
"""

import json
import math
import os
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))

# RayTracingConfig's defaults where a configuration leaves a key out
RAYTRACE_DEFAULTS = {
    "line_search_step": 0.5, "line_step_iters": 1, "n_steps": 100,
    "n_secant_steps": 8, "sampler_fraction": 1.0, "trace_compact_after": 0,
    "trace_compact_fraction": 0.25, "sampler_coarse": False,
    "fused_backstep": False, "coarse_stall_on_cross": False,
    "trace_compact_coarse": False, "sampler_presweep": 0,
    "sampler_dense_fraction": 0.5,
}
# `Generator.render_cfg`: renders trace at least this many iterations
RENDER_MIN_ITERS = 20


def peaks() -> Dict[str, float]:
    """The card's peaks (peaks.json): FLOP/s by precision, bytes/s."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return {k: float(v) for k, v in json.load(f)["peaks"].items()}


# ---------------------------------------------------------------------------
# Layer shapes
# ---------------------------------------------------------------------------

def encoded_width(num_frequencies: int, dims: int = 3) -> int:
    """Input width after a NeRF encoding [x, sin, cos per octave]."""
    return dims + (dims * 2 * num_frequencies if num_frequencies > 0 else 0)


def decoder_products(model: dict) -> List[Tuple[int, int]]:
    """(in, out) of every product of the SDF decoder of a `model` block:
    `siren` (first layer, `n_layers` hidden, the head) or `sdf` (IGR:
    `n_layers` layers, the encoded input concatenated back at `skip_in`,
    so the layer before a skip gives width − input)."""
    kw = model.get("decoder_kwargs", {})
    kind = model.get("decoder_type", "siren")
    if kind == "siren":
        h, n = kw.get("hidden_size", 256), kw.get("n_layers", 3)
        return [(3, h)] + [(h, h)] * n + [(h, 1)]
    if kind == "sdf":
        h, n = kw.get("hidden_size", 512), kw.get("n_layers", 8)
        skip = tuple(kw.get("skip_in", (4,)))
        d0 = encoded_width(kw.get("num_frequencies", 6))
        dims = [d0] + [h] * n + [1]
        out = []
        for l in range(len(dims) - 1):
            o = dims[l + 1] - (d0 if l + 1 in skip else 0)
            out.append((dims[l], o))
        return out
    raise ValueError(f"no FLOP count for decoder_type {kind!r}")


def texture_products(model: dict) -> List[Tuple[int, int]]:
    """(in, out) of the neural texture's products: [normal, point,
    encoded view] in, `n_layers` hidden, rgb out; none for Phong."""
    if model.get("implicit_kwargs", {}).get("texture_type") != "neural":
        return []
    kw = model.get("texture_kwargs", {})
    h, n = kw.get("hidden_size", 512), kw.get("n_layers", 4)
    d_in = (kw.get("dim", 9) + kw.get("c_dim", 0)
            + encoded_width(kw.get("num_frequencies", 4)) - 3)
    dims = [d_in] + [h] * n + [3]
    return list(zip(dims[:-1], dims[1:]))


def macs(products: List[Tuple[int, int]]) -> int:
    return sum(a * b for a, b in products)


def params(products: List[Tuple[int, int]]) -> int:
    return sum(a * b + b for a, b in products)


def has_kernel(model: dict) -> bool:
    """Whether the configured field runs on the fused kernels (and so has
    a bf16 coarse callable): `use_fused_mlp` on a SIREN, or on an IGR
    field without encoding."""
    if not model.get("implicit_kwargs", {}).get("use_fused_mlp", False):
        return False
    kind = model.get("decoder_type", "siren")
    kw = model.get("decoder_kwargs", {})
    return kind == "siren" or (kind == "sdf"
                               and kw.get("num_frequencies", 6) <= 0)


# ---------------------------------------------------------------------------
# The render schedule
# ---------------------------------------------------------------------------

def render_trace_cfg(model: dict) -> dict:
    """The trace settings a render runs: the model's, with the defaults,
    `sphere_tracing_iters` floored at RENDER_MIN_ITERS."""
    ik = model.get("implicit_kwargs", {})
    rt = dict(RAYTRACE_DEFAULTS)
    rt["sphere_tracing_iters"] = ik.get("proj_max_iters", 10)
    rt["coarse_trace_iters"] = ik.get("coarse_trace_iters", 0)
    rt.update(ik.get("raytrace") or {})
    rt["sphere_tracing_iters"] = max(rt["sphere_tracing_iters"],
                                     RENDER_MIN_ITERS)
    return rt


def _stages(rt: dict) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    raw, fr = rt["trace_compact_after"], rt["trace_compact_fraction"]
    if isinstance(raw, int):
        raw = (raw,) if raw > 0 else ()
    if isinstance(fr, (int, float)):
        fr = (float(fr),) * len(raw)
    keep = [(a, f) for a, f in zip(raw, fr)
            if 0 < a < rt["sphere_tracing_iters"]]
    return tuple(a for a, _ in keep), tuple(f for _, f in keep)


def _cap(n: int, frac: float, n_cur: Optional[int] = None) -> int:
    c = max(int(math.ceil(n * frac)), 1)
    return min(c, n if n_cur is None else n_cur)


def evals_per_ray(model: dict, rays_per_view_chunk: int) -> Dict[str, float]:
    """Upper bound of the SDF value evaluations a rendered ray gets, by
    precision ({"bf16": .., "f32": ..}), for chunks of
    `rays_per_view_chunk` rays a view (the capacities are per view)."""
    rt = render_trace_cfg(model)
    n = rays_per_view_chunk
    coarse = has_kernel(model) and rt["coarse_trace_iters"] > 0
    stages, fracs = _stages(rt)
    iters = rt["sphere_tracing_iters"]
    full_end = stages[0] if stages else iters
    coarse_end = min(rt["coarse_trace_iters"], full_end) if coarse else 0
    fine_per_it = 1 if rt["fused_backstep"] else 1 + rt["line_step_iters"]
    lsi = 1 + rt["line_step_iters"]
    ev = {"bf16": 0.0, "f32": 0.0}
    if coarse_end > 0:
        per_it = 1 if rt["coarse_stall_on_cross"] else lsi
        ev["bf16"] += 2.0 * (1 + coarse_end * per_it)
        ev["f32"] += 2.0                      # the fine re-validation
    else:
        ev["f32"] += 2.0
    ev["f32"] += 2.0 * (full_end - coarse_end) * fine_per_it
    bounds = list(stages[1:]) + [iters]
    n_cur = n
    for a, nxt, f in zip(stages, bounds, fracs):
        cap = _cap(n, f, n_cur)
        n_cur = cap
        share = cap / n
        stage_coarse = coarse and (rt["trace_compact_coarse"]
                                   or nxt <= rt["coarse_trace_iters"])
        if stage_coarse:
            per_it = 1 if rt["coarse_stall_on_cross"] else lsi
            ev["bf16"] += 2.0 * (nxt - a) * per_it * share
            ev["f32"] += 2.0 * share          # its fine re-validation
        else:
            ev["f32"] += 2.0 * (nxt - a) * fine_per_it * share
    sf = 1.0 if rt["sampler_fraction"] >= 1.0 else \
        _cap(n, rt["sampler_fraction"]) / n
    sweep = "bf16" if (coarse and rt["sampler_coarse"]) else "f32"
    reval = 2.0 if sweep == "bf16" else 0.0
    tail = reval + rt["n_secant_steps"]
    if rt["sampler_presweep"] >= 2:
        df = _cap(max(int(round(sf * n)), 1), rt["sampler_dense_fraction"]) \
            / max(int(round(sf * n)), 1)
        ev[sweep] += sf * rt["sampler_presweep"]
        ev[sweep] += sf * df * rt["n_steps"]
        ev["f32"] += sf * df * tail
    else:
        ev[sweep] += sf * rt["n_steps"]
        ev["f32"] += sf * tail
    return ev


def render_flops_per_ray(model: dict, rays_per_view_chunk: int) -> float:
    """Counted FLOPs of one rendered ray: the schedule's value
    evaluations, one value+grad (reverse mode: 2x a value) and one
    texture evaluation."""
    v = 2.0 * macs(decoder_products(model))
    ev = evals_per_ray(model, rays_per_view_chunk)
    tex = 2.0 * macs(texture_products(model))
    return (ev["bf16"] + ev["f32"]) * v + 2.0 * v + tex


# ---------------------------------------------------------------------------
# Launch rooflines
# ---------------------------------------------------------------------------

def least_seconds(flops_bf16: float, flops_f32: float, hbm_bytes: float,
                  pk: Dict[str, float]) -> float:
    """The least time the card could take: the tensor-core products (bf16
    and f32, one after the other on the same units) or the bytes,
    whichever bounds. f32 products count at the TF32 rate, which no
    f32-accurate product beats."""
    t_mma = flops_bf16 / pk["bf16_flops"] + flops_f32 / pk["tf32_flops"]
    return max(t_mma, hbm_bytes / pk["hbm_bytes"])


def mlp_launch(products: List[Tuple[int, int]], n_points: int, bf16: bool,
               with_grad: bool) -> Tuple[float, float, float]:
    """(bf16 FLOPs, f32 FLOPs, bytes) of one MLP kernel launch on
    `n_points` points: inputs and outputs once, weights once."""
    fl = 2.0 * n_points * macs(products) * (2 if with_grad else 1)
    w = params(products) * (2 if bf16 else 4)
    io = n_points * (12 + 4 + (12 if with_grad else 0))
    return (fl, 0.0, io + w) if bf16 else (0.0, fl, io + w)


def sampler_launch(products: List[Tuple[int, int]], n_rays: int,
                   n_steps: int, n_secant: int, coarse_sweep: bool,
                   fine_bf16: bool) -> Tuple[float, float, float]:
    """(bf16 FLOPs, f32 FLOPs, bytes) of one sampler kernel launch: the
    sweep's `n_steps` values a ray (bf16 under `coarse_sweep`), the
    bracket's two re-validated values when coarse, and `n_secant` secant
    values at the fine precision; rays in and picks out once, weights
    once a precision."""
    v = 2.0 * macs(products)
    sweep_bf16 = coarse_sweep or fine_bf16
    sweep = n_rays * n_steps * v
    tail = n_rays * ((2 if coarse_sweep else 0) + n_secant) * v
    bf = (sweep if sweep_bf16 else 0.0) + (tail if fine_bf16 else 0.0)
    f32 = (0.0 if sweep_bf16 else sweep) + (0.0 if fine_bf16 else tail)
    w = params(products) * ((2 if sweep_bf16 else 4)
                            + ((4 if not fine_bf16 else 2) if coarse_sweep
                               else 0))
    io = n_rays * (12 + 12 + 4 + 4 + 16) + 4 * n_steps
    return bf, f32, io + w
