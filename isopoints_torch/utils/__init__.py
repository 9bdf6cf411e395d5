"""Tensor utilities (port of isopoints_tpu/utils/__init__.py): denominators
and roots away from zero, the padded-and-masked helpers of the point-set
layout (`(B, P, C)` arrays with a `(B, P)` bool mask), class lookup by a
dotted path inside the port, and the host-side colour map and image grid."""

import importlib
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from isopoints_torch import tracing
from isopoints_torch.logger import get_logger


def eps_denom(x: torch.Tensor, eps: float = 1e-17) -> torch.Tensor:
    """Push a denominator away from zero, preserving sign
    (utils/__init__.py:20)."""
    sign = torch.where(x < 0.0, -1.0, 1.0)
    return sign * torch.maximum(x.abs(), torch.full_like(x, eps))


def eps_sqrt(x: torch.Tensor, eps: float = 1e-17) -> torch.Tensor:
    """|x| clamped to >= eps, for a sqrt the caller takes
    (utils/__init__.py:30)."""
    return torch.clamp(torch.abs(x), min=eps)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once, as a fused multiply-add (XLA fuses the
    ray-point and depth formulas of the JAX package into FMAs; the CUDA
    kernels use __fmaf_rn). A float32 product is exact in float64."""
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), c.dtype)
    return torch.addcmul(c.double(), a.double(), b.double()).to(dtype)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's (vsqrtss) and CUDA's
    sqrtf. torch.sqrt on CPU float32 is off by an ulp for ~0.6% of
    inputs; a float32 root taken in float64 rounds once."""
    return torch.sqrt(x.double()).to(x.dtype)


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` along the last axis: the k largest, descending, equal
    values in index order (torch.topk does not promise that order).
    Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nanmedian_mid(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries along the last axis, the mean of the
    two middle ones for an even count (numpy's and `jnp.nanmedian`'s
    midpoint rule: (lo + hi)·0.5, where `torch.nanmedian` returns the
    lower one); NaN where all are NaN. Device ops only."""
    s = torch.sort(x, dim=-1).values            # NaN sorts last
    n = torch.sum(~torch.isnan(x), dim=-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = n // 2
    return ((torch.gather(s, -1, lo) + torch.gather(s, -1, hi)) * 0.5)[..., 0]


def linspace01(n: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0, 1, n)` bit for bit in float32: i·fl(1/(n-1)) for
    i < n-1, then exactly 1 (XLA multiplies by the rounded reciprocal;
    torch.linspace rounds some entries differently)."""
    if n == 1:
        return torch.zeros(1, device=device)
    inv = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    if inv.is_cuda:
        tracing.count("host_syncs.copy")    # a host-to-device copy waits
    head = torch.arange(n - 1, dtype=torch.float32, device=device) * inv
    return torch.cat([head, torch.ones(1, device=device)])


def check_weights(module: nn.Module) -> bool:
    """NaN/Inf guard over a module's parameters (utils/__init__.py:42).
    Returns True if all are finite; logs offenders."""
    ok = True
    for name, p in module.named_parameters():
        if p.is_floating_point() and not torch.isfinite(p).all():
            get_logger().warning("non-finite values in %s", name)
            ok = False
    return ok


def valid_value_mask(x: torch.Tensor) -> torch.Tensor:
    """Finite-value mask (utils/__init__.py:37)."""
    return torch.isfinite(x)


_JAX_PACKAGE = "isopoints_tpu."
_PACKAGE = "isopoints_torch."


def get_class_from_string(cls_str: str):
    """The class a dotted path `pkg.mod.Class` names (utils/__init__.py:60),
    looked up inside this package only: a leading `isopoints_tpu.` (a config
    written for the JAX package) is read as `isopoints_torch.`. A path that
    names no class of the port raises ValueError."""
    if cls_str.startswith(_JAX_PACKAGE):
        cls_str = _PACKAGE + cls_str[len(_JAX_PACKAGE):]
    mod_name, _, cls_name = cls_str.rpartition(".")
    if not (mod_name + ".").startswith(_PACKAGE):
        raise ValueError(f"{cls_str!r} names no class of isopoints_torch")
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        raise ValueError(f"{cls_str!r} names no module of isopoints_torch") from None
    cls = getattr(mod, cls_name, None)
    if not isinstance(cls, type):
        raise ValueError(f"{cls_str!r} names no class of isopoints_torch")
    return cls


def slice_dict(d: Dict[str, Any], idx) -> Dict[str, Any]:
    """Index every value of a dict, None kept (utils/__init__.py:67)."""
    return {k: (v[idx] if v is not None else None) for k, v in d.items()}


# matplotlib's "jet" (its _cm._jet_data): (x, y below x, y above x) a channel
_JET = (((0.0, 0.0, 0.0), (0.35, 0.0, 0.0), (0.66, 1.0, 1.0), (0.89, 1.0, 1.0),
         (1.0, 0.5, 0.5)),
        ((0.0, 0.0, 0.0), (0.125, 0.0, 0.0), (0.375, 1.0, 1.0),
         (0.64, 1.0, 1.0), (0.91, 0.0, 0.0), (1.0, 0.0, 0.0)),
        ((0.0, 0.5, 0.5), (0.11, 1.0, 1.0), (0.34, 1.0, 1.0), (0.65, 0.0, 0.0),
         (1.0, 0.0, 0.0)))
_CMAP_N = 256


def _jet_lut() -> np.ndarray:
    """The (256, 3) lookup table matplotlib builds from `_JET`
    (colors._create_lookup_table, gamma 1)."""
    xind = (_CMAP_N - 1) * np.linspace(0, 1, _CMAP_N)
    lut = []
    for data in _JET:
        a = np.asarray(data)
        x, y0, y1 = a[:, 0] * (_CMAP_N - 1), a[:, 1], a[:, 2]
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut.append(np.clip(np.concatenate(
            [[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]]),
            0.0, 1.0))
    return np.stack(lut, -1)


def scaler_to_color(scalar: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """A scalar array to RGB in [0, 1] over its own [min, max]
    (utils/__init__.py:72), as matplotlib's "jet" gives it: 256 colours,
    NaN black. The JAX package asks matplotlib, which the GPU machine
    lacks; the port carries the one colour map its callers name."""
    if cmap != "jet":
        raise ValueError(f"scaler_to_color carries the 'jet' colour map only, "
                         f"got {cmap!r}")
    scalar = np.asarray(scalar, dtype=np.float64)
    lo, hi = np.nanmin(scalar), np.nanmax(scalar)
    hi = hi if hi > lo else lo + 1.0
    x = (scalar - lo) / (hi - lo) * _CMAP_N
    x[x == _CMAP_N] = _CMAP_N - 1
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        i = np.clip(x, -1, _CMAP_N).astype(int)
    out = _jet_lut()[np.clip(i, 0, _CMAP_N - 1)]
    out[bad] = 0.0
    return out


# ---------------------------------------------------------------------------
# Padded/mask helpers (utils/__init__.py:87-139)
# ---------------------------------------------------------------------------

def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int -> (B, max_len) bool."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def num_valid(mask: torch.Tensor) -> torch.Tensor:
    """Valid entries a row: (B, P) -> (B,) int64."""
    return torch.sum(mask.long(), dim=-1)


mask_to_lengths = num_valid


def _expand_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    return m


def masked_sum(x: torch.Tensor, mask: torch.Tensor, axis=None,
               keepdims: bool = False) -> torch.Tensor:
    """Sum of x over the entries `mask` selects (mask broadcast on x's
    trailing axes)."""
    xm = x * _expand_mask(x, mask)
    return xm.sum() if axis is None else torch.sum(xm, dim=axis, keepdim=keepdims)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                keepdims: bool = False) -> torch.Tensor:
    """Mean of x over the entries `mask` selects: the masked sum over the
    count of selected mask entries (at least 1), the mask not broadcast on
    x's trailing axes (utils/__init__.py:95-103)."""
    m = _expand_mask(x, mask)
    den = m.sum() if axis is None else torch.sum(m, dim=axis, keepdim=keepdims)
    return masked_sum(x, mask, axis, keepdims) / torch.clamp(den, min=1.0)


def compact_padded(points: torch.Tensor, mask: torch.Tensor):
    """Valid rows first in each batch row, in their order (a stable sort of
    ~mask). points (B, P, C), mask (B, P) -> both reordered."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, points.shape[-1]))
    return pts, torch.gather(mask, 1, order)


def gather_padded(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, P, C), idx (B, K) -> (B, K, C); a negative index reads row 0."""
    safe = torch.clamp(idx, min=0)
    return torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[-1]))


def resize_padded(points: torch.Tensor, mask: torch.Tensor, new_p: int):
    """Capacity P -> new_p: zero rows appended, or the tail cut (valid
    entries front-compacted first)."""
    b, p, c = points.shape
    if new_p == p:
        return points, mask
    if new_p > p:
        return (torch.cat([points, points.new_zeros((b, new_p - p, c))], 1),
                torch.cat([mask, mask.new_zeros((b, new_p - p))], 1))
    return points[:, :new_p], mask[:, :new_p]


def make_image_grid(images: Sequence[np.ndarray], ncols: int = 4,
                    pad: int = 2) -> np.ndarray:
    """Tile H x W (x 3) images into one grid, row by row, `pad` pixels of
    ones between (utils/__init__.py:156)."""
    images = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    n = len(images)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.ones((nrows * (h + pad) - pad, ncols * (w + pad) - pad, 3),
                   dtype=images[0].dtype)
    for i, im in enumerate(images):
        r, c = divmod(i, ncols)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        grid[r * (h + pad): r * (h + pad) + im.shape[0],
             c * (w + pad): c * (w + pad) + im.shape[1]] = im[..., :3]
    return grid
