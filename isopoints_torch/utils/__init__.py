"""Tensor utilities (port of isopoints_tpu/utils/__init__.py, the parts
the ported steps need)."""

import torch
from torch import nn

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
