"""The plain reference of a whole-view render: for each pixel asked for, its
ray, the first place the SDF crosses zero inside the bounding sphere, and
the colour there.

Rays: pixel centres in NDC (+x left, +y up), x_ndc = (S − 2·col − 1)/S,
through a pinhole camera (row-vector world-to-view X·R + T, focal length
and principal point in NDC units). Trace: the chord of the sphere of
radius `radius` is swept at `n_sweep` even steps, the first step at which
the SDF is <= 0 after a positive one brackets the surface, and bisection
narrows the bracket to float32's resolution. Shading: the unit gradient
of the SDF by autograd as the normal, the unit direction from the camera
as the view, the texture's rgb clipped to [0, 1]. A ray that crosses
nothing renders rgb 1, alpha 0; a hit, alpha 1.

No kernel, cache or schedule of the program: every product runs in
`dtype` in blocks of `block` points, float32 with TF32 off for the
reference (`strict_f32`), bfloat16 for its control.
"""

from typing import Callable

import torch


def strict_f32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pixel_rays(R: torch.Tensor, T: torch.Tensor, focal: float, view: torch.Tensor,
               col: torch.Tensor, row: torch.Tensor, size: int):
    """(origins (N, 3), unit directions (N, 3)) of pixels (view, col, row)
    of an S×S image; R (B, 3, 3), T (B, 3)."""
    x = (size - 2.0 * col.float() - 1.0) / size / focal
    y = (size - 2.0 * row.float() - 1.0) / size / focal
    d_view = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    Rv = R[view]
    d = torch.einsum("ni,nji->nj", d_view, Rv)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    center = -torch.einsum("ni,nji->nj", T[view], Rv)
    return center, d


@torch.no_grad()
def first_hit(sdf: Callable, origin: torch.Tensor, d: torch.Tensor,
              radius: float = 1.0, n_sweep: int = 512, n_bisect: int = 24,
              n_refine: int = 2, block: int = 1 << 18):
    """(t (N,), hit (N,), f_min (N,)): the first zero crossing of `sdf`
    along each ray inside the sphere, by an even sweep and bisection, and
    the least SDF value along the ray (the sweep's least, refined
    `n_refine` times by 33 even steps across the two steps beside it): how
    deep a hit enters the surface, or how near a miss passes."""
    b = torch.sum(origin * d, dim=-1)
    c = torch.sum(origin * origin, dim=-1) - radius * radius
    disc = b * b - c
    inside = disc > 0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = torch.clamp(-b - root, min=0.0)
    t1 = torch.clamp(-b + root, min=0.0)
    n = origin.shape[0]
    t = torch.zeros(n, device=origin.device)
    hit = torch.zeros(n, dtype=torch.bool, device=origin.device)
    f_min = torch.full((n,), float("inf"), device=origin.device)
    rays_a_block = max(block // n_sweep, 1)
    steps = torch.linspace(0.0, 1.0, n_sweep, device=origin.device)
    fine = torch.linspace(-1.0, 1.0, 33, device=origin.device)
    for s in range(0, n, rays_a_block):
        sl = slice(s, min(s + rays_a_block, n))
        o, dd = origin[sl], d[sl]
        ts = t0[sl, None] + (t1 - t0)[sl, None] * steps            # (r, S)
        f = sdf((o[:, None, :] + ts[..., None] * dd[:, None, :])
                .reshape(-1, 3)).reshape(ts.shape)
        inner = f <= 0.0
        k = torch.argmax(inner.to(torch.int8), dim=-1)              # first <= 0
        crossed = inner.any(dim=-1) & inside[sl]
        at_entry = crossed & (k == 0)
        lo = torch.gather(ts, 1, torch.clamp(k - 1, min=0)[:, None])[:, 0]
        hi = torch.gather(ts, 1, k[:, None])[:, 0]
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            out = sdf(o + mid[:, None] * dd) > 0.0
            lo = torch.where(out, mid, lo)
            hi = torch.where(out, hi, mid)
        t[sl] = torch.where(at_entry, ts[:, 0], 0.5 * (lo + hi))
        hit[sl] = crossed
        fm, km = torch.min(f, dim=-1)
        tm = torch.gather(ts, 1, km[:, None])[:, 0]
        half = (t1 - t0)[sl] / (n_sweep - 1)
        for _ in range(n_refine):
            tt = torch.clamp(tm[:, None] + half[:, None] * fine,
                             t0[sl, None], t1[sl, None])
            ff = sdf((o[:, None, :] + tt[..., None] * dd[:, None, :])
                     .reshape(-1, 3)).reshape(tt.shape)
            fr, kr = torch.min(ff, dim=-1)
            better = fr < fm
            fm = torch.where(better, fr, fm)
            tm = torch.where(better, torch.gather(tt, 1, kr[:, None])[:, 0], tm)
            half = half / 16.0
        f_min[sl] = torch.where(inside[sl], fm, float("inf"))
    return t, hit, f_min


def shade(sdf: Callable, texture: Callable, origin: torch.Tensor,
          d: torch.Tensor, t: torch.Tensor, hit: torch.Tensor,
          block: int = 1 << 16) -> torch.Tensor:
    """RGBA (N, 4) of the rays at depth t: the texture at hits, white
    and transparent elsewhere."""
    out = torch.ones((origin.shape[0], 4), device=origin.device)
    out[:, 3] = hit.float()
    idx = torch.nonzero(hit)[:, 0]
    for s in range(0, idx.shape[0], block):
        i = idx[s:s + block]
        p = (origin[i] + t[i, None] * d[i]).detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(sdf(p).sum(), p)
        p = p.detach()
        normal = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                                 min=1e-12)
        v = p - origin[i]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=1e-12)
        with torch.no_grad():
            out[i, :3] = torch.clamp(texture(normal, p, v), 0.0, 1.0)
    return out


def render_pixels(sdf: Callable, texture: Callable, R: torch.Tensor,
                  T: torch.Tensor, focal: float, view: torch.Tensor,
                  col: torch.Tensor, row: torch.Tensor, size: int,
                  radius: float = 1.0, n_sweep: int = 512) -> torch.Tensor:
    """(RGBA (N, 4), least SDF along each ray (N,)) of pixels (view, col,
    row) of an S×S render."""
    origin, d = pixel_rays(R, T, focal, view, col, row, size)
    t, hit, f_min = first_hit(sdf, origin, d, radius, n_sweep)
    return shade(sdf, texture, origin, d, t, hit), f_min
