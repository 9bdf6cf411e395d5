"""DSS occupancy backward (the rasterizer's xy gradient): a hand-written
CUDA kernel and its plain version.

For every renderable point of each cloud, the sum over the pixels of a W×W
patch around it of (pixel − point)/dist²·grad_occ, over the pixels with
grad_occ ≠ 0 within the per-cloud search radius, leaving out pixels with
grad_occ > 0 outside the point's own splat bbox (the reference's
production backward, rasterize_points_backward.cu:99-178).

The kernels (csrc/occ_bwd.cu) replace `occ_backward_pallas_one`
(isopoints_tpu/rendering/pallas_occ_bwd.py:41, pallas_call :145). One C
call for all B clouds launches two kernels: a cluster a cloud finds the
renderable points, the search radius (the two middle radii by radix
selection, no sort) and a list of the renderable points bucketed by patch
origin, cut into chunks; then a block a chunk stages the cotangent's halo
in shared memory and a warp a point walks its patch, with a fixed shuffle
tree per point and no atomics in the sums. Bound on an H100 (`occ_work`
counts the work): ~15 FLOP per term of the sums and a compare per other
nonzero pixel of a point's window, or the bytes, whichever takes longer.

The plain version is the XLA formulation `_occ_backward_one`
(isopoints_tpu/rendering/rasterizer.py:481-570), cloud by cloud: (W, W)
patches gathered for chunks of 2048 points. W = min(backward_patch_pixels,
S). The search radius is the median of the renderable points' radii (both
axes) times `radii_backward_scaler`, clamped to (W/2 − 2) pixels when W <
S so the patch covers it. `jnp.nanmedian` averages the two middle values
of an even count where `torch.nanmedian` returns the lower one, so
`nanmedian_mid` computes the average on the device.

`occ_backward` launches the kernels for CUDA tensors and runs the plain
version for CPU tensors; `occ_backward_one` is its one-cloud case.
"""

import ctypes
import functools
from typing import Tuple

import torch

from isopoints_torch.ops import _build
from isopoints_torch.rendering.select import pixel_ndc
from isopoints_torch.utils import eps_denom, nanmedian_mid

KERNEL = _build.LaunchCount("occ_bwd")
CHUNK = 2048          # points per patch gather of the plain version

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("occ_bwd")
    lib.occ_backward.argtypes = ([_P] * 4 + [_L] * 3 + [_I] * 4 + [_F] * 3
                                 + [_I, _P, _P, _L, _P])
    lib.occ_backward.restype = _I
    lib.occ_scratch_ints.argtypes = [_I]
    lib.occ_scratch_ints.restype = _L
    return lib


def backward_window(pts: torch.Tensor, radii: torch.Tensor,
                    visible: torch.Tensor, settings
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(renderable (P,) bool, search_r² () float32 on the device, W) of one
    cloud (rasterizer.py:511-523)."""
    S = settings.image_size
    W = min(settings.backward_patch_pixels, S)
    px, py, z = pts[:, 0], pts[:, 1], pts[:, 2]
    renderable = (visible & (z >= 0) & (torch.abs(px) <= 1.0)
                  & (torch.abs(py) <= 1.0))
    r_flat = torch.where(renderable[:, None], radii, float("nan")).reshape(-1)
    search_r = torch.nan_to_num(nanmedian_mid(r_flat), nan=1e-3) * \
        settings.radii_backward_scaler
    if W < S:
        # the patch must cover the window; when it is the image, any
        # radius is covered
        search_r = torch.clamp(search_r, max=(W / 2.0 - 2.0) * 2.0 / S)
    return renderable, search_r * search_r, W


def _patch_origin(ndc: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """First patch row/column: the point's pixel (S(1 − ndc) − 1)/2 rounded
    half to even, minus W/2, clipped to [0, S − W] (rasterizer.py:529-532;
    non-finite coordinates of points that are not renderable map to 0)."""
    f = torch.nan_to_num((S * (1.0 - ndc) - 1.0) * 0.5)
    f = torch.clamp(f, -2.0 * S, 2.0 * S)
    return torch.clamp(torch.round(f).long() - W // 2, 0, S - W)


def _patch_terms(pts: torch.Tensor, radii: torch.Tensor,
                 visible: torch.Tensor, grad_occ: torch.Tensor, settings):
    """One cloud's (W, W) patches, CHUNK points at a time: yields (dx, dy,
    dist², patch, in_window, use), each (n, W, W). in_window: a renderable
    point's pixel with a nonzero cotangent and dist² ≤ search_r²; use: one
    of those past the positive-gradient gate, a term of the sum."""
    S = settings.image_size
    renderable, search_r2, W = backward_window(pts, radii, visible, settings)
    px, py = pts[:, 0], pts[:, 1]
    c0, r0 = _patch_origin(px, S, W), _patch_origin(py, S, W)
    w_idx = torch.arange(W, device=pts.device)
    for lo in range(0, pts.shape[0], CHUNK):
        sl = slice(lo, lo + CHUNK)
        rows = r0[sl, None] + w_idx                             # (n, W)
        cols = c0[sl, None] + w_idx
        patch = grad_occ[rows[:, :, None], cols[:, None, :]]     # (n, W, W)
        dx = (pixel_ndc(cols, S) - px[sl, None])[:, None, :]     # (n, 1, W)
        dy = (pixel_ndc(rows, S) - py[sl, None])[:, :, None]     # (n, W, 1)
        dx, dy = torch.broadcast_tensors(dx, dy)
        dist2 = dx * dx + dy * dy
        outside = ((torch.abs(dx) > radii[sl, 0, None, None])
                   | (torch.abs(dy) > radii[sl, 1, None, None]))
        in_window = ((dist2 <= search_r2) & (patch != 0.0)
                     & renderable[sl, None, None])
        use = in_window & ~((patch > 0.0) & outside)
        yield dx, dy, dist2, patch, in_window, use


def occ_backward_one_plain(pts: torch.Tensor, radii: torch.Tensor,
                           visible: torch.Tensor, grad_occ: torch.Tensor,
                           settings) -> torch.Tensor:
    """Plain version for one cloud: pts (P, 3) [x_ndc, y_ndc, depth], radii
    (P, 2), visible (P,) bool, grad_occ (S, S) -> (P, 2) xy gradient."""
    out = []
    for dx, dy, dist2, patch, _, use in _patch_terms(pts, radii, visible,
                                                     grad_occ, settings):
        denom = eps_denom(dist2, 1e-10)
        gx = torch.where(use, dx / denom * patch, 0.0).sum(dim=(1, 2))
        gy = torch.where(use, dy / denom * patch, 0.0).sum(dim=(1, 2))
        out.append(torch.stack([gx, gy], dim=-1))
    if not out:
        return pts.new_zeros((0, 2))
    return torch.cat(out).to(pts.dtype)


def occ_backward_plain(pts: torch.Tensor, radii: torch.Tensor,
                       visible: torch.Tensor, grad_occ: torch.Tensor,
                       settings) -> torch.Tensor:
    """Plain version for B clouds: pts (B, P, 3), radii (B, P, 2), visible
    (B, P) bool, grad_occ (B, S, S) -> (B, P, 2), cloud by cloud."""
    return torch.stack([occ_backward_one_plain(pts[i], radii[i], visible[i],
                                               grad_occ[i], settings)
                        for i in range(pts.shape[0])])


def occ_work(pts: torch.Tensor, radii: torch.Tensor, visible: torch.Tensor,
             grad_occ: torch.Tensor, settings) -> Tuple[int, int]:
    """The work B clouds' gradients need, for a bound: (the (point, pixel)
    pairs that are terms of the sums, the pairs of a renderable point and a
    pixel of its window with a nonzero cotangent, terms included)."""
    terms = window = 0
    for i in range(pts.shape[0]):
        for *_, in_window, use in _patch_terms(pts[i], radii[i], visible[i],
                                               grad_occ[i], settings):
            terms += int(use.sum())
            window += int(in_window.sum())
    return terms, window


def launch(pts: torch.Tensor, radii: torch.Tensor, visible: torch.Tensor,
           grad_occ: torch.Tensor, settings
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One C call for B clouds: (the (B, P, 2) gradient, the scratch it
    leaves: `window_of` reads the renderable points and the search radius
    from it)."""
    S = settings.image_size
    for t in (pts, radii, visible, grad_occ):
        if not t.is_cuda or t.device != pts.device:
            raise ValueError("occ_backward_cuda takes CUDA tensors on one device")
    if (pts.dtype != torch.float32 or radii.dtype != torch.float32
            or grad_occ.dtype != torch.float32 or visible.dtype != torch.bool):
        raise TypeError("occ_backward_cuda takes float32 points, radii and "
                        "cotangents and bool visibility")
    b, p = pts.shape[:2]
    if pts.shape != (b, p, 3) or radii.shape != (b, p, 2) \
            or visible.shape != (b, p) or grad_occ.shape != (b, S, S):
        raise ValueError("occ_backward_cuda takes pts (B, P, 3), radii (B, P, 2), "
                         "visible (B, P) and grad_occ (B, S, S)")
    W = min(settings.backward_patch_pixels, S)
    pc, rc, vc = pts.contiguous(), radii.contiguous(), visible.contiguous()
    out = torch.empty((b, p, 2), dtype=torch.float32, device=pts.device)
    lib = _lib()
    scratch = torch.empty((b, lib.occ_scratch_ints(p)), dtype=torch.int32,
                          device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    KERNEL.launch(b * p)
    err = lib.occ_backward(pc.data_ptr(), rc.data_ptr(), vc.data_ptr(),
                           grad_occ.data_ptr(), *grad_occ.stride(), b, p, S, W,
                           1.0 / S, settings.radii_backward_scaler,
                           (W / 2.0 - 2.0) * 2.0 / S, int(W < S),
                           out.data_ptr(), scratch.data_ptr(), scratch.numel(),
                           stream)
    _build.check_launch(lib, err, "occ_bwd")
    return out, scratch


def window_of(scratch: torch.Tensor, p: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(renderable (B, P) bool, search_r² (B,) float32, the renderable ids
    of each cloud in the kernel's walk order, a list) from `launch`'s
    scratch."""
    b = scratch.shape[0]
    sr2 = scratch[:, :1].clone().view(torch.float32)[:, 0]
    counts = scratch[:, 1].tolist()
    ids = [scratch[i, 4:4 + n].long() for i, n in enumerate(counts)]
    renderable = torch.zeros((b, p), dtype=torch.bool, device=scratch.device)
    for i in range(b):
        renderable[i, ids[i]] = True
    return renderable, sr2, ids


def occ_backward_cuda(pts: torch.Tensor, radii: torch.Tensor,
                      visible: torch.Tensor, grad_occ: torch.Tensor,
                      settings) -> torch.Tensor:
    """Launch the CUDA kernels; same arguments and result as the plain
    version."""
    return launch(pts, radii, visible, grad_occ, settings)[0]


def occ_backward(pts: torch.Tensor, radii: torch.Tensor,
                 visible: torch.Tensor, grad_occ: torch.Tensor,
                 settings) -> torch.Tensor:
    """Occupancy xy gradient of B clouds, pts (B, P, 3), radii (B, P, 2),
    visible (B, P), grad_occ (B, S, S) -> (B, P, 2): the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if pts.is_cuda:
        return occ_backward_cuda(pts, radii, visible, grad_occ, settings)
    if pts.device.type != "cpu":
        raise ValueError(f"occ_backward runs on CUDA or CPU, not {pts.device}")
    return occ_backward_plain(pts, radii, visible, grad_occ, settings)


def occ_backward_one(pts: torch.Tensor, radii: torch.Tensor,
                     visible: torch.Tensor, grad_occ: torch.Tensor,
                     settings) -> torch.Tensor:
    """One cloud (P, 3), (P, 2), (P,), (S, S) -> (P, 2): `occ_backward`
    with B = 1."""
    return occ_backward(pts[None], radii[None], visible[None], grad_occ[None],
                        settings)[0]
