"""Ray-mesh intersection (Möller–Trumbore): a hand-written CUDA kernel and
its plain version (port of isopoints_tpu/ops/raymesh.py).

Exact nearest-triangle intersection for every ray, with no BVH, as the JAX
package computes it. `ray_mesh_intersect` launches the kernel
(csrc/raymesh.cu: one thread per ray, eight rays a thread, faces packed as
(F, 9) rows v0, e1, e2 and staged through shared memory) for CUDA tensors
and runs the plain version for CPU tensors. The kernel replaces no Pallas
kernel: the JAX op is XLA, but its dense form is too slow on the card at
the ablation dataset's size (see the source).

`ray_mesh_intersect_plain` follows the JAX blocking: ray blocks of 1024 and
face chunks of 4096, faces padded to a chunk multiple with degenerate
(never hit) triangles, a running minimum over chunks that a strictly
smaller t replaces, and in a chunk the first of equal minima, so on equal t
the lowest face index wins. Each product, sum and difference is a
separate PyTorch operation in the order the kernel rounds them, and
1/det is taken before the products, as in JAX; the two agree bit for bit.

Semantics (raymesh.py:36-136): the test is two-sided (|det| > 1e-9); the
barycentric slack is 1e-7 and t > t_min; t is in units of |dir|; a miss
has t = 1e10, face_idx = -1, the origin as its point and a zero normal;
normals are cross(e1, e2) normalised and flipped toward the ray origin.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from isopoints_torch.ops import _build
from isopoints_torch.utils import fma

KERNEL = _build.LaunchCount("raymesh")

_BIG = 1e10
# the thresholds as the float32 values JAX compares with (weakly typed
# Python floats against float32 arrays)
_EPS_DET = float(np.float32(1e-9))
_NEG_EPS = float(np.float32(-1e-7))
_ONE_EPS = float(np.float32(1.0 + 1e-7))
# the kernel's early cut on u: past it no v >= -1e-7 passes u + v <= 1 + 1e-7
_U_CUT = float(np.float32(1.0 + 1e-6))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("raymesh")
    lib.raymesh_forward.argtypes = [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P,
                                    _P, _P]
    lib.raymesh_forward.restype = _I
    return lib


class RayMeshResult(NamedTuple):
    t: torch.Tensor         # (..., N) hit distance along the ray (1e10 = miss)
    hit: torch.Tensor       # (..., N) bool
    face_idx: torch.Tensor  # (..., N) int32 nearest face (-1 = miss)
    points: torch.Tensor    # (..., N, 3) hit points (the origin at a miss)
    normals: torch.Tensor   # (..., N, 3) flat face normals toward the origin


def pack_faces(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 9) float32 rows (v0, e1 = v1 - v0, e2 = v2 - v0)."""
    v0 = verts[faces[:, 0]]
    return torch.cat([v0, verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0], dim=-1)


def _dot(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _chunk_intersect(orig: torch.Tensor, dirs: torch.Tensor, chunk: torch.Tensor,
                     t_min: float):
    """One (ray-block x face-chunk) pass: orig/dirs (nb, 3), chunk (fc, 9).
    Returns each ray's best (t, local face index) over the chunk."""
    ox, oy, oz = (orig[:, i:i + 1] for i in range(3))
    dx, dy, dz = (dirs[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (chunk[None, :, i] for i in range(9))
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    det = _dot(e1x, e1y, e1z, px, py, pz)
    ok_det = det.abs() > _EPS_DET
    inv = torch.where(ok_det, 1.0 / det, 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = _dot(tx, ty, tz, px, py, pz) * inv
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    v = _dot(dx, dy, dz, qx, qy, qz) * inv
    t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv
    ok = (ok_det & (u >= _NEG_EPS) & (v >= _NEG_EPS) & (u + v <= _ONE_EPS)
          & (t > t_min))
    t = torch.where(ok, t, _BIG)
    best = torch.argmin(t, dim=-1)   # the first of equal minima
    return torch.gather(t, 1, best[:, None])[:, 0], best


def intersect_plain(orig: torch.Tensor, dirs: torch.Tensor, packed: torch.Tensor,
                    t_min: float = 1e-4, ray_block: int = 1024,
                    face_chunk: int = 4096):
    """Plain version of the kernel: orig/dirs (N, 3), packed (F, 9) ->
    (t (N,), face (N,) int32), on any device."""
    n, f_total = orig.shape[0], packed.shape[0]
    dev = orig.device
    t_all = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    f_all = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0 or f_total == 0:
        return t_all, f_all
    fc = min(face_chunk, f_total)
    pad = -f_total % fc
    if pad:   # degenerate triangles at the origin: det = 0, never hit
        packed = torch.cat([packed, packed.new_zeros((pad, 9))])
    t_min = float(np.float32(t_min))
    for lo in range(0, n, ray_block):
        ob, db = orig[lo:lo + ray_block], dirs[lo:lo + ray_block]
        best_t = torch.full((ob.shape[0],), _BIG, dtype=torch.float32, device=dev)
        best_f = torch.full((ob.shape[0],), -1, dtype=torch.int32, device=dev)
        for base in range(0, packed.shape[0], fc):
            t, loc = _chunk_intersect(ob, db, packed[base:base + fc], t_min)
            take = t < best_t
            best_f = torch.where(take, (base + loc).to(torch.int32), best_f)
            best_t = torch.minimum(best_t, t)
        t_all[lo:lo + ray_block] = best_t
        f_all[lo:lo + ray_block] = best_f
    return t_all, f_all


def intersect_cuda(orig: torch.Tensor, dirs: torch.Tensor, packed: torch.Tensor,
                   t_min: float = 1e-4):
    """Launch the CUDA kernel: orig/dirs (N, 3), packed (F, 9), contiguous
    float32 CUDA tensors on one device -> (t (N,), face (N,) int32)."""
    for name, x in (("orig", orig), ("dirs", dirs), ("packed", packed)):
        if not x.is_cuda or x.device != orig.device:
            raise ValueError(f"intersect_cuda takes CUDA tensors on one device "
                             f"({name} is on {x.device})")
        if x.dtype != torch.float32:
            raise TypeError(f"intersect_cuda takes float32 tensors ({name} is "
                            f"{x.dtype})")
    if orig.shape != dirs.shape or orig.dim() != 2 or orig.shape[1] != 3:
        raise ValueError(f"orig and dirs must be (N, 3), got {tuple(orig.shape)} "
                         f"and {tuple(dirs.shape)}")
    if packed.dim() != 2 or packed.shape[1] != 9:
        raise ValueError(f"packed faces must be (F, 9), got {tuple(packed.shape)}")
    n = orig.shape[0]
    o, d, p = orig.contiguous(), dirs.contiguous(), packed.contiguous()
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    face = torch.empty(n, dtype=torch.int32, device=o.device)
    lib = _lib()
    KERNEL.launches += 1
    err = lib.raymesh_forward(o.data_ptr(), d.data_ptr(), p.data_ptr(), n,
                              p.shape[0], float(np.float32(t_min)), _EPS_DET,
                              _NEG_EPS, _ONE_EPS, _U_CUT, t.data_ptr(),
                              face.data_ptr(),
                              torch.cuda.current_stream(o.device).cuda_stream)
    _build.check_launch(lib, err, "raymesh")
    return t, face


def _finish(orig: torch.Tensor, dirs: torch.Tensor, packed: torch.Tensor,
            t: torch.Tensor, face: torch.Tensor, batch_shape) -> RayMeshResult:
    """Hit mask, points, oriented normals and the miss fills
    (raymesh.py:120-136)."""
    hit = t < _BIG * 0.5
    if packed.shape[0]:
        e = packed[torch.clamp(face, min=0).long()]
        e1, e2 = e[:, 3:6], e[:, 6:9]
        n_flat = torch.linalg.cross(e1, e2)
        n_flat = n_flat / torch.clamp(torch.linalg.norm(n_flat, dim=-1, keepdim=True),
                                      min=1e-12)
        # orient toward the ray origin (the flat-shading convention)
        n_flat = torch.where(torch.sum(n_flat * dirs, -1, keepdim=True) > 0,
                             -n_flat, n_flat)
    else:
        n_flat = torch.zeros_like(orig)
    pts = fma(torch.where(hit, t, 0.0)[:, None], dirs, orig)
    return RayMeshResult(
        t=t.reshape(batch_shape), hit=hit.reshape(batch_shape),
        face_idx=torch.where(hit, face, -1).reshape(batch_shape),
        points=pts.reshape(batch_shape + (3,)),
        normals=torch.where(hit[:, None], n_flat, 0.0).reshape(batch_shape + (3,)))


def ray_mesh_intersect(origins: torch.Tensor, dirs: torch.Tensor,
                       verts: torch.Tensor, faces: torch.Tensor,
                       t_min: float = 1e-4) -> RayMeshResult:
    """Nearest ray-triangle intersection for every ray (raymesh.py:57).
    origins/dirs (..., N, 3) (dirs need not be unit: t is in units of
    |dir|); verts (V, 3); faces (F, 3) int, all on one device. CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    if origins.is_cuda:
        fn = intersect_cuda
    elif origins.device.type == "cpu":
        fn = intersect_plain
    else:
        raise ValueError(f"ray_mesh_intersect runs on CUDA or CPU, not "
                         f"{origins.device}")
    return _intersect(fn, origins, dirs, verts, faces, t_min)


def ray_mesh_intersect_plain(origins: torch.Tensor, dirs: torch.Tensor,
                             verts: torch.Tensor, faces: torch.Tensor,
                             t_min: float = 1e-4, ray_block: int = 1024,
                             face_chunk: int = 4096) -> RayMeshResult:
    """The plain version on any device (JAX's blocking)."""
    return _intersect(functools.partial(intersect_plain, ray_block=ray_block,
                                        face_chunk=face_chunk),
                      origins, dirs, verts, faces, t_min)


def _intersect(fn, origins, dirs, verts, faces, t_min) -> RayMeshResult:
    batch_shape = tuple(origins.shape[:-1])
    orig = origins.reshape(-1, 3).float()
    d = dirs.reshape(-1, 3).float()
    packed = pack_faces(verts.float(), faces.long())
    t, face = fn(orig, d, packed, t_min=t_min)
    return _finish(orig, d, packed, t, face, batch_shape)
