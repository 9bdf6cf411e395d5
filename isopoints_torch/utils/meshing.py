"""Iso-surface meshing: marching tetrahedra and the two-stage extraction
(port of isopoints_tpu/utils/meshing.py).

`marching_tetrahedra` runs the C++ sweep of csrc/marching_tet.cpp
(ops/native.py) and post-processes its output as the JAX package does:
back to grid coordinates, degenerate faces dropped, faces oriented along
the field's gradient (`np.gradient` in float64). `marching_tetrahedra_plain`
is the JAX package's numpy path, the plain version the tests hold the sweep
against; no caller falls back to it.

`eval_sdf_grid` evaluates a field on a grid chunk by chunk on the device
into one preallocated tensor, copied to the host once (the counterpart of
`jax.lax.map` over the chunks). The grid's axes are the JAX package's:
`np.linspace` in float64, cast to float32, so the points are the same bit
for bit; each chunk's points are formed from them on the device, never
uploaded as a whole.
"""

from typing import Callable, Tuple

import numpy as np
import torch

from isopoints_torch.ops.knn import dot3
from isopoints_torch.ops.native import marching_tetrahedra_native

# cube corner offsets, index 0..7 (x fastest)
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)

# 6-tetrahedra decomposition sharing the 0-6 diagonal
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], dtype=np.int64)

# tet edges by local vertex pair
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      dtype=np.int64)

# case -> list of triangles (edge-index triples); bit i set = vertex i inside
_MT_TRIS = {
    1: [(0, 1, 2)],
    2: [(0, 3, 4)],
    4: [(1, 3, 5)],
    8: [(2, 4, 5)],
    3: [(1, 2, 4), (1, 4, 3)],
    5: [(0, 2, 5), (0, 5, 3)],
    6: [(0, 4, 5), (0, 5, 1)],
    9: [(0, 1, 5), (0, 5, 4)],
    10: [(0, 5, 2), (0, 3, 5)],
    12: [(1, 4, 2), (1, 3, 4)],
    7: [(2, 5, 4)],
    11: [(1, 5, 3)],
    13: [(0, 4, 3)],
    14: [(0, 2, 1)],
}


def _empty() -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)


def marching_tetrahedra(values: np.ndarray, origin=(0.0, 0.0, 0.0),
                        spacing=(1.0, 1.0, 1.0), level: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The `level` iso-surface of a (Nx, Ny, Nz) grid indexed [ix, iy, iz]
    whose node (0, 0, 0) sits at `origin`, by the C++ sweep (meshing.py:55).
    Returns (vertices (V, 3) float32, faces (F, 3) int64), watertight where
    the surface does not reach the grid's boundary."""
    v = np.asarray(values, np.float64) - level
    if min(v.shape) < 2:
        return _empty()
    verts_w, faces = marching_tetrahedra_native(values, origin, spacing, level)
    if len(verts_w) == 0:
        return verts_w, faces
    verts_grid = (verts_w.astype(np.float64) - np.asarray(origin)[None]) \
        / np.asarray(spacing)[None]
    faces = _drop_degenerate(faces)
    faces = _orient_faces(verts_grid, faces, v)
    return verts_w.astype(np.float32), faces


def marching_tetrahedra_plain(values: np.ndarray, origin=(0.0, 0.0, 0.0),
                              spacing=(1.0, 1.0, 1.0), level: float = 0.0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy version (meshing.py:87-157): the same decomposition and
    edge dedup, vertices in float64 ordered by their edge key."""
    v = np.asarray(values, np.float64) - level
    nx, ny, nz = v.shape
    if min(nx, ny, nz) < 2:
        return _empty()

    def gidx(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    cx, cy, cz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    cx = cx.ravel(); cy = cy.ravel(); cz = cz.ravel()
    corner_g = np.stack([gidx(cx + dx, cy + dy, cz + dz)
                         for dx, dy, dz in _CORNERS], axis=1)
    vflat = v.ravel()
    corner_v = vflat[corner_g]
    inside8 = corner_v < 0
    active = ~(inside8.all(axis=1) | (~inside8).all(axis=1))
    corner_g = corner_g[active]
    corner_v = corner_v[active]
    if corner_g.shape[0] == 0:
        return _empty()

    all_tris = []
    for tet in _TETS:
        tg = corner_g[:, tet]
        tv = corner_v[:, tet]
        case = ((tv < 0) * np.array([1, 2, 4, 8])).sum(axis=1)
        for c, tris in _MT_TRIS.items():
            sel = case == c
            if not sel.any():
                continue
            sg = tg[sel]
            for tri in tris:
                pairs = _TET_EDGES[list(tri)]
                a = sg[:, pairs[:, 0]]
                b = sg[:, pairs[:, 1]]
                all_tris.append(np.stack([np.minimum(a, b), np.maximum(a, b)],
                                         axis=-1))
    if not all_tris:
        return _empty()
    tris = np.concatenate(all_tris, axis=0)

    flat = tris.reshape(-1, 2)
    key1d = flat[:, 0] * np.int64(nx * ny * nz) + flat[:, 1]
    uniq, inv = np.unique(key1d, return_inverse=True)
    ua = (uniq // (nx * ny * nz)).astype(np.int64)
    ub = (uniq % (nx * ny * nz)).astype(np.int64)
    va = vflat[ua]; vb = vflat[ub]
    t = va / (va - vb)
    t = np.clip(np.nan_to_num(t, nan=0.5), 0.0, 1.0)

    def coords(g):
        return np.stack([g // (ny * nz), (g // nz) % ny, g % nz],
                        axis=-1).astype(np.float64)

    pa, pb = coords(ua), coords(ub)
    verts_grid = pa + t[:, None] * (pb - pa)
    faces = inv.reshape(-1, 3)
    faces = _drop_degenerate(faces)
    faces = _orient_faces(verts_grid, faces, v)
    verts = verts_grid * np.asarray(spacing)[None] + np.asarray(origin)[None]
    return verts.astype(np.float32), faces


def _drop_degenerate(faces: np.ndarray) -> np.ndarray:
    """Drop faces with two corners on the same dedup'd edge vertex."""
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
         (faces[:, 0] != faces[:, 2])
    return faces[ok]


def _orient_faces(verts_grid: np.ndarray, faces: np.ndarray,
                  v: np.ndarray) -> np.ndarray:
    """Consistent winding: normals face the positive side of the field (the
    6-tet decomposition mixes tet parities, so orient by ∇v)."""
    if len(faces) == 0:
        return faces
    nx, ny, nz = v.shape
    gvx, gvy, gvz = np.gradient(v)
    cent = verts_grid[faces].mean(axis=1)
    ci = np.clip(np.round(cent).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))
    gradc = np.stack([gvx[ci[:, 0], ci[:, 1], ci[:, 2]],
                      gvy[ci[:, 0], ci[:, 1], ci[:, 2]],
                      gvz[ci[:, 0], ci[:, 1], ci[:, 2]]], axis=-1)
    fv = verts_grid[faces]
    nrm = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    flip = np.einsum("ij,ij->i", nrm, gradc) < 0
    faces = faces.copy()
    faces[flip] = faces[flip][:, ::-1]
    return faces


@torch.no_grad()
def eval_sdf_grid(sdf_fn: Callable, resolution: int, bbox_min, bbox_max,
                  chunk: int = 262144, device="cuda") -> np.ndarray:
    """The field on a uniform resolution³ grid (meshing.py:189), evaluated
    in chunks of `chunk` points on `device`, the last one padded with the
    origin as the JAX package pads it. Returns (R, R, R) float32."""
    dev = torch.device(device)
    axes = [torch.from_numpy(np.linspace(bbox_min[i], bbox_max[i], resolution)
                             .astype(np.float32)).to(dev) for i in range(3)]
    r = resolution
    n = r ** 3
    n_pad = n + (-n) % chunk
    vals = torch.empty(n_pad, dtype=torch.float32, device=dev)
    for lo in range(0, n_pad, chunk):
        idx = torch.arange(lo, lo + chunk, device=dev)
        ok = idx < n
        idx = torch.where(ok, idx, 0)
        pts = torch.stack([axes[0][idx // (r * r)], axes[1][(idx // r) % r],
                           axes[2][idx % r]], dim=-1)
        pts = torch.where(ok[:, None], pts, 0.0)
        vals[lo:lo + chunk] = sdf_fn(pts).reshape(chunk)
    return vals[:n].cpu().numpy().reshape(r, r, r)


def largest_component(verts: np.ndarray, faces: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the largest connected face component (meshing.py:205)."""
    if faces.shape[0] == 0:
        return verts, faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    n = verts.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    if ncomp <= 1:
        return verts, faces
    best = np.bincount(labels).argmax()
    keep_v = labels == best
    remap = -np.ones(n, np.int64)
    remap[keep_v] = np.arange(keep_v.sum())
    keep_f = keep_v[faces].all(axis=1)
    return verts[keep_v], remap[faces[keep_f]]


def extract_mesh(sdf_fn: Callable, resolution: int = 128,
                 bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0),
                 level: float = 0.0, keep_largest: bool = False,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One grid on `device`, then marching tetrahedra (meshing.py:227)."""
    vals = eval_sdf_grid(sdf_fn, resolution, bbox_min, bbox_max, device=device)
    spacing = [(bbox_max[i] - bbox_min[i]) / (resolution - 1) for i in range(3)]
    verts, faces = marching_tetrahedra(vals, origin=bbox_min, spacing=spacing,
                                       level=level)
    if keep_largest:
        verts, faces = largest_component(verts, faces)
    return verts, faces


def get_surface_high_res_mesh(sdf_fn: Callable, resolution: int = 512,
                              box_side: float = 2.0, coarse_res: int = 100,
                              keep_largest: bool = True, device="cuda"
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Two stages (meshing.py:241): a coarse grid locates the surface, then
    a grid at `resolution` in the PCA frame of the coarse vertices, padded
    by 0.05, is meshed and rotated back."""
    half = box_side / 2.0
    verts_c, faces_c = extract_mesh(sdf_fn, coarse_res, (-half,) * 3,
                                    (half,) * 3, device=device)
    if verts_c.shape[0] == 0:
        return verts_c, faces_c
    center = verts_c.mean(axis=0)
    centered = verts_c - center
    cov = centered.T @ centered / max(len(verts_c), 1)
    _, rot = np.linalg.eigh(cov)  # columns = principal axes (ascending)
    local = centered @ rot
    lo = local.min(axis=0) - 0.05
    hi = local.max(axis=0) + 0.05
    dev = torch.device(device)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    center_t = torch.as_tensor(center, dtype=torch.float32, device=dev)

    def sdf_local(p_local):
        # p_local @ rot.T in float32 as fma chains, never on TF32 tensor cores
        p_world = dot3(p_local[:, None, :], rot_t[None]) + center_t
        return sdf_fn(p_world)

    vals = eval_sdf_grid(sdf_local, resolution, lo, hi, device=device)
    spacing = [(hi[i] - lo[i]) / (resolution - 1) for i in range(3)]
    verts_l, faces = marching_tetrahedra(vals, origin=lo, spacing=spacing)
    verts = verts_l @ rot.T + center
    if keep_largest:
        verts, faces = largest_component(verts, faces)
    return verts.astype(np.float32), faces


def sample_points_from_mesh(verts: np.ndarray, faces: np.ndarray,
                            n_samples: int, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface samples and their face normals
    (meshing.py:276), drawn on the host from `np.random.RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    prob = area / max(area.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=n_samples, p=prob)
    r1 = np.sqrt(rng.rand(n_samples, 1))
    r2 = rng.rand(n_samples, 1)
    pts = (1 - r1) * v0[fidx] + r1 * (1 - r2) * v1[fidx] + r1 * r2 * v2[fidx]
    normals = cross[fidx] / np.maximum(
        np.linalg.norm(cross[fidx], axis=-1, keepdims=True), 1e-12)
    return pts.astype(np.float32), normals.astype(np.float32)
