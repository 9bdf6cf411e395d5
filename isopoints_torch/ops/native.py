"""Native (C++) host code bound with ctypes (port of
isopoints_tpu/ops/native.py): marching tetrahedra, `csrc/marching_tet.cpp`.

The library is built with `g++ -O3 -shared -fPIC -std=c++17` at first use
into `_build.BUILD_DIR`, under a name that carries a hash of the source, and
loaded once per process. A failed build raises with `g++`'s output: unlike
the JAX package, nothing falls back to the numpy version, which lives in
utils/meshing.py as `marching_tetrahedra_plain`, the plain version the tests
compare with.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import numpy as np

from isopoints_torch.ops import _build

SRC = os.path.join(_build.CSRC, "marching_tet.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"marching_tet.{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it exists; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = _lib_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: marching tetrahedra "
                           "(csrc/marching_tet.cpp) needs a C++ compiler")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    # a per-process file, installed by os.replace: concurrent builders never
    # load a partial library
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for marching_tet.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.marching_tets.restype = ctypes.c_int
    lib.marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float),                       # values
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,       # nx ny nz
        ctypes.POINTER(ctypes.c_float),                       # origin
        ctypes.POINTER(ctypes.c_float),                       # spacing
        ctypes.c_float,                                       # level
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),       # out_verts
        ctypes.POINTER(ctypes.c_int64),                       # n_verts
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),       # out_faces
        ctypes.POINTER(ctypes.c_int64),                       # n_faces
    ]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.mt_free.restype = None
    return lib


def marching_tetrahedra_native(values: np.ndarray, origin, spacing,
                               level: float = 0.0
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """The C++ sweep: world-space vertices (V, 3) float32 in the order the
    sweep meets the crossed edges, faces (F, 3) int64, before the
    degenerate-face drop and the orientation of utils/meshing.py."""
    lib = _lib()
    vals = np.ascontiguousarray(values, dtype=np.float32)
    if vals.ndim != 3:
        raise ValueError(f"marching tetrahedra takes a 3-D grid, got {vals.shape}")
    nx, ny, nz = vals.shape
    origin = np.ascontiguousarray(origin, np.float32)
    spacing = np.ascontiguousarray(spacing, np.float32)
    if origin.shape != (3,) or spacing.shape != (3,):
        raise ValueError("origin and spacing take 3 values each")
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    out_v = ctypes.POINTER(ctypes.c_float)()
    out_f = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.marching_tets(fptr(vals), nx, ny, nz, fptr(origin), fptr(spacing),
                           ctypes.c_float(level), ctypes.byref(out_v),
                           ctypes.byref(nv), ctypes.byref(out_f), ctypes.byref(nf))
    if rc != 0:   # the library has freed its buffers already
        raise MemoryError("marching_tets could not allocate its output")
    try:
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        verts = np.ctypeslib.as_array(out_v, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(out_f, shape=(nf.value, 3)).copy()
    finally:
        lib.mt_free(out_v)
        lib.mt_free(out_f)
    return verts, faces
