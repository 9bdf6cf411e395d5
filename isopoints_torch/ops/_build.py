"""Build and load the port's CUDA kernels.

Every `isopoints_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, into
`build/torch_kernels/` at the repo root, under a name that carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. `build_all()` starts one `nvcc` per source at once and waits for
all of them. A failed build raises with `nvcc`'s output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per `.cu` file under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == name + ".cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"{name}.{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (path, process or None)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every kernel source in parallel (one nvcc each); returns
    {name: library path}."""
    with _LOCK:
        jobs = {n: _start(n) for n in sources()}
        for n, (out, job) in jobs.items():
            _finish(n, out, job)
        return {n: out for n, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/`name`.cu, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            out, job = _start(name)
            _finish(name, out, job)
            lib = ctypes.CDLL(out)
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError())."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


class LaunchCount:
    """Kernel launches since the last reset: a wrapper adds one where it
    launches its kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
