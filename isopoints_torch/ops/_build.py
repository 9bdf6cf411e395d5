"""Build and load the port's CUDA kernels.

Every `isopoints_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, into
`build/torch_kernels/` at the repo root, under a name that carries a hash of
the sources (the `.cu` file, the `.cu` files it includes and every `.cuh`)
and flags, so an edited source is rebuilt and an unchanged one
is reused. `build_all()` starts one `nvcc` per source at once and waits for
all of them. A failed build raises with `nvcc`'s output.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from isopoints_torch import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the MLP-tile kernels (csrc/mlp_mma.cuh) build their instances above this
# width into libraries of their own, `<source>_wide`
NARROW_MAX = 256

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


def _deps(name: str) -> List[str]:
    """csrc/`name`.cu and the `.cu` files it includes, recursively (a
    `_wide.cu` source builds its twin again)."""
    out, todo = [], [name + ".cu"]
    while todo:
        f = todo.pop()
        if f not in out:
            out.append(f)
            with open(os.path.join(CSRC, f)) as fh:
                todo += re.findall(r'#include "([^"]+\.cu)"', fh.read())
    return out


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = _deps(name)
    for f in sorted(os.listdir(CSRC)):
        if f in deps or f.endswith(".cuh"):
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
    # nvcc's output goes to a file, so a long -Xptxas -v log cannot fill a
    # pipe while build_all polls
    log = open(tmp + ".log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    proc.wait()
    with open(tmp + ".log") as f:
        log = f.read()
    os.remove(tmp + ".log")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all(seconds: Optional[Dict[str, float]] = None) -> Dict[str, str]:
    """Build every kernel source in parallel (one nvcc each); returns
    {name: library path}. `seconds`, when given, receives each build's
    wall time from the common start."""
    with _LOCK:
        t0 = time.time()
        jobs = {n: _start(n) for n in sources()}
        pending = dict(jobs)
        while pending:
            for n, (out, job) in list(pending.items()):
                if job is None or job[0].poll() is not None:
                    _finish(n, out, job)
                    if seconds is not None:
                        seconds[n] = time.time() - t0
                    del pending[n]
            time.sleep(0.05)
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
    """Kernel launches since the last reset: a wrapper calls `launch` where
    it launches its kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, n: int, **mode) -> None:
        """Count one launch of size `n`; while tracing is on, also record it
        with its `mode` (isopoints_torch/tracing.py)."""
        self.launches += 1
        tracing.launch(self.name, n, **mode)
