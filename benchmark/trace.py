"""What a traced run (`--trace 1`) reads: the launches of the port's MLP and
sampler kernels, recorded by a hook around their launch wrappers, and the
device trace of the window from `torch.profiler`.

The hook wraps `isopoints_torch.ops.fused_mlp.siren_forward_cuda` /
`igr_forward_cuda` and `isopoints_torch.ops.fused_sampler.sweep_cuda`,
which the program looks up at each call, and records each launch's mode
and size from its arguments; nothing is synchronised. The profiler's
events give the device's busy time as the union of its kernel, copy and
set intervals inside the window (overlaps count once), the kernels' time
by name, and each idle gap named by the innermost host operation running
at its middle ("python" when none is: the interpreter between operations).
"""

import contextlib
import os
import re
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "benchmark.window"
_ANON = "(anonymous namespace)"


@contextlib.contextmanager
def launch_hook(records: List[dict]):
    """Record every MLP and sampler kernel launch into `records`."""
    from isopoints_torch.ops import fused_mlp, fused_sampler

    saved = {}

    def wrap(mod, name, make):
        orig = getattr(mod, name)
        saved[(mod, name)] = orig
        setattr(mod, name, make(orig))

    def mlp(orig):
        def f(pack, x, with_grad, bf16=False):
            records.append({"kernel": "mlp", "n": int(x.shape[0]),
                            "with_grad": bool(with_grad), "bf16": bool(bf16)})
            return orig(pack, x, with_grad, bf16)
        return f

    def sampler(orig):
        def f(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
              coarse_sweep=False, fine_bf16=False):
            records.append({"kernel": "sampler", "n": int(dirs.shape[0]),
                            "n_steps": int(steps.shape[0]),
                            "n_secant": int(n_secant),
                            "coarse_sweep": bool(coarse_sweep),
                            "fine_bf16": bool(fine_bf16)})
            return orig(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                        coarse_sweep, fine_bf16)
        return f

    wrap(fused_mlp, "siren_forward_cuda", mlp)
    wrap(fused_mlp, "igr_forward_cuda", mlp)
    wrap(fused_sampler, "sweep_cuda", sampler)
    try:
        yield records
    finally:
        for (mod, name), orig in saved.items():
            setattr(mod, name, orig)


def kernel_function(name: str) -> str:
    """The unqualified function of a device event's (demangled) name:
    `void ns::(anonymous namespace)::k<8>(Net, ...)` -> `k`."""
    s = name.replace(_ANON, "anon")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip()


def csrc_kernels() -> set:
    """The `__global__` functions of the program's csrc/ sources."""
    import isopoints_torch

    d = os.path.join(os.path.dirname(isopoints_torch.__file__), "csrc")
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"([A-Za-z_]\w*)\s*[(<]")
    for f in os.listdir(d):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(d, f)) as fh:
                names.update(pat.findall(fh.read()))
    return names


def read_events(prof) -> Tuple[Tuple[int, int], list, list]:
    """((window start, end) ns, device events [(name, start, end)], host
    events [(name, start, end)]) of a stopped profiler."""
    from torch.autograd import DeviceType

    window = None
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if iv[0] != WINDOW and not e.is_user_annotation():
                dev.append(iv)
        elif iv[0] == WINDOW:
            window = iv[1:]
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError("the profiler recorded no window")
    w0, w1 = window
    clip = lambda evs: [(n, max(a, w0), min(b, w1)) for n, a, b in evs
                        if b > w0 and a < w1]
    return window, clip(dev), clip(host)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_names(host: list, points: np.ndarray) -> List[str]:
    """The innermost host operation (CUDA runtime calls left out) active
    at each point, "python" where none is."""
    ops = sorted((a, b, n) for n, a, b in host if not n.startswith("cuda"))
    if not ops:
        return ["python"] * len(points)
    starts = np.array([o[0] for o in ops], dtype=np.int64)
    parent = [-1] * len(ops)
    stack: List[int] = []
    for i, (a, b, _) in enumerate(ops):
        while stack and ops[stack[-1]][1] <= a:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    names = []
    for p, i in zip(points, np.searchsorted(starts, points, side="right") - 1):
        j = int(i)
        while j >= 0 and ops[j][1] < p:
            j = parent[j]
        names.append(ops[j][2] if j >= 0 else "python")
    return names


def summarise(prof, top: int = 10) -> Dict:
    """window_s, busy_s, the device events, and the breakdown's lists."""
    (w0, w1), dev, host = read_events(prof)
    busy = union([(a, b) for _, a, b in dev])
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, int] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
    gap_by: Dict[str, int] = {}
    for (a, b), n in zip(gaps, _host_names(host, mids)):
        gap_by[n] = gap_by.get(n, 0) + (b - a)
    idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_events": dev,
            "breakdown": {"device_ops": [[n[:120], t / 1e9] for n, t in ops],
                          "idle_gaps": [[n[:120], t / 1e9] for n, t in idle]}}
