"""Where the fused IGR kernel's time goes on the card.

    python -m isopoints_torch.igr_ablation

Builds two variants of csrc/fused_igr.cu beside the kernel itself, each
missing one part of the work of mlp_mma.cuh's tile: `no_epilogue` (every
softplus replaced by a max, so the accurate expf/log1pf and divisions are
gone) and `no_mma` (the tensor-core products left out, so the layers are
the epilogue over the biases). Times all three with CUDA events (median of
7) at 524,288 points, bench.py's coarse launch, on the fitted 4x256 bench
field, in both modes, value and value+grad, and prints each one's error
against the plain version and the share of outputs within 1e-5 of the
plain version and of the mode with exactly formed sums (`exact_sums`). The
variants' outputs are wrong by design; only the full kernel's error means
anything. Needs nvcc and a CUDA device; builds under build/igr_ablation/.
"""

import ctypes
import os
import re
import shutil
import statistics
import subprocess

import torch

from isopoints_torch import bench
from isopoints_torch.ops import _build, fused_mlp

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "igr_ablation")
N_POINTS = 524288
_CHEAP = ("__device__ __forceinline__ void cheap_softplus(float z, float& a, "
          "float& d) { a = fmaxf(z, 0.f); d = 1.f; }\n")
_MMA_CALL = "mma_chunk<Mode, H, NT>(acc, act, wbuf + (s & 1) * kStage, c);"


def _build_variant(name: str):
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    hdr = os.path.join(d, "mlp_mma.cuh")
    h = open(hdr).read()
    if name == "no_epilogue":
        h = h.replace("namespace mlp_mma {", "namespace mlp_mma {\n" + _CHEAP, 1)
        h = h.replace("igr::softplus(", "cheap_softplus(")
    elif name == "no_mma":
        if _MMA_CALL not in h:
            raise RuntimeError("mlp_mma.cuh no longer calls mma_chunk as expected")
        h = h.replace(_MMA_CALL, "")
    with open(hdr, "w") as f:
        f.write(h)
    so = os.path.join(d, "fused_igr.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
           os.path.join(d, "fused_igr.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _share(us, vs) -> float:
    return min(float(((u - v).abs() <= 1e-5).float().mean()) for u, v in zip(us, vs))


def main() -> None:
    names = ("full", "no_epilogue", "no_mma")
    jobs = {n: _build_variant(n) for n in names}
    libs = {}
    for n, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {n} variant:\n{log}")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spill = max([int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
                    or [0])
        print(f"{n}: registers per instance {regs}, spill stores up to {spill} bytes")
        lib = ctypes.CDLL(so)
        lib.igr_forward.argtypes = fused_mlp._igr_lib().igr_forward.argtypes
        lib.igr_forward.restype = ctypes.c_int
        libs[n] = lib
    dev = torch.device("cuda")
    field, _ = bench.fit_sphere_field(dev)
    pack = fused_mlp.make_fused_igr_sdf(field, "f32").pack
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((N_POINTS, 3), generator=g, device=dev) * 2.4 - 1.2
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bf16 in (True, False):
        _, ptrs = pack.mma_net(bf16)
        for grad in (False, True):
            k = 2 if grad else 1
            ref = fused_mlp.igr_sdf_and_grad_plain(pack, x, bf16)[:k]
            exact = fused_mlp.igr_sdf_and_grad_plain(pack, x, bf16, True)[:k]
            row = [f"plain within 1e-5 of exact sums on {_share(ref, exact):.5f}"]
            for name, lib in libs.items():
                val = torch.empty(N_POINTS, device=dev)
                gr = torch.empty((N_POINTS, 3), device=dev) if grad else None
                call = lambda: lib.igr_forward(
                    x.data_ptr(), N_POINTS, *ptrs, *pack.arch_args(), int(bf16),
                    val.data_ptr(), gr.data_ptr() if grad else None, stream)
                if call() != 0:
                    raise RuntimeError(f"the {name} variant failed to launch")
                torch.cuda.synchronize()
                got = (val, gr)[:k]
                err = max(float((u - v).abs().max()) for u, v in zip(got, ref))
                ts = []
                for _ in range(7):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    torch.cuda.synchronize()
                    ts.append(a.elapsed_time(b))
                row.append(f"{name} {statistics.median(ts):.4f} ms (err {err:.3g}; "
                           f"within 1e-5 of plain {_share(got, ref):.5f}, of exact "
                           f"sums {_share(got, exact):.5f})")
            print(f"fused_igr {'bf16' if bf16 else 'f32'} "
                  f"{'value+grad' if grad else 'value'} n={N_POINTS}: " + "; ".join(row))


if __name__ == "__main__":
    main()
