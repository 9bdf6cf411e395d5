"""The measurements behind four design choices of the kernels, on the card.

    python -m isopoints_torch.kernel_variants

The kNN (csrc/knn.cu) runs on the Morton order with pruning from
`knn.SORT_MIN` points; the fused SIREN kernel (csrc/fused_mlp.cu) takes
tiles of 4 or 1 row groups (128 or 32 rows) by the launch's size; the
tensor-core tile's
f32 mode (csrc/mlp_mma.cuh) sums hi*hi of each k8 step into a zeroed tile
of its own and the correction products into another, once per chunk. This
times the kNN with and without the sort (`SORT_MIN` set below and above
the cloud), as the wrapper calls it and its own kernels alone (profiled,
without the sort), at
3000 points, k = 8 (the projected step's upsampling), 8000 (the resample's
seed) and 24,576 points, k = 6 (the splat frame's spacing); and builds
copies of the sources with one choice replaced (the row groups fixed at
1 and 4; the f32 sums before their repair, all three passes of a k16
chunk in one zeroed tile, and two arrangements between) under build/kernel_variants/,
and times every copy with CUDA events (median of 7) at the shapes the
main path gives the kernel: the SIREN 3x256 MLP at the projected
run's launches (value+grad at 3000 and 8000 points, value at 4096 and
131,072) and at 262,144 points; fused_igr's f32 value on the fitted 4x256
bench field at 220,202 points (its most frequent trace launch), with each
arrangement's RMS error against exactly summed values beside cuBLAS's
there and on 245,760 points within 0.02 of the surface (where the
sampler's fine evaluations fall). Each copy's output is held to the plain
version (the kNN bit for bit, the MLPs within phase 2's and phase 7's
tolerances of chip_smoke.py; fused_igr's bf16 mode bit for bit to the
kernel as built) before it is timed. The sampler (csrc/fused_sampler.cu)
takes the rays a block `fused_sampler.rays_per_block` chooses from the
launch's shape: this times it at every block size it takes (the choice
replaced in the wrapper, each output bit for bit the built choice's) at
the SIREN 3x256 sampler's path shapes, the uni ablation arm's coarse
buffer (1024 rays x 100 steps + 8 secant, margin 2e-3) and a warm-up
trace's fine sweep (2048 rays x 100 + 8), and at the fitted IGR bench
field's coarse buffer (24,576 rays x 100 + 8). Needs nvcc and a CUDA
device.
"""

import ctypes
import os
import shutil
import statistics
import subprocess

import torch

from isopoints_torch import bench
from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import _build, fused_mlp, fused_sampler, knn
from isopoints_torch.utils import linspace01

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_variants")
_RULE = "  switch (row_groups(n, C)) {"
# the f32 mode's sums in mma_chunk (mlp_mma.cuh) as built, and the others
_F32_BUILT = """        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_tf32(c, lo[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
          mma_tf32(c, a[ks][mt], b[1][2 * ks], b[1][2 * ks + 1]);
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, a[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], c[i]);"""
_F32_VARIANTS = {
    # before the repair: a chunk's three passes, small terms first, in one
    # zeroed tile
    "chunk": """        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_tf32(t, lo[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
          mma_tf32(t, a[ks][mt], b[1][2 * ks], b[1][2 * ks + 1]);
          mma_tf32(t, a[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
        }
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);""",
    # shorter chunks: each k8 step's three passes in one zeroed tile
    "step": """#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, lo[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
          mma_tf32(t, a[ks][mt], b[1][2 * ks], b[1][2 * ks + 1]);
          mma_tf32(t, a[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
          for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
        }""",
    # the corrections in a tile of their own, hi*hi of the chunk in another
    "corrections apart": """        float c[4] = {0.f, 0.f, 0.f, 0.f}, t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_tf32(c, lo[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
          mma_tf32(c, a[ks][mt], b[1][2 * ks], b[1][2 * ks + 1]);
          mma_tf32(t, a[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
        }
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], c[i]);""",
}


def _variant(src: str, name: str, old: str, new: str, edit: str = ""):
    """Build csrc/`src`.cu with `old` replaced by `new` in csrc/`edit`
    (default: the source itself) into build/kernel_variants/`name`/."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, edit or src + ".cu")
    text = open(path).read()
    if old not in text:
        raise RuntimeError(f"{os.path.basename(path)} no longer holds {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    so = os.path.join(d, src + ".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(d, src + ".cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _time(fn) -> float:
    fn()
    fn()
    ts = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _load(so: str, proc, like: ctypes.CDLL, fn: str) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {so}:\n{log}")
    lib = ctypes.CDLL(so)
    getattr(lib, fn).argtypes = getattr(like, fn).argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {("fused_mlp", rg): _variant(
        "fused_mlp", f"fused_mlp_rows{32 * rg}", _RULE,
        f"  switch ({rg}) {{") for rg in (1, 4)}
    f32_names = ("as built",) + tuple(_F32_VARIANTS)
    jobs.update({("fused_igr", v): _variant(
        "fused_igr", "f32_" + v.replace(" ", "_"), _F32_BUILT,
        _F32_BUILT if v == "as built" else _F32_VARIANTS[v], "mlp_mma.cuh")
        for v in f32_names})
    # the wrappers launch through their module's _lib(), swapped per copy
    own = {"fused_mlp": fused_mlp._lib, "fused_igr": fused_mlp._igr_lib}
    like = {name: own[name]() for name in own}
    fn = {"fused_mlp": "siren_forward", "fused_igr": "igr_forward"}
    libs = {key: _load(so, proc, like[key[0]], fn[key[0]])
            for key, (so, proc) in jobs.items()}
    print(f"{torch.cuda.get_device_name(0)}; launches of the kernels as built "
          f"(the wrappers), with each constant replaced")

    gen = torch.Generator(device=dev).manual_seed(0)
    # the kNN with and without the Morton order and the pruning: knn.SORT_MIN
    # read at each call, set below and above the cloud's size
    sort_min = knn.SORT_MIN
    for p, k in ((3000, 8), (8000, 8), (24_576, 6)):
        v = torch.randn((1, p, 3), generator=gen, device=dev)
        pts = 0.5 * v / v.norm(dim=-1, keepdim=True)
        mask = torch.rand((1, p), generator=gen, device=dev) < 0.97
        ref = knn.knn_points(pts, pts, mask, mask, k=k, exclude_self=True,
                             method="dense")
        row = []
        for label, at in (("plain order", p + 1), ("Morton order, pruned", 0)):
            knn.SORT_MIN = at
            try:
                run = lambda: knn.knn_points(pts, pts, mask, mask, k=k,
                                             exclude_self=True)
                got = run()
                if not (torch.equal(got.dists, ref.dists) and torch.equal(got.idx, ref.idx)):
                    raise RuntimeError(f"the kNN ({label}) differs from the plain version")
                prof = bench.profile_call(run, dev, "knn", log=lambda m: None)
                alone = sum(t for key, t, _ in prof["kernels"] if "knn" in key)
                row.append(f"{label} {_time(run):.4f} ms (the kNN's own kernels "
                           f"alone {alone:.4f} ms)")
            finally:
                knn.SORT_MIN = sort_min
        print(f"knn P={p} k={k}, self-excluded, as the wrapper calls it: " + "; ".join(row))

    field = SirenField(hidden_size=256, n_layers=3, generator=gen, device=dev)
    pack = fused_mlp.SirenPack(field)
    for what, n in (("value+grad", 3000), ("value", 4096), ("value+grad", 8000),
                    ("value", 131_072), ("value", 262_144),
                    ("value+grad", 262_144)):
        grad = what == "value+grad"
        x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        ref = (fused_mlp.siren_sdf_and_grad_plain(pack, x) if grad
               else (fused_mlp.siren_sdf_plain(pack, x),))
        row = []
        for rg in (1, 4):
            fused_mlp._lib = lambda lib=libs[("fused_mlp", rg)]: lib
            try:
                run = lambda: fused_mlp.siren_forward_cuda(pack, x, grad)
                got = run()
                err_v = float((got[0] - ref[0]).abs().max())
                err_g = (float((got[1] - ref[1]).abs().max())
                         / max(1.0, float(ref[1].abs().max())) if grad else 0.0)
                if err_v > 2e-5 or err_g > 1e-4:
                    raise RuntimeError(f"fused_mlp with {32 * rg} rows: value err "
                                       f"{err_v}, relative grad err {err_g}")
                row.append(f"{32 * rg} rows: {_time(run):.4f} ms")
            finally:
                fused_mlp._lib = own["fused_mlp"]
        print(f"fused_mlp 3x256 {what} n={n}: " + ", ".join(row))


    # the sampler's rays a block: every size the kernel takes, at the path's
    # shapes, against the wrapper's choice
    ifield, _ = bench.fit_sphere_field(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    choose = fused_sampler.rays_per_block
    for label, fld, n_rays, coarse in (
            ("SIREN 3x256, the uni arm's coarse buffer", field, 1024, True),
            ("SIREN 3x256, a warm-up trace's fine sweep", field, 2048, False),
            ("IGR 4x256 bench field, its coarse buffer", ifield, 24_576, True)):
        fine = (fused_mlp.make_fused_siren_sdf(fld) if fld is field
                else fused_mlp.make_fused_igr_sdf(fld))
        g = torch.Generator(device=dev).manual_seed(n_rays)
        cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n_rays, 3).contiguous()
        d = torch.randn((n_rays, 3), generator=g, device=dev) * 0.3
        d[:, 2] = 1.0
        d = d / d.norm(dim=-1, keepdim=True)
        t_lo = 0.8 + 0.4 * torch.rand(n_rays, generator=g, device=dev)
        t_hi = t_lo + 2.2 * torch.rand(n_rays, generator=g, device=dev)
        kw = dict(n_secant=8, margin=2e-3 if coarse else 0.0, coarse_sweep=coarse)
        args = (cam, d, t_lo, t_hi, linspace01(100, dev))
        built = choose(n_rays, 100, 8, coarse, n_sms)
        ref = fine.fused_ray_sampler(*args, **kw)
        row = []
        for rays in fused_sampler.RAYS:
            fused_sampler.rays_per_block = lambda *a, r=rays: r
            try:
                got = fine.fused_ray_sampler(*args, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"the sampler at {rays} rays a block differs "
                                       f"from the built choice's outputs")
                ms = _time(lambda: fine.fused_ray_sampler(*args, **kw))
            finally:
                fused_sampler.rays_per_block = choose
            row.append(f"{rays} rays {ms:.3f} ms" + (" (chosen)" if rays == built else ""))
        print(f"fused_sampler {label}, {n_rays} rays x 100 + 8: " + ", ".join(row))

    # fused_igr's f32 sums: time at its most frequent trace launch, and the
    # RMS error against exactly summed values beside cuBLAS's (TF32 off)
    ipack = fused_mlp.IgrPack(ifield)
    x_cube = torch.rand((220_202, 3), generator=gen, device=dev) * 2.4 - 1.2
    v = torch.randn((245_760, 3), generator=gen, device=dev)
    r = bench.RADIUS + 0.02 * (2 * torch.rand((245_760, 1), generator=gen, device=dev) - 1)
    x_near = r * v / v.norm(dim=-1, keepdim=True)
    rms = lambda a, b: float((a - b).square().mean().sqrt())
    sets = {"220,202 points in the cube": x_cube, "245,760 near the surface": x_near}
    exact = {k: fused_mlp.igr_sdf_plain(ipack, x, False, True) for k, x in sets.items()}
    cublas = {k: rms(fused_mlp.igr_sdf_plain(ipack, x), exact[k]) for k, x in sets.items()}
    print("fused_igr f32 RMS error against exact sums, cuBLAS (float32, TF32 "
          "off): " + ", ".join(f"{k} {e:.4g}" for k, e in cublas.items()))
    bf16_ref = fused_mlp.igr_forward_cuda(ipack, x_cube, True, True)
    for v_name in f32_names:
        fused_mlp._igr_lib = lambda lib=libs[("fused_igr", v_name)]: lib
        try:
            bf16 = fused_mlp.igr_forward_cuda(ipack, x_cube, True, True)
            if not all(torch.equal(a, b) for a, b in zip(bf16, bf16_ref)):
                raise RuntimeError(f"the {v_name} variant changes the bf16 mode")
            errs = []
            for k, x in sets.items():
                val, _ = fused_mlp.igr_forward_cuda(ipack, x, False)
                if float((val - fused_mlp.igr_sdf_plain(ipack, x)).abs().max()) > 2e-5:
                    raise RuntimeError(f"the {v_name} variant misses the f32 tolerance")
                errs.append(f"{k} {rms(val, exact[k]):.4g} "
                            f"({rms(val, exact[k]) / cublas[k]:.3f} x cuBLAS)")
            ms = _time(lambda: fused_mlp.igr_forward_cuda(ipack, x_cube, False))
        finally:
            fused_mlp._igr_lib = own["fused_igr"]
        print(f"fused_igr f32 sums {v_name}: value n=220202 {ms:.4f} ms; RMS "
              f"against exact sums: " + ", ".join(errs))


if __name__ == "__main__":
    main()
