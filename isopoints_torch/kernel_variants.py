"""The measurements behind the kernels' design choices, on the card.

    python -m isopoints_torch.kernel_variants [splat|occ]

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
field's coarse buffer (24,576 rays x 100 + 8). The splat candidate
selection (csrc/splat_select.cu) runs a cluster of 8 blocks of 256
threads per strip and the fine stage (csrc/splat_fine.cu) a
depth-ordered walk that stops early, with a per-warp box cull: this
builds copies of the selection with clusters of 1, 4 and 16 blocks (16
with the non-portable cluster size allowed), with blocks of 512 threads,
and as two kernels (the strip lists through device memory, then a block
per tile), and of the fine stage without the early exit, without the
cull and without both, and times each as the wrapper calls it (CUDA
events) and its kernels alone (`queued_ms`: calls queued behind a spin
of the card, the selection's one `torch.sum` taken off), each output
equal to the built choice's, at the projected step's shape (3000 splats
on the r = 0.5 sphere x 2 views, 256 px) and at the splat frame's
(24,576 splats at 512 px, bench.py's); with `splat`, only these. The
occupancy backward (csrc/occ_bwd.cu) runs a window kernel as a cluster of
8 blocks a cloud and a walk kernel as a block of 16 warps a chunk of at
most 16 points of a 32-pixel cell, with the cotangent's halo in shared
memory, choosing rows: this builds copies with clusters of 1, 4 and 16
blocks, cells of 8 and 16 pixels, chunks of 8 and 32 points and a block a
cell, 4 and 8 warps a block, at most 42 registers a walk thread, without
the row choice or the halo, with the columns cut to the window, and with
the earlier walk (a warp a point over P warps, the cotangent from device
memory), each gradient equal to the built choice's (the earlier walk's
within 1e-5·max(1, max|g|)); and copies that leave out part of the work,
timed only (`_TIMING_ONLY`): the window kernel alone, with and without
its radix rounds 2-4, both kernels exiting at once, the walk's blocks
exiting at once, the walk without its halo loads and without its points.
It times each as the wrapper calls it and its two kernels alone
(`queued_ms`) at the splat frame's inputs (the all-ones cotangent) and at
the DSS point model step's (2 views x 5000 points at 256 px, its signed
cotangent); with `occ`, only these. The wide MLP tile (csrc/mlp_wide.cuh,
the instances at 384 and 512) runs clusters of 2 blocks (a 64-row unit, 64
rows a read of the weights from L2) and sums one k8 step a zeroed tile in
f32: this builds copies of fused_igr_wide and fused_sampler_wide with
clusters of 4 and 8 (two and four units whose blocks share each weight
stage by multicast: 128 and 256 rows a read), and with 2 k8 steps a zeroed
tile, and times each on a
seeded IGR 8x512 field (fused_igr f32 value at 220,202 and 524,288 points,
bf16 value at 524,288, f32 value+grad at 65,536, the coarse sampler at
24,576 rays), each f32 copy's RMS error against exact sums beside
cuBLAS's; with `wide`, only these. Needs nvcc and a CUDA device.
"""

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from isopoints_torch import bench, point_scene
from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import _build, fused_mlp, fused_sampler, knn
from isopoints_torch.rendering import occ_bwd, select, splat
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  compute_splat_params,
                                                  rasterize_splats,
                                                  splat_spacing, stage_inputs)
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


def _variant(src: str, name: str, edits, edit: str = ""):
    """Build csrc/`src`.cu with each `old` of the (old, new) pairs `edits`
    replaced by its `new` in csrc/`edit` (default: the source itself) into
    build/kernel_variants/`name`/."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, edit or src + ".cu")
    text = open(path).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{os.path.basename(path)} does not hold {old!r} once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
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


def queued_ms(fn, reps: int = 20) -> float:
    """Device time (ms) of one call's launches: `reps` calls enqueued
    behind a spin of the card (~5 ms) and timed between two CUDA events, so
    no host time falls inside. Raises if the calls took the host longer
    than the spin."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(10_000_000)
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise RuntimeError("the calls' host time outlasted the spin: the events "
                           "would time the host")
    return start.elapsed_time(end) / reps


def selection_alone_ms(run, sel) -> float:
    """The selection's kernels alone: the wrapper's device time less that
    of its one other device op, the per-cloud sum of the tiles' overflow."""
    nt = sel[6] // sel[7]
    ovf = torch.zeros((sel[0].shape[0], nt * nt), dtype=torch.int64, device=sel[0].device)
    return queued_ms(run) - queued_ms(lambda: torch.sum(ovf, dim=-1))


def _host_us(fn, n: int = 100) -> float:
    """Host time per call of `fn` (µs), over n calls enqueued back to back:
    the wrapper's own cost where the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / n


def _splat_shapes(dev):
    """(label, selection arguments, per-splat table, K, depth cut) at the
    projected step's shape and at the splat frame's."""
    g = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn(1, 3000, 3, generator=g, device=dev)
    v = v / v.norm(dim=-1, keepdim=True)
    mask = torch.rand(1, 3000, generator=g, device=dev) < 0.97
    st = RasterizationSettings(image_size=256, use_pallas=True)
    R, T = look_at_view_transform(2.0, [10.0, -30.0], [20.0, 150.0], device=dev)
    cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
    pts = 0.5 * v
    sp = compute_splat_params(pts.expand(2, -1, -1), v.expand(2, -1, -1),
                              mask.expand(2, -1), cam, st,
                              spacing=splat_spacing(pts, mask, st))
    scene = bench.splat_scene(bench.N_SPLATS, bench.SPLAT_IMAGE_SIZE, dev)
    sf = compute_splat_params(scene.points, scene.normals, scene.mask,
                              scene.camera, scene.settings, spacing=scene.spacing)
    out = []
    for label, p, s in (("projected shape, 3000 splats x 2 views at 256 px", sp, st),
                        (f"splat frame, {bench.N_SPLATS} splats at "
                         f"{bench.SPLAT_IMAGE_SIZE} px", sf, scene.settings)):
        sel, table = stage_inputs(p.pts_ndc, p.ellipse, p.radii, p.cutoff, p.mask, s)
        out.append((label, sel, table, s.points_per_pixel, s.depth_merging_threshold))
    return out


_CLUSTER = "constexpr int kCluster = 8;"
_SMEM = "  const int smem = R * 16;\n"
# the two-kernel arrangement: the cluster's strip phase writes the strip's
# list to device memory and leaves; a block per tile takes it from there
_TWO_KERNELS = (
    ("constexpr int kTileGroup = 4;", """__device__ List g_list;  // the strips' lists, (B, nt, R) each array
__device__ int* g_count;  // (B, nt) the strips' overlap counts

constexpr int kTileGroup = 4;"""),
    ("  List own;\n", """  {
    const size_t s0 = ((size_t)b * nt + g) * R;
    const List gl = {g_list.px + s0, g_list.rx + s0, g_list.key + s0, g_list.idx + s0};
    warp_compact(in_strip, zkey, wlo, whi, v, ties_before, n_tie, slot, [&](int i, int s) {
      gl.px[s] = px[i * in.sp[0]];
      gl.rx[s] = rx[i * in.sp[3]];
      gl.key[s] = zkey(i);
      gl.idx[s] = i;
    });
    if (rank == 0 && threadIdx.x == 0) g_count[(size_t)b * nt + g] = count_s;
    cluster.sync();  // no block leaves while a peer reads its counts
    return;
  }
  List own;
"""),
    ("}  // namespace", """__global__ void __launch_bounds__(kThreads)
    tile_kernel(int S, int T, int nt, int R, int M, float inv_s, float half,
                long long* __restrict__ cidx, unsigned char* __restrict__ cok,
                long long* __restrict__ ovf) {
  __shared__ Shared sh;
  const int g = blockIdx.x / nt, tj = blockIdx.x % nt, b = blockIdx.y;
  const size_t s0 = ((size_t)b * nt + g) * R;
  const List l = {g_list.px + s0, g_list.rx + s0, g_list.key + s0, g_list.idx + s0};
  const int count_s = g_count[(size_t)b * nt + g];
  tile_group(l, min(R, count_s), count_s, b, g, tj, 1, S, T, nt, R, M, inv_s, half, sh, cidx,
             cok, ovf);
}

}  // namespace"""),
    ("  cfg.dynamicSmemBytes = smem;\n", """  static void* buf = nullptr;
  static size_t n_set = 0, c_set = 0;
  const size_t n = (size_t)B * nt * R, n_c = (size_t)B * nt;
  if (n != n_set || n_c != c_set) {  // the lists' storage, once per shape
    cudaFree(buf);
    if (cudaMalloc(&buf, n * 16 + n_c * 4) != cudaSuccess) return (int)cudaErrorMemoryAllocation;
    const List gl = {(float*)buf, (float*)buf + n, (unsigned*)buf + 2 * n, (int*)buf + 3 * n};
    int* gc = (int*)buf + 4 * n;
    cudaMemcpyToSymbol(g_list, &gl, sizeof gl);
    cudaMemcpyToSymbol(g_count, &gc, sizeof gc);
    n_set = n;
    c_set = n_c;
  }
  cfg.dynamicSmemBytes = 0;
"""),
    ("  if (err != cudaSuccess) return (int)err;\n  return (int)cudaGetLastError();",
     """  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<dim3(nt * nt, B), kThreads, 0, cfg.stream>>>(S, T, nt, R, M, inv_s, half, cidx,
                                                             cok, ovf);
  return (int)cudaGetLastError();"""),
)
_SELECT_VARIANTS = {
    "1 block a strip": ((_CLUSTER, "constexpr int kCluster = 1;"),),
    "4 blocks": ((_CLUSTER, "constexpr int kCluster = 4;"),),
    "16 blocks": ((_CLUSTER, "constexpr int kCluster = 16;"),
                  (_SMEM, _SMEM + "  cudaFuncSetAttribute(select_kernel, "
                   "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")),
    "8 blocks of 512 threads": (("constexpr int kThreads = 256;",
                                 "constexpr int kThreads = 512;"),),
    "8 blocks, two kernels": _TWO_KERNELS,
}
_EXIT = "    if (__all_sync(kFull, done)) break;\n"
_CULL = """      near = __fsub_rn(x_hi, cx) >= -rx && __fsub_rn(x_lo, cx) <= rx &&
             __fsub_rn(y_hi, cy) >= -ry && __fsub_rn(y_lo, cy) <= ry;"""
_FINE_VARIANTS = {
    "no early exit": ((_EXIT, ""),),
    "no cull": ((_CULL, "      near = true;"),),
    "neither": ((_EXIT, ""), (_CULL, "      near = true;")),
}


def _splat_jobs():
    """The selection's and the fine stage's copies, their builds started."""
    jobs = {("splat_select", v): _variant("splat_select", "select_" + str(i), e)
            for i, (v, e) in enumerate(_SELECT_VARIANTS.items())}
    jobs.update({("splat_fine", v): _variant("splat_fine", "fine_" + str(i), e)
                 for i, (v, e) in enumerate(_FINE_VARIANTS.items())})
    return jobs


def splat_variants(dev, jobs) -> None:
    """The selection's cluster sizes, block width and two-kernel
    arrangement, the fine stage without its early exit or its cull, at both
    shapes, each a copy of the source (`_splat_jobs`)."""
    module = {"splat_select": select, "splat_fine": splat}
    fn = {"splat_select": "select_candidates", "splat_fine": "rasterize_fine"}
    own = {name: m._lib for name, m in module.items()}
    libs = {}
    for key, (so, proc) in jobs.items():
        try:
            libs[key] = _load(so, proc, own[key[0]](), fn[key[0]])
        except RuntimeError as e:
            print(f"{key[0]} {key[1]}: did not build ({e})")

    def timed(name, variant, run, alone, ref):
        """`run` on the copy `variant` of `name` (None: as built): its
        output held to `ref`, its time by events and alone."""
        if variant is not None:
            module[name]._lib = lambda lib=libs[(name, variant)]: lib
        try:
            try:
                got = run()
            except RuntimeError as e:   # a cluster of 16 the card refuses
                return f"{variant}: did not launch ({e})"
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"{name} {variant} differs from the built "
                                   f"choice's outputs")
            return (f"{variant or 'as built'} {_time(run):.4f} ms (alone "
                    f"{alone(run):.4f} ms)"
                    + ("" if variant else f" (host {_host_us(run):.1f} us a call)"))
        finally:
            module[name]._lib = own[name]

    for label, sel, table, K, dm in _splat_shapes(dev):
        run = lambda: select.select_candidates_cuda(*sel)
        built = run()
        alone = lambda r: selection_alone_ms(r, sel)
        row = [timed("splat_select", v, run, alone, built)
               for v in (None, *_SELECT_VARIANTS) if v is None or ("splat_select", v) in libs]
        print(f"splat_select, {label}: " + "; ".join(row))
        ci, ok, _ = built
        run = lambda: splat.rasterize_fine_cuda(table, ci, ok, sel[6], sel[7], K, dm)
        ref = run()
        row = [timed("splat_fine", v, run, queued_ms, ref)
               for v in (None, *_FINE_VARIANTS) if v is None or ("splat_fine", v) in libs]
        print(f"splat_fine, {label}: " + "; ".join(row))


def occ_cases(dev):
    """(label, occupancy backward inputs (pts, radii, visible, grad,
    settings)): the splat frame's (bench.py's 24,576 splats at 512 px; the
    all-ones cotangent of Σ occupancy, expanded as autograd hands it over)
    and the point model step's own (its signed cotangent)."""
    scene = bench.splat_scene(bench.N_SPLATS, bench.SPLAT_IMAGE_SIZE, dev)
    st = scene.settings
    with torch.no_grad():
        sp = compute_splat_params(scene.points, scene.normals, scene.mask,
                                  scene.camera, st, spacing=scene.spacing)
        fr = rasterize_splats(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask, st)
    S = st.image_size
    frame = (sp.pts_ndc, sp.radii, fr.visibility & sp.mask,
             torch.ones((1, 1, 1), device=dev).expand(1, S, S), st)
    ps = point_scene.point_model_scene(dev)
    _, calls = point_scene.record_occ_calls(lambda: point_scene.point_model_step(ps))
    pts = calls[0][0]
    return [(f"splat frame, {bench.N_SPLATS} splats at {S} px, all-ones cotangent",
             frame),
            (f"point model step, {pts.shape[1]} points x {pts.shape[0]} views at "
             f"{ps.model.raster_settings.image_size} px, its signed cotangent",
             calls[0])]


_WALK_LAUNCH = "  const dim3 grid((P + kChunk - 1) / kChunk + L.ncell, B);  // at least the chunks\n"
# the earlier walk (the kernel before the redesign): a warp a list entry
# over P warps, eight a block, so most warps exit at once; the cotangent
# from device memory; every column of each row in the window
_EARLIER_WALK = (
    ("}  // namespace", r"""__global__ void earlier_walk_kernel(const float* __restrict__ pts,
                                   const float* __restrict__ radii,
                                   const float* __restrict__ grad, long long g_sb,
                                   long long g_sr, long long g_sc, Layout L,
                                   int* __restrict__ scratch, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int e = blockIdx.x * 8 + (threadIdx.x >> 5);
  const Scratch sc = cloud_scratch(scratch, L, b);
  if (e >= sc.head[1]) return;  // the whole warp
  const size_t q = (size_t)b * L.P + sc.ids[e];
  const float* img = grad + b * g_sb;
  const float sr2 = __int_as_float(sc.head[0]);
  const float px = pts[3 * q], py = pts[3 * q + 1];
  const float rx = radii[2 * q], ry = radii[2 * q + 1];
  const int c0 = patch_origin(px, L.S, L.W), r0 = patch_origin(py, L.S, L.W);
  float gx = 0.f, gy = 0.f;
  for (int i = 0; i < L.W; ++i) {
    const int row = r0 + i;
    const float dy = __fsub_rn(common::pixel_ndc(row, L.S, L.inv_s), py);
    const float dy2 = __fmul_rn(dy, dy);
    if (dy2 > sr2) continue;
    const bool out_y = fabsf(dy) > ry;
    for (int j = lane; j < L.W; j += 32) {
      const int col = c0 + j;
      const float g = img[row * g_sr + col * g_sc];
      if (g == 0.f) continue;
      const float dx = __fsub_rn(common::pixel_ndc(col, L.S, L.inv_s), px);
      const float dist2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
      if (!(dist2 <= sr2) || (g > 0.f && (fabsf(dx) > rx || out_y))) continue;
      const float denom = fmaxf(dist2, (float)1e-10);
      gx = __fadd_rn(gx, __fmul_rn(__fdiv_rn(dx, denom), g));
      gy = __fadd_rn(gy, __fmul_rn(__fdiv_rn(dy, denom), g));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    gx = __fadd_rn(gx, __shfl_down_sync(kFull, gx, o));
    gy = __fadd_rn(gy, __shfl_down_sync(kFull, gy, o));
  }
  if (lane == 0) reinterpret_cast<float2*>(out)[q] = make_float2(gx, gy);
}

}  // namespace"""),
    (_WALK_LAUNCH, """  earlier_walk_kernel<<<dim3((P + 7) / 8, B), 256, 0, st>>>(pts, radii, grad, g_sb, g_sr,
                                                             g_sc, L, scratch, out);
  return (int)cudaGetLastError();
""" + _WALK_LAUNCH),
)
_WIN = "constexpr int kWinCluster = 8;"
_OCC_VARIANTS = {
    "one block a cloud": ((_WIN, "constexpr int kWinCluster = 1;"),),
    "4 blocks a cloud": ((_WIN, "constexpr int kWinCluster = 4;"),),
    "16 blocks a cloud": ((_WIN, "constexpr int kWinCluster = 16;"),
                          ("  err = cudaLaunchKernelEx(", "  cudaFuncSetAttribute(window_kernel, "
                           "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                           "  err = cudaLaunchKernelEx(")),
    "cells of 16 px": (("constexpr int kCell = 32;", "constexpr int kCell = 16;"),),
    "cells of 8 px": (("constexpr int kCell = 32;", "constexpr int kCell = 8;"),),
    "chunks of 8 points": (("constexpr int kChunk = 16;", "constexpr int kChunk = 8;"),),
    "chunks of 32 points": (("constexpr int kChunk = 16;", "constexpr int kChunk = 32;"),),
    "a block a cell": (("constexpr int kChunk = 16;", "constexpr int kChunk = 1 << 30;"),),
    "4 warps a block": (("constexpr int kWarps = 16;", "constexpr int kWarps = 4;"),),
    "8 warps a block": (("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),),
    "no row choice": (("const unsigned f = kHalo ? flags[row - hr0] : 3u;",
                       "const unsigned f = 3u;"),),
    # a column whose fl(dx^2) exceeds search_r2 holds no pixel of the window
    "columns cut to the window": (("const bool ina = ja < L.W, inb = jb < L.W;",
                                   "const bool ina = ja < L.W && !(dxa2 > sr2), "
                                   "inb = jb < L.W && !(dxb2 > sr2);"),),
    "no halo": (("  const bool use_halo = halo_smem <= max_smem;",
                 "  const bool use_halo = false;"),),
    "the earlier walk": _EARLIER_WALK,
    "the window kernel alone": ((_WALK_LAUNCH, "  return (int)cudaGetLastError();\n"
                                 + _WALK_LAUNCH),),
    "the window kernel alone, without radix rounds 2-4": (
        (_WALK_LAUNCH, "  return (int)cudaGetLastError();\n" + _WALK_LAUNCH),
        ("for (int a = 0; n > 0 && a < 2; ++a) {", "for (int a = 0; false && a < 2; ++a) {"),
        ("  if (n > 0) {\n    cluster.sync();", "  if (false) {\n    cluster.sync();"),
        ("  if (n > 0) {\n    const int n_cand", "  if (false) {\n    const int n_cand")),
    "at most 42 registers a walk thread": (
        ("__launch_bounds__(32 * kWarps)", "__launch_bounds__(32 * kWarps, 3)"),),
    "both kernels exit at once": (
        ("  cg::cluster_group cluster = cg::this_cluster();",
         "  if (L.P > 0) return;\n  cg::cluster_group cluster = cg::this_cluster();"),
        ("  if ((int)blockIdx.x >= sc.head[2]) return;  // past the chunks", "  return;")),
    "the walk's blocks exit at once": (
        ("  if ((int)blockIdx.x >= sc.head[2]) return;  // past the chunks", "  return;"),),
    "the walk without its halo loads": (
        ("halo[r * L.hs + c] = src[c * g_sc];", "halo[r * L.hs + c] = 1.f;"),),
    "the walk without its points": (
        ("  for (; e < end; e += kWarps) {", "  for (e = end; e < end; e += kWarps) {"),),
}
# copies that leave out part of the work: timed, their output not checked
_TIMING_ONLY = ("the window kernel alone", "the window kernel alone, without radix rounds 2-4",
                "both kernels exit at once",
                "the walk's blocks exit at once", "the walk without its halo loads",
                "the walk without its points")


def _occ_jobs():
    """The occupancy backward's copies, their builds started."""
    return {v: _variant("occ_bwd", "occ_" + str(i), e)
            for i, (v, e) in enumerate(_OCC_VARIANTS.items())}


def occ_variants(dev, jobs) -> None:
    """The occupancy backward's window cluster, cell and block sizes, the
    walk's chunk size, the walk without its halo or row choice, with the
    columns cut to the window, and the earlier walk,
    each a copy of the source (`_occ_jobs`), timed as the wrapper calls it
    (CUDA events) and its two kernels alone (`queued_ms`) at the splat
    frame's inputs and the point model step's, and the window kernel alone
    (the walk not launched). Each copy's gradient equals the built one's
    bit for bit (the same per-point sums), the earlier walk's (its own
    order) is within 1e-5·max(1, max|g|) of it."""
    own = occ_bwd._lib
    libs = {}
    for v, (so, proc) in jobs.items():
        try:
            libs[v] = _load(so, proc, own(), "occ_backward")
            libs[v].occ_scratch_ints.argtypes = own().occ_scratch_ints.argtypes
            libs[v].occ_scratch_ints.restype = own().occ_scratch_ints.restype
        except RuntimeError as e:
            print(f"occ_bwd {v}: did not build ({e})")
    for label, args in occ_cases(dev):
        run = lambda: occ_bwd.occ_backward_cuda(*args)
        built = run()
        row = [f"as built {_time(run):.4f} ms (alone {queued_ms(run):.4f} ms) "
               f"(host {_host_us(run):.1f} us a call)"]
        for v, lib in libs.items():
            occ_bwd._lib = lambda lib=lib: lib
            try:
                try:
                    got = run()
                except RuntimeError as e:   # a cluster the card refuses
                    row.append(f"{v}: did not launch ({e})")
                    continue
                same = (torch.allclose(got, built, rtol=0, atol=1e-5 * max(
                    1.0, float(built.abs().max()))) if v == "the earlier walk"
                    else v in _TIMING_ONLY or torch.equal(got, built))
                if not same:
                    raise RuntimeError(f"occ_bwd {v} differs from the built choice's "
                                       f"gradient")
                row.append(f"{v} {_time(run):.4f} ms (alone {queued_ms(run):.4f} ms)")
            finally:
                occ_bwd._lib = own
        print(f"occ_bwd, {label}: " + "; ".join(row))


# the wide MLP tile (csrc/mlp_wide.cuh): its cluster and its f32 sums as
# built, and the copies that replace one choice. A cluster of 1 (a block
# holding all 512 columns of its 64 rows) does not fit: its accumulators and
# zeroed tiles would take 2 x 64 x 512 registers, the whole register file.
_WIDE_UNITS = "constexpr int kUnits = 1;"
_WIDE_STEPS = "constexpr int kF32Steps = 1;"
_WIDE_VARIANTS = {
    "as built (cluster of 2: one 64-row unit, 64 rows a weight read)": [],
    "cluster of 4 (two units, weights multicast: 128 rows a read)":
        [(_WIDE_UNITS, "constexpr int kUnits = 2;")],
    "cluster of 8 (four units, weights multicast: 256 rows a read)":
        [(_WIDE_UNITS, "constexpr int kUnits = 4;")],
    "f32: 2 k8 steps a zeroed tile": [(_WIDE_STEPS, "constexpr int kF32Steps = 2;")],
}


def _wide_jobs():
    """A copy of fused_igr_wide and fused_sampler_wide per wide variant."""
    return {(src, v): _variant(src, f"{src}_{i}", edits, "mlp_wide.cuh")
            for i, (v, edits) in enumerate(_WIDE_VARIANTS.items())
            for src in ("fused_igr_wide", "fused_sampler_wide")}


def wide_variants(dev, jobs) -> None:
    """Each wide variant on a seeded IGR 8x512 field (no encoding, skip at
    4): fused_igr f32 value at 4508 points and bf16 value at 8192 (the
    training path's most frequent launches, phase 20 (b) of chip_smoke.py),
    f32 value at 220,202 and 524,288 points, bf16 value at 524,288, f32
    value+grad at 65,536, and the coarse sampler at 24,576 rays x 100 steps
    + 8 secant (margin 2e-3), each timed as the wrapper calls it (CUDA
    events, median of 7). The cluster copies give the built outputs bit for
    bit (a row's sums do not depend on the cluster); the f32 sums' copy
    keeps the bf16 mode's and the sampler's picks, and holds the f32 values
    within 2e-5 of the plain version; each copy's RMS error against exactly
    summed values is printed beside cuBLAS's (TF32 off) at 220,202 points."""
    from isopoints_torch.models.fields import SDFField
    own = {"fused_igr_wide": fused_mlp._igr_lib, "fused_sampler_wide": fused_sampler._lib}
    like = {"fused_igr_wide": own["fused_igr_wide"](True),
            "fused_sampler_wide": own["fused_sampler_wide"](True)}
    fn = {"fused_igr_wide": "igr_forward", "fused_sampler_wide": "sampler_sweep"}
    libs = {key: _load(so, proc, like[key[0]], fn[key[0]]) for key, (so, proc) in jobs.items()}
    gen = torch.Generator(device=dev).manual_seed(19)
    field = SDFField(hidden_size=512, n_layers=8, num_frequencies=0, generator=gen, device=dev)
    fine = fused_mlp.make_fused_igr_sdf(field)
    pack = fine.pack
    xs = {n: torch.rand((n, 3), generator=gen, device=dev) * 2.4 - 1.2
          for n in (4508, 8192, 65_536, 220_202, 524_288)}
    rms = lambda a, b: float((a - b).square().mean().sqrt())
    exact = fused_mlp.igr_sdf_plain(pack, xs[220_202], False, True)
    plain = fused_mlp.igr_sdf_plain(pack, xs[220_202])
    cublas = rms(plain, exact)
    n_rays = 24_576
    g = torch.Generator(device=dev).manual_seed(n_rays)
    cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n_rays, 3).contiguous()
    d = torch.randn((n_rays, 3), generator=g, device=dev) * 0.3
    d[:, 2] = 1.0
    d = d / d.norm(dim=-1, keepdim=True)
    t_lo = 0.8 + 0.4 * torch.rand(n_rays, generator=g, device=dev)
    t_hi = t_lo + 2.2 * torch.rand(n_rays, generator=g, device=dev)
    s_args = (cam, d, t_lo, t_hi, linspace01(100, dev))
    s_kw = dict(n_secant=8, margin=2e-3, coarse_sweep=True)
    runs = {
        "f32 value n=4508": lambda: fine(xs[4508]),
        "bf16 value n=8192": lambda: fused_mlp.igr_forward_cuda(pack, xs[8192], False, True)[0],
        "f32 value n=220202": lambda: fine(xs[220_202]),
        "f32 value n=524288": lambda: fine(xs[524_288]),
        "bf16 value n=524288": lambda: fused_mlp.igr_forward_cuda(pack, xs[524_288], False, True)[0],
        "f32 value+grad n=65536": lambda: fine.sdf_and_grad(xs[65_536]),
        f"coarse sampler {n_rays} rays x 100 + 8": lambda: fine.fused_ray_sampler(*s_args, **s_kw),
    }
    print(f"wide MLP tile, IGR 8x512: fused_igr f32 RMS error against exact sums at "
          f"220,202 points, cuBLAS (float32, TF32 off) {cublas:.4g}")
    ref = {}
    for i, v in enumerate(_WIDE_VARIANTS):
        fused_mlp._igr_lib = lambda wide=False, lib=libs[("fused_igr_wide", v)]: lib
        fused_sampler._lib = lambda wide=False, lib=libs[("fused_sampler_wide", v)]: lib
        try:
            row = []
            for label, run in runs.items():
                out = run()
                out = out if isinstance(out, tuple) else (out,)
                if i == 0:
                    ref[label] = out
                same = all(torch.equal(a, b) for a, b in zip(out, ref[label]))
                if "steps" in v and label.startswith("f32"):
                    if "n=220202" in label and float((out[0] - plain).abs().max()) > 2e-5:
                        raise RuntimeError(f"the {v} copy misses the f32 tolerance")
                elif "steps" in v and label.startswith("coarse"):
                    # the bf16 sweep's picks; the f32 tail's outputs move
                    same = all(torch.equal(out[i], ref[label][i]) for i in (0, 2))
                if not same and not ("steps" in v and label.startswith("f32")):
                    raise RuntimeError(f"the {v} copy differs from the built outputs ({label})")
                row.append(f"{label} {_time(run):.3f} ms")
                if label == "f32 value n=220202":
                    e = rms(out[0], exact)
                    row[-1] += f" (RMS {e:.4g}, {e / cublas:.3f} x cuBLAS)"
        finally:
            fused_mlp._igr_lib = own["fused_igr_wide"]
            fused_sampler._lib = own["fused_sampler_wide"]
        print(f"wide tile, {v}: " + "; ".join(row))


def main() -> None:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = sys.argv[1:]
    if mode not in ([], ["splat"], ["occ"], ["wide"]):
        raise SystemExit("usage: python -m isopoints_torch.kernel_variants [splat|occ|wide]")
    splat_jobs = _splat_jobs() if mode in ([], ["splat"]) else {}
    occ_jobs = _occ_jobs() if mode in ([], ["occ"]) else {}
    wide_jobs = _wide_jobs() if mode in ([], ["wide"]) else {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if mode:                            # the splat stages, the occupancy backward or the wide tile
        print(card or torch.cuda.get_device_name(0))
        if mode == ["splat"]:
            splat_variants(dev, splat_jobs)
        elif mode == ["occ"]:
            occ_variants(dev, occ_jobs)
        else:
            wide_variants(dev, wide_jobs)
        return
    jobs = {("fused_mlp", rg): _variant(
        "fused_mlp", f"fused_mlp_rows{32 * rg}", ((_RULE, f"  switch ({rg}) {{"),))
        for rg in (1, 4)}
    f32_names = ("as built",) + tuple(_F32_VARIANTS)
    jobs.update({("fused_igr", v): _variant(
        "fused_igr", "f32_" + v.replace(" ", "_"),
        ((_F32_BUILT, _F32_BUILT if v == "as built" else _F32_VARIANTS[v]),),
        "mlp_mma.cuh") for v in f32_names})
    # the wrappers launch through their module's _lib(), swapped per copy
    own = {"fused_mlp": fused_mlp._lib, "fused_igr": fused_mlp._igr_lib}
    like = {name: own[name]() for name in own}
    fn = {"fused_mlp": "siren_forward", "fused_igr": "igr_forward"}
    libs = {key: _load(so, proc, like[key[0]], fn[key[0]])
            for key, (so, proc) in jobs.items()}
    print(f"{card or torch.cuda.get_device_name(0)}; launches of the kernels as built "
          f"(the wrappers), with each constant replaced")
    splat_variants(dev, splat_jobs)
    occ_variants(dev, occ_jobs)
    wide_variants(dev, wide_jobs)

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
            fused_mlp._lib = lambda wide=False, lib=libs[("fused_mlp", rg)]: lib
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
        fused_mlp._igr_lib = lambda wide=False, lib=libs[("fused_igr", v_name)]: lib
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
