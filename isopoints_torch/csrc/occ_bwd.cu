// DSS occupancy backward: the xy gradient of every point from the occupancy
// map's cotangent. For a renderable point, the sum over the pixels of its
// W x W patch with grad != 0 and dist^2 <= search_r2 of
// (pixel - point) / dist^2 * grad, leaving out pixels with grad > 0 outside
// the point's own (unscaled) splat bbox.
//
// Replaces `occ_backward_pallas_one` (isopoints_tpu/rendering/
// pallas_occ_bwd.py:41, pallas_call :145). Same contract as the plain
// `occ_backward_one_plain` (rendering/occ_bwd.py), the port of the XLA
// formulation `_occ_backward_one` (isopoints_tpu/rendering/rasterizer.py:481):
// the wrapper computes the per-cloud search radius (the median of the
// renderable radii times `radii_backward_scaler`, clamped so the patch covers
// it) and the renderable flags on the device, and the kernel walks the same
// W x W patch, placed and clipped as :529-532 place it. The TPU kernel's
// 8-aligned row bands and 64-column strips are layout rules of its compiler
// and have no counterpart here.
//
// Bound on an H100: operations, ~15 FLOP per (point, patch pixel) (dx,
// dist^2, four compares, the max, two divisions, two products, two
// sums), P * W^2 * 15 a cloud, against ~28 bytes a point and 4 a pixel.
//
// Design: one warp per point, eight points per block. The lanes take
// neighbouring columns of a patch row (coalesced reads of the cotangent
// image, which stays in L2: 1 MB at 512 px); a row whose fl(dy^2) exceeds
// search_r2 is skipped whole, which changes no term since
// fl(fl(dx^2) + fl(dy^2)) >= fl(dy^2). dist^2 is dx * dx + dy * dy, rounded
// after each operation as XLA forms it there (no fused multiply-add), and
// the denominator max(dist^2, 1e-10) (equal to the XLA path's
// eps_denom(dist^2, 1e-10) for dist^2 >= 0). Each lane sums its pixels in
// row order and the warp reduces with a fixed shuffle tree: no atomics, so
// the result is repeatable bit for bit.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void occ_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ radii,
                               const unsigned char* __restrict__ ok,
                               const float* __restrict__ grad, const float* __restrict__ search_r2,
                               int P, int S, int W, float inv_s, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  float gx = 0.f, gy = 0.f;
  if (ok[p]) {
    const float px = pts[3 * p], py = pts[3 * p + 1];
    const float rx = radii[2 * p], ry = radii[2 * p + 1];
    const float sr2 = *search_r2;
    // patch origin: the point's pixel (S (1 - ndc) - 1) / 2, rounded half to
    // even, minus W/2, clipped to the image
    const float col_f = __fmul_rn(__fsub_rn(__fmul_rn((float)S, __fsub_rn(1.f, px)), 1.f), 0.5f);
    const float row_f = __fmul_rn(__fsub_rn(__fmul_rn((float)S, __fsub_rn(1.f, py)), 1.f), 0.5f);
    const int c0 = min(max((int)rintf(col_f) - W / 2, 0), S - W);
    const int r0 = min(max((int)rintf(row_f) - W / 2, 0), S - W);
    for (int i = 0; i < W; ++i) {
      const int row = r0 + i;
      const float dy = __fsub_rn(common::pixel_ndc(row, S, inv_s), py);
      const float dy2 = __fmul_rn(dy, dy);
      if (dy2 > sr2) continue;
      const float* grow = grad + (size_t)row * S;
      const bool out_y = fabsf(dy) > ry;
      for (int j = lane; j < W; j += 32) {
        const int col = c0 + j;
        const float g = grow[col];
        if (g == 0.f) continue;
        const float dx = __fsub_rn(common::pixel_ndc(col, S, inv_s), px);
        const float dist2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
        const bool outside = fabsf(dx) > rx || out_y;
        if (!(dist2 <= sr2) || (g > 0.f && outside)) continue;
        const float denom = fmaxf(dist2, 1e-10f);
        gx = __fadd_rn(gx, __fmul_rn(__fdiv_rn(dx, denom), g));
        gy = __fadd_rn(gy, __fmul_rn(__fdiv_rn(dy, denom), g));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gx = __fadd_rn(gx, __shfl_down_sync(0xffffffffu, gx, o));
    gy = __fadd_rn(gy, __shfl_down_sync(0xffffffffu, gy, o));
  }
  if (lane == 0) {
    out[2 * p] = gx;
    out[2 * p + 1] = gy;
  }
}

}  // namespace

// One cloud: pts (P, 3) float32 [x_ndc, y_ndc, depth], radii (P, 2) float32,
// ok (P,) uint8 renderable flags, grad (S, S) float32 occupancy cotangent,
// search_r2 one float32 on the device -> out (P, 2) float32. 1 <= W <= S;
// inv_s = 1/S rounded to float.
extern "C" int occ_backward(const float* pts, const float* radii, const unsigned char* ok,
                            const float* grad, const float* search_r2, int P, int S, int W,
                            float inv_s, float* out, void* stream) {
  if (P < 0 || S < 1 || W < 1 || W > S) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int blocks = (P + kWarps - 1) / kWarps;
  occ_bwd_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, radii, ok, grad, search_r2, P, S, W, inv_s, out);
  return (int)cudaGetLastError();
}
