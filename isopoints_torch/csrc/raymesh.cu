// Nearest ray-triangle intersection (Möller–Trumbore), one thread per ray.
//
// Replaces no Pallas kernel: isopoints_tpu/ops/raymesh.py
// (`_chunk_intersect` :36, `ray_mesh_intersect` :57) is plain XLA, a dense
// (ray-block x face-chunk) product with a scan over face chunks. Written
// by hand here because its plain PyTorch twin writes about twenty
// (1024 x 4096) float32 intermediates a (ray-block, face-chunk) pass, which
// at the ablation dataset's size (6,291,456 rays x ~161k faces) is minutes
// of device-memory traffic.
//
// Bound on an H100: operations. Every ray meets every face (no BVH, as in
// the JAX package): ~50 float32 operations a test at the CUDA-core rate.
// The faces (36 bytes each) are read once per block from L2.
//
// Design. Faces come pre-packed as (F, 9) float32 rows (v0, e1 = v1 - v0,
// e2 = v2 - v0) and stream through shared memory in tiles of kTile faces,
// staged with coalesced loads of the flat rows. Each thread serves kRays
// rays (i, i + kThreads, ...), so a block reuses a staged face for
// kThreads * kRays = 2048 rays and the L2 traffic per test falls by that
// much. Every thread reads the same face at once (a shared-memory
// broadcast). Each ray keeps a running best (t, face) and replaces it only
// on a strictly smaller t in increasing face order: the lowest index wins a
// tie, as the JAX scan's in-chunk argmin and its strict `<` across chunks
// give. A test that fails on u is cut short before qvec, v and t: ok needs
// u >= -eps, and u > 1 + 1e-6 with v >= -eps gives u + v > 1 + eps after
// rounding, so the cut changes no result.
//
// Arithmetic. Every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract them
// into fused multiply-adds), in the order of the plain PyTorch version
// (ops/raymesh.py `_chunk_intersect`), and 1/det is the correctly rounded
// reciprocal, so the kernel and its plain twin agree bit for bit.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 8;      // rays a thread
constexpr int kTile = 512;    // faces a shared-memory tile (18 KB)
constexpr float kBig = 1e10f;

struct Consts {
  float t_min, eps_det, neg_eps, one_eps, u_cut;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a.x b.x + a.y b.y) + a.z b.z, each operation rounded
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                     float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

__global__ void __launch_bounds__(kThreads)
    raymesh_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
                   const float* __restrict__ faces9, int n, int nf, Consts c,
                   float* __restrict__ t_out, int* __restrict__ face_out) {
  __shared__ float s_face[kTile * 9];
  const long long base = (long long)blockIdx.x * (kThreads * kRays) + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays], best_t[kRays];
  int best_f[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const long long i = base + (long long)r * kThreads;
    const bool ok = i < n;
    ox[r] = ok ? orig[3 * i] : 0.f;
    oy[r] = ok ? orig[3 * i + 1] : 0.f;
    oz[r] = ok ? orig[3 * i + 2] : 0.f;
    dx[r] = ok ? dirs[3 * i] : 1.f;
    dy[r] = ok ? dirs[3 * i + 1] : 1.f;
    dz[r] = ok ? dirs[3 * i + 2] : 1.f;
    best_t[r] = kBig;
    best_f[r] = -1;
  }
  for (int f0 = 0; f0 < nf; f0 += kTile) {
    const int cnt = min(kTile, nf - f0);
    __syncthreads();
    const float* src = faces9 + (long long)f0 * 9;
    for (int k = threadIdx.x; k < cnt * 9; k += kThreads) s_face[k] = src[k];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* fc = s_face + 9 * j;
      const float v0x = fc[0], v0y = fc[1], v0z = fc[2];
      const float e1x = fc[3], e1y = fc[4], e1z = fc[5];
      const float e2x = fc[6], e2y = fc[7], e2z = fc[8];
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        // pvec = cross(d, e2); det = e1 . pvec
        const float px = sub(mul(dy[r], e2z), mul(dz[r], e2y));
        const float py = sub(mul(dz[r], e2x), mul(dx[r], e2z));
        const float pz = sub(mul(dx[r], e2y), mul(dy[r], e2x));
        const float det = dot3(e1x, e1y, e1z, px, py, pz);
        const bool ok_det = fabsf(det) > c.eps_det;
        const float inv = ok_det ? __frcp_rn(det) : 0.f;
        const float tx = sub(ox[r], v0x), ty = sub(oy[r], v0y), tz = sub(oz[r], v0z);
        const float u = mul(dot3(tx, ty, tz, px, py, pz), inv);
        if (!ok_det || !(u >= c.neg_eps) || u > c.u_cut) continue;
        // qvec = cross(tvec, e1)
        const float qx = sub(mul(ty, e1z), mul(tz, e1y));
        const float qy = sub(mul(tz, e1x), mul(tx, e1z));
        const float qz = sub(mul(tx, e1y), mul(ty, e1x));
        const float v = mul(dot3(dx[r], dy[r], dz[r], qx, qy, qz), inv);
        const float t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv);
        const bool ok = v >= c.neg_eps && add(u, v) <= c.one_eps && t > c.t_min;
        if (ok && t < best_t[r]) {
          best_t[r] = t;
          best_f[r] = f0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const long long i = base + (long long)r * kThreads;
    if (i < n) {
      t_out[i] = best_t[r];
      face_out[i] = best_f[r];
    }
  }
}

}  // namespace

// orig, dirs (n, 3) float32; faces9 (nf, 9) float32 rows (v0, e1, e2) ->
// t_out (n,) float32 (1e10 at a miss), face_out (n,) int32 (-1 at a miss).
// The float constants are the float32 values of the plain version's
// thresholds: t_min, 1e-9 (|det|), -1e-7 (u, v), 1 + 1e-7 (u + v) and the
// early cut on u (1 + 1e-6).
extern "C" int raymesh_forward(const float* orig, const float* dirs, const float* faces9, int n,
                               int nf, float t_min, float eps_det, float neg_eps, float one_eps,
                               float u_cut, float* t_out, int* face_out, void* stream) {
  if (n < 0 || nf < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int per_block = kThreads * kRays;
  const int blocks = (int)(((long long)n + per_block - 1) / per_block);
  const Consts c{t_min, eps_det, neg_eps, one_eps, u_cut};
  raymesh_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      orig, dirs, faces9, n, nf, c, t_out, face_out);
  return (int)cudaGetLastError();
}
