// Exact masked k-nearest neighbours, k <= 16.
//
// Replaces `_knn_kernel` (isopoints_tpu/ops/pallas_knn.py:83, reached by
// `knn_points_pallas` :286 through `_knn_flat`, pallas_call :255).
//
// Bound on an H100: operations. Every query meets every point: 8 FLOP for
// the expanded distance plus a compare, against 16 bytes a point and 12
// bytes + k entries a query, so N*P distance evaluations at the f32 CUDA-core
// rate bound it (at P = N = 8000 that is ~0.5 GFLOP, ~8 us at 67 TFLOP/s).
//
// Design: one thread per query, 128 queries a block, the points streamed
// through shared memory in tiles of 1024 (x, y, z, |p|^2; |p|^2 = -1 marks a
// masked point, which never enters a list). Each thread keeps its k best as
// a sorted insertion list in registers, ordered by (distance, index), so
// equal distances keep the lower index first, as the dense path's
// first-occurrence argmin does. The TPU kernel's Morton sort and chunk
// pruning only save work; they wait for a later change.
//
// The squared distance is the dense path's expansion |q|^2 + |p|^2 - 2 q.p,
// clamped at 0, with the norms and the dot product as the fused
// multiply-add chains fma(z, z', fma(y, y', x x')) the plain version (and
// XLA on the CPU) forms, and the remaining sums rounded on their own
// (__fadd_rn: nvcc would otherwise contract them), so the distances agree
// bit for bit with the plain version and near-ties rank the same.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kBig = 1e10f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                     float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const unsigned char* __restrict__ qmask,
               const float* __restrict__ points, const unsigned char* __restrict__ pmask,
               int n, int p, int exclude_self, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const float* pts = points + (size_t)b * p * 3;
  const unsigned char* pm = pmask + (size_t)b * p;
  const bool active = qi < n && qmask[(size_t)b * n + qi] != 0;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + ((size_t)b * n + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qsq = dot3(qx, qy, qz, qx, qy, qz);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = -1;
  }

  for (int base = 0; base < p; base += kTile) {
    const int cnt = min(kTile, p - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const int j = base + e;
      const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
      tile[e] = make_float4(x, y, z, pm[j] ? dot3(x, y, z, x, y, z) : -1.f);
    }
    __syncthreads();
    if (!active) continue;
    for (int e = 0; e < cnt; ++e) {
      const float4 pt = tile[e];
      const int j = base + e;
      if (pt.w < 0.f || (exclude_self && j == qi)) continue;
      const float dot = dot3(qx, qy, qz, pt.x, pt.y, pt.z);
      const float d = fmaxf(__fsub_rn(__fadd_rn(qsq, pt.w), __fmul_rn(2.f, dot)), 0.f);
      // j exceeds every index in the list, so an equal distance stays out
      if (!(d < bd[K - 1])) continue;
      float cd = d;
      int ci = j;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (cd < bd[s] || (cd == bd[s] && ci < bi[s])) {
          const float td = bd[s];
          const int ti = bi[s];
          bd[s] = cd;
          bi[s] = ci;
          cd = td;
          ci = ti;
        }
      }
    }
  }

  if (qi < n) {
    float* od = out_d + ((size_t)b * n + qi) * K;
    int* oi = out_i + ((size_t)b * n + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = bi[s] >= 0 ? bd[s] : kBig;
      oi[s] = bi[s];
    }
  }
}

template <int K>
int launch(const float* q, const unsigned char* qm, const float* p, const unsigned char* pm,
           int bsz, int n, int np, int exclude_self, float* d, int* i, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, bsz);
  knn_kernel<K><<<grid, kThreads, 0, s>>>(q, qm, p, pm, n, np, exclude_self, d, i);
  return (int)cudaGetLastError();
}

}  // namespace

// query (B, n, 3), qmask (B, n), points (B, np, 3), pmask (B, np) ->
// dists (B, n, k) ascending (1e10 where empty), idx (B, n, k) (-1 where
// empty). 1 <= k <= 16; with exclude_self, query i is point i.
extern "C" int knn_forward(const float* query, const unsigned char* qmask, const float* points,
                           const unsigned char* pmask, int bsz, int n, int np, int k,
                           int exclude_self, float* dists, int* idx, void* stream) {
  if (bsz < 0 || n < 0 || np < 0 || k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  if (bsz == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define KNN_CASE(KK) \
  case KK:           \
    return launch<KK>(query, qmask, points, pmask, bsz, n, np, exclude_self, dists, idx, s);
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6) KNN_CASE(7)
    KNN_CASE(8) KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12) KNN_CASE(13)
    KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
#undef KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
