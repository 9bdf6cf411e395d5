// SIREN SDF-MLP forward on one 64-row tile, shared by the fused MLP kernel
// (fused_mlp.cu) and the fused ray sampler (fused_sampler.cu).
//
// Replaces the layer stack of `_siren_kernel` / `_make_siren_forward` in
// isopoints_tpu/ops/pallas_mlp.py. The TPU kernel keeps the whole weight
// stack resident in VMEM; a 3x256 stack is ~0.79 MB in f32, far above the
// 227 KB of shared memory a Hopper block can use. So here each block keeps
// only its tile's activations in shared memory (64 rows x H) and streams
// every hidden layer through shared memory in 32-row k-chunks of W^T.
//
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32, no bf16 split):
// at least as accurate as the TPU's 'f32x3' mode and well inside the 5e-5
// trace tolerance. sin/cos are the accurate sinf/sincosf (never __sinf and
// never -use_fast_math: SIREN arguments reach |w*z| ~ 100, where the fast
// intrinsic's error is far above 5e-5).
//
// A tile is 64 "rows". With C = 1 a row is one point (value only). With
// C = 4 the rows of one point are its value row followed by its 3 tangent
// rows (forward-mode input gradient, J <- (J W^T) * w cos(w z)), so a tile
// holds 16 points and every matmul serves value and tangents at once.
//
// Thread layout: 256 threads = 8 warps. Warp w owns rows 8w..8w+7; lane l
// owns columns l, l+32, ..., l+32(NJ-1) of the hidden width H = 32 NJ.
// Each thread therefore accumulates an 8 x NJ register tile per layer.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace siren {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kRowsPerWarp = 8;
constexpr int kChunk = 32;

struct Net {
  const float* w0;    // (H, 3) first layer, (out, in) as stored by torch
  const float* b0;    // (H,)
  const float* wh_t;  // (L, H, H) hidden layers, transposed to (in, out)
  const float* bh;    // (L, H)
  const float* wout;  // (H,) head of out_dim 1
  const float* bout;  // (1,)
  int n_hidden;       // L
  float omega_first;
  float omega_hidden;
};

// floats of shared memory that tile() uses: activations + one weight chunk
__host__ __device__ constexpr int tile_smem_floats(int hidden) {
  return (kRows + kChunk) * hidden;
}

// Runs the whole MLP on one tile.
//   xs   (kRows / C, 3) input points, shared memory
//   act  (kRows, H) activations, shared memory
//   wbuf (kChunk, H) weight staging, shared memory
//   val  (kRows / C,) output values, shared memory
//   grad (kRows / C, 3) output input-gradients (C == 4 only), shared memory
// Every thread of the block must call it. It ends with a barrier, so the
// caller may read val/grad right after it.
template <int NJ, int C>
__device__ void tile(const Net& net, const float* xs, float* act, float* wbuf,
                     float* val, float* grad) {
  constexpr int H = NJ * 32;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;

  // ---- first layer (3 inputs), straight from the points
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; i += C) {
    const int p = (r0 + i) / C;
    const float x0 = xs[p * 3 + 0], x1 = xs[p * 3 + 1], x2 = xs[p * 3 + 2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      const float* w = net.w0 + c * 3;
      const float z = fmaf(x2, w[2], fmaf(x1, w[1], x0 * w[0])) + net.b0[c];
      const float a = net.omega_first * z;
      if constexpr (C == 1) {
        act[(r0 + i) * H + c] = sinf(a);
      } else {
        float s, co;
        sincosf(a, &s, &co);
        const float d = net.omega_first * co;
        act[(r0 + i) * H + c] = s;
        act[(r0 + i + 1) * H + c] = d * w[0];
        act[(r0 + i + 2) * H + c] = d * w[1];
        act[(r0 + i + 3) * H + c] = d * w[2];
      }
    }
  }
  __syncthreads();

  // ---- hidden layers: (64 x H) @ (H x H), W^T streamed in k-chunks
  for (int l = 0; l < net.n_hidden; ++l) {
    const float* wt = net.wh_t + (size_t)l * H * H;
    float acc[kRowsPerWarp][NJ];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < H; k0 += kChunk) {
      const float4* src = reinterpret_cast<const float4*>(wt + (size_t)k0 * H);
      float4* dst = reinterpret_cast<float4*>(wbuf);
      for (int e = threadIdx.x; e < kChunk * H / 4; e += kThreads) dst[e] = __ldg(src + e);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[kRowsPerWarp], w[NJ];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) a[i] = act[(r0 + i) * H + k0 + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) w[j] = wbuf[kk * H + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();  // all reads of act / wbuf done
    }

    const float* b = net.bh + (size_t)l * H;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; i += C) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        const float a = net.omega_hidden * (acc[i][j] + b[c]);
        if constexpr (C == 1) {
          act[(r0 + i) * H + c] = sinf(a);
        } else {
          float s, co;
          sincosf(a, &s, &co);
          const float d = net.omega_hidden * co;
          act[(r0 + i) * H + c] = s;
          act[(r0 + i + 1) * H + c] = d * acc[i + 1][j];
          act[(r0 + i + 2) * H + c] = d * acc[i + 2][j];
          act[(r0 + i + 3) * H + c] = d * acc[i + 3][j];
        }
      }
    }
    __syncthreads();
  }

  // ---- head (out_dim 1): one warp-shuffle dot product per row
  float wo[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wo[j] = net.wout[lane + 32 * j];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) s = fmaf(act[(r0 + i) * H + lane + 32 * j], wo[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const int row = r0 + i;
      const int p = row / C;
      const int comp = row % C;
      if (comp == 0) {
        val[p] = s + net.bout[0];
      } else {
        grad[p * 3 + comp - 1] = s;
      }
    }
  }
  __syncthreads();
}

}  // namespace siren

// Message for a CUDA error code returned by a launcher (for the wrapper).
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
