// IGR SDF-MLP forward on one 64-row tile of the CUDA cores, shared by the
// fused ray sampler (fused_sampler.cu) and the in-kernel march
// (fused_trace.cu); the fused IGR kernel (fused_igr.cu) runs the tensor-core
// tile of igr_mma.cuh, which takes its softplus and bf16 rounding from here.
//
// Replaces the layer stack of `_igr_kernel` / `_make_igr_forward` in
// isopoints_tpu/ops/pallas_mlp.py (:153, :417): L+2 linear layers, softplus
// with beta = 100 after every layer but the head, the input concatenated
// back and the row scaled by 1/sqrt(2) before the layers of the skip mask,
// an optional final tanh. The tile layout is siren.cuh's: 64 rows of H
// activations in shared memory, each hidden layer's W^T streamed through
// shared memory in 32-row chunks, 8 warps owning 8 rows each and lane l
// columns l, l+32, ... With C = 4 the rows of a point are its value row and
// its three forward-mode tangent rows, J <- (J W^T) * sigmoid(beta z).
//
// The skip without a concatenation: the layer before a skip has H - 3
// outputs, packed as H with three zero rows of W and zero biases. Its
// activation is stored as usual and then the last three columns are
// overwritten by the point (tangent rows: e_k) and the whole row is scaled
// by 1/sqrt(2), which is the JAX kernel's concat([h, x]) * (1/sqrt 2) with
// the same f32 roundings. So the tile needs no memory beyond the points.
//
// Precision. `Net::bf16` off: plain f32 FMA (no TF32, no bf16 split), at
// least as accurate as the TPU's 'f32x3' and equal to 'highest' up to the
// summation order. On: the JAX 'bf16' mode, every matmul operand rounded to
// bf16 (round to nearest even), value and tangent rows alike, and the
// products accumulated in f32. A bf16 x bf16 product is exact in f32, so
// the same FMA loop computes it once the operands are rounded: the weights
// come pre-rounded from the host and the activations are rounded where they
// are stored as the next layer's operand. Biases stay f32. softplus is JAX's
// logaddexp(beta z, 0) = max(beta z, 0) + log1p(exp(-|beta z|)), divided by
// beta, with the accurate expf/log1pf/tanhf (never -use_fast_math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace igr {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kRowsPerWarp = 8;
constexpr int kChunk = 32;
constexpr float kBeta = 100.f;
constexpr float kInvSqrt2 = 0.70710678118654752f;  // f32(1 / sqrt(2)), as JAX rounds it

struct Net {
  const float* w0;    // (H, 3) first layer, (out, in); rows past its width zero
  const float* b0;    // (H,)
  const float* wh_t;  // (L, H, H) hidden layers transposed to (in, out), zero-padded
  const float* bh;    // (L, H)
  const float* wout;  // (H,) head of out_dim 1
  const float* bout;  // (1,)
  int n_hidden;       // L: the layers between the first and the head
  unsigned skip;      // bit l set: layer l (1 <= l <= L + 1) takes [h, x] / sqrt(2)
  int final_tanh;
  int bf16;           // operands rounded to bf16 (the weights come pre-rounded)
};

// floats of shared memory that tile() uses: activations + one weight chunk
__host__ __device__ constexpr int tile_smem_floats(int hidden) {
  return (kRows + kChunk) * hidden;
}

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// softplus(beta z) / beta and its derivative sigmoid(beta z)
__device__ __forceinline__ void softplus(float z, float& a, float& d) {
  const float bz = __fmul_rn(kBeta, z);
  a = __fdiv_rn(__fadd_rn(fmaxf(bz, 0.f), log1pf(expf(-fabsf(bz)))), kBeta);
  d = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-bz)));
}

// Stores column c of a point's activation (value a, tangents d * t[k]) as
// the next layer's operand, doing that layer's skip when `skip` is set.
template <int C>
__device__ __forceinline__ void store(float* act, int row, int c, int H, float a, float d,
                                      const float* t, const float* x, bool skip, bool bf) {
  const int k = c - (H - 3);
  const bool xcol = skip && k >= 0;
  float v = xcol ? x[k] : a;
  if (skip) v = __fmul_rn(v, kInvSqrt2);
  act[row * H + c] = operand(v, bf);
  if constexpr (C == 4) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float tv = xcol ? (k == q ? 1.f : 0.f) : __fmul_rn(d, t[q]);
      if (skip) tv = __fmul_rn(tv, kInvSqrt2);
      act[(row + 1 + q) * H + c] = operand(tv, bf);
    }
  }
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
__device__ void tile(const Net& net, const float* xs, float* act, float* wbuf, float* val,
                     float* grad) {
  constexpr int H = NJ * 32;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  const bool bf = net.bf16 != 0;

  // ---- first layer (3 inputs), straight from the points
  {
    const bool skip = (net.skip >> 1) & 1u;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; i += C) {
      const float* x = xs + ((r0 + i) / C) * 3;
      const float x0 = operand(x[0], bf), x1 = operand(x[1], bf), x2 = operand(x[2], bf);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        const float* w = net.w0 + c * 3;
        const float z = __fadd_rn(fmaf(x2, w[2], fmaf(x1, w[1], __fmul_rn(x0, w[0]))), net.b0[c]);
        float a, d;
        softplus(z, a, d);
        store<C>(act, r0 + i, c, H, a, d, w, x, skip, bf);
      }
    }
  }
  __syncthreads();

  // ---- hidden layers: (64 x H) @ (H x H), W^T streamed in k-chunks
  for (int l = 0; l < net.n_hidden; ++l) {
    const bool skip = (net.skip >> (l + 2)) & 1u;
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
      const float* x = xs + ((r0 + i) / C) * 3;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        float a, d;
        softplus(__fadd_rn(acc[i][j], b[c]), a, d);
        float t[3] = {0.f, 0.f, 0.f};
        if constexpr (C == 4) {
          t[0] = acc[i + 1][j];
          t[1] = acc[i + 2][j];
          t[2] = acc[i + 3][j];
        }
        store<C>(act, r0 + i, c, H, a, d, t, x, skip, bf);
      }
    }
    __syncthreads();
  }

  // ---- head (out_dim 1): one warp-shuffle dot product per row, then tanh
  float wo[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wo[j] = net.wout[lane + 32 * j];
  float s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) v = fmaf(act[(r0 + i) * H + lane + 32 * j], wo[j], v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    s[i] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; i += C) {
      const int p = (r0 + i) / C;
      float h = __fadd_rn(s[i], net.bout[0]);
      float d = 1.f;
      if (net.final_tanh) {
        const float t = tanhf(h);
        d = __fsub_rn(1.f, __fmul_rn(t, t));
        h = t;
      }
      val[p] = h;
      if constexpr (C == 4) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          grad[p * 3 + q] = net.final_tanh ? __fmul_rn(d, s[i + 1 + q]) : s[i + 1 + q];
      }
    }
  }
  __syncthreads();
}

}  // namespace igr
