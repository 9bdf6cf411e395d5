// Helpers shared by the port's CUDA kernels: the error-string entry point
// every library exports for its ctypes wrapper, the splat stages' pixel
// centers, and block-wide integer scans and radix selection used by the
// splat candidate selection.
#pragma once

#include <cuda_runtime.h>

// Message for a CUDA error code returned by a launcher (for the wrapper).
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace common {

// pixel-center NDC coordinate of row/column i: (S - 2i - 1) / S, formed as
// XLA forms a division by a constant (times the float32 reciprocal)
__device__ __forceinline__ float pixel_ndc(int i, int S, float inv_s) {
  return __fmul_rn((float)S - 2.f * (float)i - 1.f, inv_s);
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum of one int per thread, in thread order, over the
// whole block (blockDim.x a multiple of 32, at most 1024). Writes the block
// total to `total`. `warp_sums`: 32 ints of shared memory. Every thread of
// the block must call it; it synchronises the block.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_inclusive_scan(lane < nwarps ? warp_sums[lane] : 0);
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  total = warp_sums[nwarps - 1];
  __syncthreads();
  return base + incl - v;
}

// The k-th smallest (1-based, 1 <= k <= number of active keys) of the
// 32-bit keys key_of(e, &key) yields for e in [0, n) (key_of returns false
// for an inactive element), by four rounds of 8-bit radix selection over
// shared-memory histograms. `hist`: 256 ints, `bcast`: 2 ints of shared
// memory. Every thread of the block must call it.
template <class KeyOf>
__device__ unsigned block_radix_select(KeyOf key_of, int n, int k, int* hist, int* bcast) {
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      unsigned key;
      if (key_of(e, key) && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l owns bins 8l .. 8l+7; the lane whose range holds the k-th
      // key finds its bin and the rank left inside it
      const int lane = threadIdx.x;
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        s += c[j];
      }
      const int incl = warp_inclusive_scan(s);
      int cum = incl - s;
      if (cum < k && incl >= k) {
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= k) {
            bcast[0] = (int)(prefix | ((unsigned)(8 * lane + j) << shift));
            bcast[1] = k - cum;
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    prefix = (unsigned)bcast[0];
    k = bcast[1];
    mask |= 255u << shift;
    __syncthreads();
  }
  return prefix;
}

}  // namespace common
