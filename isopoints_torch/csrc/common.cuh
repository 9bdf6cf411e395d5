// Helpers shared by the port's CUDA kernels: the error-string entry point
// every library exports for its ctypes wrapper, the dynamic shared-memory
// limit, the splat stages' pixel centers, a warp scan, and the radix
// selection the splat candidate selection runs on depth bits and the
// occupancy backward's window kernel on the radii's keys (radix_pick).
#pragma once

#include <cuda_runtime.h>

// Message for a CUDA error code returned by a launcher (for the wrapper).
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace common {

// Raise `kernel`'s dynamic shared-memory limit to `bytes` where its limit
// falls short (the default is 48 KB less the kernel's static shared
// memory). `limit` caches that limit for the caller, -1 before the first
// call, so the attribute is read once and set once per larger size.
template <class Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int& limit) {
  if (limit < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    limit = attr.maxDynamicSharedSizeBytes;
  }
  if (bytes <= limit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) limit = bytes;
  return err;
}

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

// One round of an 8-bit radix selection, run by the whole of warp 0: from
// the 256-bin histogram of the keys that match `prefix` so far, the bin at
// `shift` that holds the k-th of them (1-based). Writes the prefix extended
// by that bin to bcast[0] and the rank left inside the bin to bcast[1].
__device__ __forceinline__ void radix_pick(const int* hist, unsigned prefix, int shift, int k,
                                           int* bcast) {
  // lane l owns bins 8l .. 8l+7; the lane whose range holds the k-th key
  // finds its bin and the rank left inside it
  const int lane = threadIdx.x & 31;
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

// The k-th smallest (1-based, 1 <= k <= number of active keys) of the
// 32-bit keys key_of(e, &key) yields for e in [0, n) (key_of returns false
// for an inactive element), by four rounds of 8-bit radix selection over
// shared-memory histograms. On return k is the rank of that element among
// the active keys equal to it, so k - 1 of them, and every smaller key,
// come before it. `hist`: 256 ints, `bcast`: 2 ints of shared memory. Every
// thread of the block must call it.
template <class KeyOf>
__device__ unsigned block_radix_select(KeyOf key_of, int n, int& k, int* hist, int* bcast) {
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      unsigned key;
      if (key_of(e, key) && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) radix_pick(hist, prefix, shift, k, bcast);
    __syncthreads();
    prefix = (unsigned)bcast[0];
    k = bcast[1];
    mask |= 255u << shift;
    __syncthreads();
  }
  return prefix;
}

}  // namespace common
