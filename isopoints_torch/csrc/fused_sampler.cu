// Fused dense ray sampler: sweep + first-sign-change pick + min-SDF argmin
// + fixed-step secant, all against the SIREN MLP, in one kernel.
//
// Replaces `_sweep_kernel` (isopoints_tpu/ops/pallas_sampler.py:52, reached
// by `make_sampler` :129, pallas_call :187) on its fine-sweep path: per ray,
// n_steps proposals t_s = t_lo + steps[s] (t_hi - t_lo); the pick is the
// argmin of sign(f + margin) * (n_steps - s) with a strict < (the first
// minimum, as argmin), the bracket low end is idx_lo = max(idx - 1, 0), the
// argmin of f gives t_min, and n_secant secant steps with
// eps_denom(., 1e-12) refine the bracket. Outputs (t_pick, f_pick, t_min,
// z_secant). The coarse-sweep / bracket re-validation branch is not ported.
//
// Design. The TPU kernel sweeps the steps one after another in a loop carry
// over a 512-ray tile. Here the proposals of a ray are independent MLP evals,
// so a block takes 16 rays and evaluates their 16 x n_steps proposals as
// 64-row MLP tiles (siren.cuh), writes f and t to shared memory, and only the
// pick is sequential: one thread per ray scans its row in step order, which
// keeps the strict first-minimum tie-break exactly. The secant steps then
// evaluate one 16-row tile each. 16 rays per block (not 64) so that ~1-2k
// rays a training step still spread over the 132 SMs.
//
// Bound on an H100: operations. (n_steps + n_secant) SIREN evals per ray,
// ~0.40 MFLOP each at 3x256, against the f32 CUDA-core peak; the bytes moved
// are 32 per ray in and 16 out.
//
// t = t_lo + step * span and the points cam + t * dir are single-rounding
// fused multiply-adds (__fmaf_rn), as XLA forms them in the JAX package and
// as the plain PyTorch version forms them (utils.fma), so the proposals
// agree bit for bit and only the MLP arithmetic differs.

#include "siren.cuh"

namespace {

using siren::kChunk;
using siren::kRows;
using siren::kThreads;
using siren::Net;

constexpr int kRaysPerBlock = 16;

__device__ __forceinline__ float eps_denom(float x, float eps) {
  const float a = fabsf(x);
  return (x < 0.f ? -1.f : 1.f) * (a < eps ? eps : a);
}

// -fl (zh - zl) / eps_denom(fh - fl, 1e-12) + zl, rounded step by step
__device__ __forceinline__ float z_pred(float fl, float fh, float zl, float zh) {
  const float num = __fmul_rn(-fl, __fsub_rn(zh, zl));
  return __fadd_rn(__fdiv_rn(num, eps_denom(__fsub_rn(fh, fl), 1e-12f)), zl);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(Net net, const float* __restrict__ cam, const float* __restrict__ dir,
                 const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                 const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                 float margin, float* __restrict__ t_pick_out,
                 float* __restrict__ f_pick_out, float* __restrict__ t_min_out,
                 float* __restrict__ z_sec_out) {
  constexpr int H = NJ * 32;
  extern __shared__ float smem[];
  float* act = smem;
  float* wbuf = act + kRows * H;
  float* xs = wbuf + kChunk * H;          // (kRows, 3)
  float* vs = xs + kRows * 3;             // (kRows,)
  float* ray = vs + kRows;                // (16, 8): cam, dir, t_lo, span
  float* sec = ray + kRaysPerBlock * 8;   // (16, 5): fl, fh, zl, zh, z
  float* tb = sec + kRaysPerBlock * 5;    // (16, n_steps) proposal depths
  float* fb = tb + kRaysPerBlock * n_steps;  // (16, n_steps) proposal values

  const int r0 = blockIdx.x * kRaysPerBlock;
  const int nr = min(kRaysPerBlock, n_rays - r0);
  if (threadIdx.x < kRaysPerBlock) {
    const int r = threadIdx.x;
    const bool ok = r < nr;
    const size_t g = (size_t)(r0 + r);
    float* R = ray + r * 8;
    for (int d = 0; d < 3; ++d) {
      R[d] = ok ? cam[g * 3 + d] : 0.f;
      R[3 + d] = ok ? dir[g * 3 + d] : 0.f;
    }
    const float lo = ok ? t_lo[g] : 0.f;
    const float hi = ok ? t_hi[g] : 0.f;
    R[6] = lo;
    R[7] = __fsub_rn(hi, lo);
  }
  __syncthreads();

  // ---- sweep: 16 x n_steps proposals, 64 per MLP tile
  const int total = kRaysPerBlock * n_steps;
  for (int base = 0; base < total; base += kRows) {
    if (threadIdx.x < kRows) {
      const int q = base + threadIdx.x;
      float p[3] = {0.f, 0.f, 0.f};
      if (q < total) {
        const float* R = ray + (q / n_steps) * 8;
        const float t = __fmaf_rn(__ldg(steps + q % n_steps), R[7], R[6]);
        tb[q] = t;
        for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(t, R[3 + d], R[d]);
      }
      for (int d = 0; d < 3; ++d) xs[threadIdx.x * 3 + d] = p[d];
    }
    __syncthreads();
    siren::tile<NJ, 1>(net, xs, act, wbuf, vs, nullptr);
    if (threadIdx.x < kRows && base + threadIdx.x < total) fb[base + threadIdx.x] = vs[threadIdx.x];
    __syncthreads();
  }

  // ---- pick: one thread per ray scans its steps in order
  if (threadIdx.x < kRaysPerBlock) {
    const int r = threadIdx.x;
    const float* tr = tb + r * n_steps;
    const float* fr = fb + r * n_steps;
    float best = INFINITY, t_pick = 0.f, f_pick = 0.f, z_low = 0.f, f_low = 0.f;
    float prev_t = 0.f, prev_f = 0.f, f_min = INFINITY, t_min = 0.f;
    for (int s = 0; s < n_steps; ++s) {
      const float ts = tr[s], fs = fr[s];
      const float v = fs + margin;
      const float sgn = isnan(v) ? NAN : (float)((v > 0.f) - (v < 0.f));
      const float cost = sgn * (float)(n_steps - s);
      const float pt = s == 0 ? ts : prev_t;
      const float pf = s == 0 ? fs : prev_f;
      if (cost < best) {
        best = cost;
        t_pick = ts;
        f_pick = fs;
        z_low = pt;
        f_low = pf;
      }
      if (fs < f_min) {
        f_min = fs;
        t_min = ts;
      }
      prev_t = ts;
      prev_f = fs;
    }
    float* S = sec + r * 5;
    S[0] = f_low;
    S[1] = f_pick;
    S[2] = z_low;
    S[3] = t_pick;
    if (r < nr) {
      t_pick_out[r0 + r] = t_pick;
      f_pick_out[r0 + r] = f_pick;
      t_min_out[r0 + r] = t_min;
    }
  }
  __syncthreads();

  // ---- secant: one 16-point MLP tile per step
  for (int it = 0; it < n_secant; ++it) {
    if (threadIdx.x < kRows) {
      float p[3] = {0.f, 0.f, 0.f};
      if (threadIdx.x < kRaysPerBlock) {
        float* S = sec + threadIdx.x * 5;
        const float* R = ray + threadIdx.x * 8;
        const float z = z_pred(S[0], S[1], S[2], S[3]);
        S[4] = z;
        for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R[3 + d], R[d]);
      }
      for (int d = 0; d < 3; ++d) xs[threadIdx.x * 3 + d] = p[d];
    }
    __syncthreads();
    siren::tile<NJ, 1>(net, xs, act, wbuf, vs, nullptr);
    if (threadIdx.x < kRaysPerBlock) {
      float* S = sec + threadIdx.x * 5;
      const float f_mid = vs[threadIdx.x];
      if (f_mid > 0.f) {
        S[0] = f_mid;
        S[2] = S[4];
      }
      if (f_mid < 0.f) {
        S[1] = f_mid;
        S[3] = S[4];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < nr) {
    const float* S = sec + threadIdx.x * 5;
    z_sec_out[r0 + threadIdx.x] = z_pred(S[0], S[1], S[2], S[3]);
  }
}

size_t smem_bytes(int hidden, int n_steps) {
  return sizeof(float) * ((size_t)siren::tile_smem_floats(hidden) + kRows * 3 + kRows +
                          kRaysPerBlock * (8 + 5) + (size_t)2 * kRaysPerBlock * n_steps);
}

template <int NJ>
int launch(const Net& net, const float* cam, const float* dir, const float* t_lo,
           const float* t_hi, const float* steps, int n_rays, int n_steps, int n_secant,
           float margin, float* t_pick, float* f_pick, float* t_min, float* z_sec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(NJ * 32, n_steps);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  sweep_kernel<NJ><<<blocks, kThreads, smem, stream>>>(net, cam, dir, t_lo, t_hi, steps,
                                                       n_rays, n_steps, n_secant, margin,
                                                       t_pick, f_pick, t_min, z_sec);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest n_steps whose proposal buffers fit next to the MLP tile.
extern "C" int sampler_max_steps(int hidden) {
  const size_t limit = 232448;  // Hopper: 227 KB of dynamic shared memory per block
  const size_t fixed = smem_bytes(hidden, 0);
  return fixed >= limit ? 0 : (int)((limit - fixed) / (sizeof(float) * 2 * kRaysPerBlock));
}

// cam, dir (n_rays, 3); t_lo, t_hi (n_rays,); steps (n_steps,) fractions of
// [t_lo, t_hi] -> t_pick, f_pick, t_min, z_secant (n_rays,) each.
extern "C" int sampler_sweep(const float* cam, const float* dir, const float* t_lo,
                             const float* t_hi, const float* steps, int n_rays, int n_steps,
                             int n_secant, float margin, const float* w0, const float* b0,
                             const float* wh_t, const float* bh, const float* wout,
                             const float* bout, int hidden, int n_hidden, float omega_first,
                             float omega_hidden, float* t_pick, float* f_pick, float* t_min,
                             float* z_sec, void* stream) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_hidden < 0 || n_rays < 0 ||
      n_steps < 1 || n_steps > sampler_max_steps(hidden) || n_secant < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, omega_first, omega_hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden / 32) {
#define CASE(NJ)                                                                          \
  case NJ:                                                                                \
    return launch<NJ>(net, cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant, margin, \
                      t_pick, f_pick, t_min, z_sec, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
