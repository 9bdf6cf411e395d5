// Fused dense ray sampler: sweep + first-sign-change pick + min-SDF argmin
// [+ fine re-validation of the bracket] + fixed-step secant, all against the
// SDF MLP (SIREN or IGR), in one kernel.
//
// Replaces `_sweep_kernel` (isopoints_tpu/ops/pallas_sampler.py:52, reached
// by `make_sampler` :129, pallas_call :187): per ray, n_steps proposals
// t_s = t_lo + steps[s] (t_hi - t_lo); the pick is the argmin of
// sign(f + margin) * (n_steps - s) with a strict < (the first minimum, as
// argmin), the bracket low end is idx_lo = max(idx - 1, 0), the argmin of f
// gives t_min, and n_secant secant steps with eps_denom(., 1e-12) refine the
// bracket. With `revalidate` (the coarse sweep, :97-104) the sweep runs on
// the coarse (bf16) net and the bracket ends [z_low, t_pick] are evaluated
// again by the fine net in one batched pass before the secant, which runs
// fine; f_pick is then the fine value. Outputs (t_pick, f_pick, t_min,
// z_secant).
//
// Design. The TPU kernel sweeps the steps one after another in a loop carry
// over a 512-ray tile. Here the proposals of a ray are independent MLP evals,
// so a block takes 16 rays and evaluates their 16 x n_steps proposals as
// 64-row MLP tiles (siren.cuh / igr.cuh), writes f and t to shared memory,
// and only the pick is sequential: one thread per ray scans its row in step
// order, which keeps the strict first-minimum tie-break exactly. The
// re-validation is one 32-row tile, each secant step one 16-row tile; all of
// them go through one call of the tile, so it is compiled once per instance.
// 16 rays per block (not 64) so that ~1-2k rays a training step still spread
// over the 132 SMs. The kernel is a template over the field's evaluator
// (Siren, Igr), which supplies the net and the tile; both tiles use the same
// shared memory.
//
// Bound on an H100: operations. (n_steps + n_secant [+ 2]) MLP evals per
// ray, ~0.40 MFLOP each at 3x256 SIREN or 4x256 IGR, against the f32
// CUDA-core peak; the bytes moved are 32 per ray in and 16 out.
//
// t = t_lo + step * span and the points cam + t * dir are single-rounding
// fused multiply-adds (__fmaf_rn), as XLA forms them in the JAX package and
// as the plain PyTorch version forms them (utils.fma), so the proposals
// agree bit for bit and only the MLP arithmetic differs.

#include "igr.cuh"
#include "siren.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kChunk = 32;
constexpr int kRaysPerBlock = 16;
static_assert(kRows == siren::kRows && kRows == igr::kRows, "tile rows");
static_assert(kChunk == siren::kChunk && kChunk == igr::kChunk, "tile chunk");

template <int NJ>
struct Siren {
  using Net = siren::Net;
  __device__ static void eval(const Net& n, const float* xs, float* act, float* wbuf,
                              float* vs) {
    siren::tile<NJ, 1>(n, xs, act, wbuf, vs, nullptr);
  }
  static constexpr int smem_floats(int h) { return siren::tile_smem_floats(h); }
};

template <int NJ>
struct Igr {
  using Net = igr::Net;
  __device__ static void eval(const Net& n, const float* xs, float* act, float* wbuf,
                              float* vs) {
    igr::tile<NJ, 1>(n, xs, act, wbuf, vs, nullptr);
  }
  static constexpr int smem_floats(int h) { return igr::tile_smem_floats(h); }
};

__device__ __forceinline__ float eps_denom(float x, float eps) {
  const float a = fabsf(x);
  return (x < 0.f ? -1.f : 1.f) * (a < eps ? eps : a);
}

// -fl (zh - zl) / eps_denom(fh - fl, 1e-12) + zl, rounded step by step
__device__ __forceinline__ float z_pred(float fl, float fh, float zl, float zh) {
  const float num = __fmul_rn(-fl, __fsub_rn(zh, zl));
  return __fadd_rn(__fdiv_rn(num, eps_denom(__fsub_rn(fh, fl), 1e-12f)), zl);
}

// One ray's pick (thread r < 16): scans its steps in order; writes the
// bracket (f_low, f_pick, z_low, t_pick) to its secant state and t_pick,
// f_pick, t_min to the outputs.
__device__ __forceinline__ void pick(int r, int nr, int r0, const float* tb, const float* fb,
                                     int n_steps, float margin, float* S, float* t_pick_out,
                                     float* f_pick_out, float* t_min_out) {
  const float* tr = tb + r * n_steps;
  const float* fr = fb + r * n_steps;
  float best = INFINITY, t_pick = 0.f, f_pick = 0.f, z_low = 0.f, f_low = 0.f;
  float prev_t = 0.f, prev_f = 0.f, f_min = INFINITY, t_min = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    const float ts = tr[s], fs = fr[s];
    const float v = __fadd_rn(fs, margin);
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

// Every MLP tile of a block goes through one loop with one call of the
// field's tile (inlined once per instance): first the sweep tiles on the
// sweep net, then, on the fine net, the re-validation tile (rows r = z_low,
// 16 + r = t_pick) when `revalidate`, then one 16-row tile per secant step.
template <class Field, int H>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(typename Field::Net sweep_net, typename Field::Net fine_net, int revalidate,
                 const float* __restrict__ cam, const float* __restrict__ dir,
                 const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                 const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                 float margin, float* __restrict__ t_pick_out, float* __restrict__ f_pick_out,
                 float* __restrict__ t_min_out, float* __restrict__ z_sec_out) {
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
  const int tid = threadIdx.x;
  if (tid < kRaysPerBlock) {
    const bool ok = tid < nr;
    const size_t g = (size_t)(r0 + tid);
    float* R = ray + tid * 8;
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

  const int total = kRaysPerBlock * n_steps;
  const int n_sweep = (total + kRows - 1) / kRows;
  const int n_tiles = n_sweep + (revalidate ? 1 : 0) + n_secant;
  for (int it = 0; it < n_tiles; ++it) {
    const bool sweeping = it < n_sweep;
    const bool reval = revalidate && it == n_sweep;
    if (it == n_sweep) {  // the sweep is done: pick before the fine tiles
      if (tid < kRaysPerBlock)
        pick(tid, nr, r0, tb, fb, n_steps, margin, sec + tid * 5, t_pick_out, f_pick_out,
             t_min_out);
      __syncthreads();
    }
    // ---- the tile's points
    if (tid < kRows) {
      float p[3] = {0.f, 0.f, 0.f};
      if (sweeping) {
        const int q = it * kRows + tid;
        if (q < total) {
          const float* R = ray + (q / n_steps) * 8;
          const float t = __fmaf_rn(__ldg(steps + q % n_steps), R[7], R[6]);
          tb[q] = t;
          for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(t, R[3 + d], R[d]);
        }
      } else if (reval) {
        if (tid < 2 * kRaysPerBlock) {
          const int r = tid % kRaysPerBlock;
          const float z = sec[r * 5 + (tid < kRaysPerBlock ? 2 : 3)];
          const float* R = ray + r * 8;
          for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R[3 + d], R[d]);
        }
      } else if (tid < kRaysPerBlock) {
        float* S = sec + tid * 5;
        const float* R = ray + tid * 8;
        const float z = z_pred(S[0], S[1], S[2], S[3]);
        S[4] = z;
        for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R[3 + d], R[d]);
      }
      for (int d = 0; d < 3; ++d) xs[tid * 3 + d] = p[d];
    }
    __syncthreads();
    // the net by value: a reference to a kernel parameter chosen at run
    // time would make the tile read it through local memory
    const typename Field::Net net = sweeping ? sweep_net : fine_net;
    Field::eval(net, xs, act, wbuf, vs);
    // ---- its values
    if (sweeping) {
      const int q = it * kRows + tid;
      if (tid < kRows && q < total) fb[q] = vs[tid];
    } else if (reval) {
      if (tid < kRaysPerBlock) {
        sec[tid * 5 + 0] = vs[tid];
        sec[tid * 5 + 1] = vs[kRaysPerBlock + tid];
        if (tid < nr) f_pick_out[r0 + tid] = vs[kRaysPerBlock + tid];  // fine f_pick
      }
    } else if (tid < kRaysPerBlock) {
      float* S = sec + tid * 5;
      const float f_mid = vs[tid];
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
  if (n_tiles == n_sweep) {  // no fine tiles: pick after the sweep
    if (tid < kRaysPerBlock)
      pick(tid, nr, r0, tb, fb, n_steps, margin, sec + tid * 5, t_pick_out, f_pick_out,
             t_min_out);
    __syncthreads();
  }
  if (tid < nr) {
    const float* S = sec + tid * 5;
    z_sec_out[r0 + tid] = z_pred(S[0], S[1], S[2], S[3]);
  }
}

// The SIREN and the IGR tile take the same shared memory (activations +
// one weight chunk); the sampler adds its points, values, per-ray state and
// the two proposal buffers.
template <class Field>
size_t smem_bytes(int hidden, int n_steps) {
  return sizeof(float) * ((size_t)Field::smem_floats(hidden) + kRows * 3 + kRows +
                          kRaysPerBlock * (8 + 5) + (size_t)2 * kRaysPerBlock * n_steps);
}

constexpr size_t kSmemLimit = 232448;  // Hopper: 227 KB of dynamic shared memory per block

template <class Field>
int max_steps(int hidden) {
  const size_t fixed = smem_bytes<Field>(hidden, 0);
  return fixed >= kSmemLimit ? 0
                             : (int)((kSmemLimit - fixed) / (sizeof(float) * 2 * kRaysPerBlock));
}

template <class Field, int H>
int launch(const typename Field::Net& sweep_net, const typename Field::Net& fine_net,
           int revalidate, const float* cam, const float* dir, const float* t_lo,
           const float* t_hi, const float* steps, int n_rays, int n_steps, int n_secant,
           float margin, float* t_pick, float* f_pick, float* t_min, float* z_sec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<Field>(H, n_steps);
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel<Field, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  sweep_kernel<Field, H><<<blocks, kThreads, smem, stream>>>(
      sweep_net, fine_net, revalidate, cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant,
      margin, t_pick, f_pick, t_min, z_sec);
  return (int)cudaGetLastError();
}

#define SAMPLER_CASES(FIELD, ...)                                                   \
  switch (hidden / 32) {                                                            \
    case 1: return launch<FIELD<1>, 32>(__VA_ARGS__);                               \
    case 2: return launch<FIELD<2>, 64>(__VA_ARGS__);                               \
    case 3: return launch<FIELD<3>, 96>(__VA_ARGS__);                               \
    case 4: return launch<FIELD<4>, 128>(__VA_ARGS__);                              \
    case 5: return launch<FIELD<5>, 160>(__VA_ARGS__);                              \
    case 6: return launch<FIELD<6>, 192>(__VA_ARGS__);                              \
    case 7: return launch<FIELD<7>, 224>(__VA_ARGS__);                              \
    case 8: return launch<FIELD<8>, 256>(__VA_ARGS__);                              \
    default: return (int)cudaErrorInvalidValue;                                     \
  }

bool bad_args(int hidden, int n_rays, int n_steps, int n_secant, int limit) {
  return hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_rays < 0 || n_steps < 1 ||
         n_steps > limit || n_secant < 0;
}

}  // namespace

// Largest n_steps whose proposal buffers fit next to the MLP tile of the
// field `kind` (0 SIREN, 1 IGR).
extern "C" int sampler_max_steps(int kind, int hidden) {
  return kind == 0 ? max_steps<Siren<1>>(hidden) : max_steps<Igr<1>>(hidden);
}

// cam, dir (n_rays, 3); t_lo, t_hi (n_rays,); steps (n_steps,) fractions of
// [t_lo, t_hi] -> t_pick, f_pick, t_min, z_secant (n_rays,) each, on the
// SIREN net (fine sweep only).
extern "C" int sampler_sweep(const float* cam, const float* dir, const float* t_lo,
                             const float* t_hi, const float* steps, int n_rays, int n_steps,
                             int n_secant, float margin, const float* w0, const float* b0,
                             const float* wh_t, const float* bh, const float* wout,
                             const float* bout, int hidden, int n_hidden, float omega_first,
                             float omega_hidden, float* t_pick, float* f_pick, float* t_min,
                             float* z_sec, void* stream) {
  if (bad_args(hidden, n_rays, n_steps, n_secant, sampler_max_steps(0, hidden)) || n_hidden < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const siren::Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, omega_first, omega_hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SAMPLER_CASES(Siren, net, net, 0, cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant,
                margin, t_pick, f_pick, t_min, z_sec, s)
}

// The same on the IGR net. `sw` and `fw` are the six weight pointers (w0,
// b0, wh_t, bh, wout, bout) of the sweep and the fine net, `sweep_bf16` and
// `fine_bf16` their precisions; `revalidate` evaluates the bracket ends
// again on the fine net before the secant (the coarse sweep).
extern "C" int sampler_sweep_igr(const float* cam, const float* dir, const float* t_lo,
                                 const float* t_hi, const float* steps, int n_rays, int n_steps,
                                 int n_secant, float margin, int revalidate,
                                 const float* const* sw, const float* const* fw, int hidden,
                                 int n_hidden, unsigned skip, int final_tanh, int sweep_bf16,
                                 int fine_bf16, float* t_pick, float* f_pick, float* t_min,
                                 float* z_sec, void* stream) {
  if (bad_args(hidden, n_rays, n_steps, n_secant, sampler_max_steps(1, hidden)) ||
      n_hidden < 0 || (skip & 1u))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const igr::Net sweep{sw[0], sw[1], sw[2], sw[3], sw[4], sw[5],
                       n_hidden, skip, final_tanh, sweep_bf16};
  const igr::Net fine{fw[0], fw[1], fw[2], fw[3], fw[4], fw[5],
                      n_hidden, skip, final_tanh, fine_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SAMPLER_CASES(Igr, sweep, fine, revalidate, cam, dir, t_lo, t_hi, steps, n_rays, n_steps,
                n_secant, margin, t_pick, f_pick, t_min, z_sec, s)
}
