// SDF-MLP forward on Hopper's tensor cores, one tile of 32 rows per row
// group (4 row groups, 128 rows, unless a caller asks for one) per call:
// the tile of the fused IGR and SIREN kernels (fused_igr.cu, fused_mlp.cu),
// the ray sampler (fused_sampler.cu) and the in-kernel march
// (fused_trace.cu), for both fields and both modes. The activation is a
// template parameter: `IgrAct` (softplus, beta = 100) or `SirenAct` (sin of
// omega z). Every kernel evaluates a point through `tile()`, and an
// `mma.sync` row's sum depends only on that row and the weights, not on
// which rows share the tile or how many rows a tile has, so they give a
// point of one field and mode the same value bit for bit.
//
// Replaces the layer stacks of `_igr_kernel` (isopoints_tpu/ops/pallas_mlp.py
// :417): L+2 linear layers, softplus with beta = 100 after every layer but
// the head, the input concatenated back and the row scaled by 1/sqrt(2)
// before the layers of the skip mask, an optional final tanh; and of
// `_siren_kernel` (:250): sin(omega z) after every layer but the head
// (omega_first after the first), no skip, no tanh. With C = 4 a point has
// four rows, its value row and its three forward-mode tangent rows
// J <- (J W^T) * act'(z) (sigmoid(beta z), or omega cos(omega z)); the
// tangent rows are extra rows of the product's M dimension.
//
// Layout. 4 warps per row group: warp w owns rows 32 (w / 4) .. +32 and the
// column quarter w % 4 of every hidden product, as two m16 x (H/4) warp
// tiles of `mma.sync` (64 accumulators per thread at H = 256, so that 16
// warps fit an SM's registers and hide the epilogue's latency). With C = 4
// a warp's 32 rows hold 8 points as [values,
// x tangents, y tangents, z tangents] (8 rows each), so a lane's
// accumulators of row g, g+8, g+16, g+24 are one point's value and tangent
// rows and the epilogue needs no exchange between lanes. The activations
// stay in shared memory as the next layer's A operand (bf16 or f32 rows,
// padded by 16 bytes so that `ldmatrix` is free of bank conflicts). Each
// hidden layer's W (out, in), K-major as the MMA's B operand wants it,
// streams through shared memory in 64-byte k-chunks by `cp.async`,
// double-buffered, the next chunk (also the next layer's first) in flight
// while the current one is multiplied. Both modes step K by 32 bytes (k16
// bf16, k8 tf32), so the `ldmatrix` addressing is the same.
//
// Precision.
//   bf16 (`Bf16Mode`): the JAX 'bf16' mode. Weights rounded to bf16 on the
//     host, activations and tangents rounded (to nearest even) where they
//     are stored as the next layer's operand, one m16n8k16 pass, f32
//     accumulation. A bf16 x bf16 product is exact in f32, so only the
//     summation order differs from the plain version.
//   f32 (`Tf32x3Mode`): 3xTF32. Every operand x is split into hi =
//     cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); the weights once on
//     the host (two packs), the activations and tangents when their
//     fragments are loaded. The product is lo*hi + hi*lo + hi*hi in three
//     m16n8k8 passes into one f32 accumulator (lo*lo, ~2^-22 relative, is
//     dropped). Tangents are carried in f32 as values are.
// Accumulation. The tensor cores do not round their f32 sums to nearest
// (they truncate), and with the whole K in one accumulator their error
// grew with the sum: on an H100 the bf16 mode then flipped a bf16 rounding
// of the next operand, and so moved the output by more than 1e-5, on 2-5%
// of the points against the plain version. So in the bf16 mode each
// 64-byte k-chunk (k32) is summed into a zeroed tile and added to the f32
// accumulator with an IEEE add on the CUDA cores: 1.1-1.6% of bf16 outputs
// then differ from the plain version by more than 1e-5 (a zeroed tile per
// k16 step did no better), about as many as two correct float32 sums in
// different orders differ by (the bf16 mode's tolerance is stated against
// exact sums, see chip_smoke.py). In the f32 mode the same chunk sums
// (all three passes of a k16 chunk in one zeroed tile) left the values
// 2.1x as far from exactly formed sums as cuBLAS's float32 sums (RMS, on
// the IGR sampler's fine points; chip_smoke.py phase 7): the truncation
// of the hi*hi sums, taken relative to the whole chunk's partial sum. So
// the f32 mode sums hi*hi of each k8 step into a zeroed tile of its own,
// added at once, and the two correction products, 2^-11 of the size, into
// another tile added once per chunk (`python -m
// isopoints_torch.kernel_variants` times each arrangement and reads its
// error).
// The first layer (K = 3) and the head (N = 1) run on the CUDA cores in
// f32, and so do biases and the whole epilogue: softplus (igr.cuh) as
// logaddexp(beta z, 0) / beta with the accurate expf/log1pf (never
// -use_fast_math), or SIREN's sine with the accurate sinf/sincosf (never
// __sinf: SIREN arguments reach |omega z| ~ 100, where the fast
// intrinsic's error is far above 5e-5), and the IGR skip without a
// concatenation (the layer before a
// skip has H - 3 outputs, packed as H with three zero rows of W and zero
// biases; its last three columns are overwritten by the point, or e_k on
// tangent rows, and the row scaled by 1/sqrt(2), which is the JAX kernel's
// concat([h, x]) * (1/sqrt 2) with the same f32 roundings).
//
// Bound on an H100: the tensor cores do 2*128*H*H FLOP per block and layer
// (3x that in f32 mode, at half the bf16 rate), while the epilogue computes
// one softplus (expf, log1pf, a division; on value rows also the sigmoid's
// expf and division) or one sine per activation on the CUDA cores. At H =
// 256 the IGR epilogue is the larger part; see fused_igr.cu.
//
// Row groups. A tile of RG row groups has 32 RG rows and 128 RG threads.
// Every block streams the whole weight stack, so the more rows share it the
// less each row pays (RG = 4 at large launches); a launch of a few thousand
// points fills the card's 132 SMs only with smaller tiles (RG = 1 in
// fused_mlp.cu).
//
// Widths. Every kernel has an instance for each multiple of 32 up to 256 and
// for 384 and 512 (`MLP_MMA_WIDTHS`, the wide ones in a library of their
// own); the wrapper zero-pads a field of any
// other width up to the next instance (ops/fused_mlp.kernel_width), which is
// exact because no padded column is ever read (see there). Above 256 the
// 128-row tile does not fit the SM: at 512 a thread of 16 warps would hold
// 128 accumulators (the whole register file at 512 threads), and in f32 the
// activations alone take 128 x (512 x 4 + 16) = 264,192 bytes. So the wide
// instances run another tile, mlp_wide.cuh's (`wgmma` fed by TMA, a pair of
// blocks a 64-row tile, the weights multicast to a cluster), with this
// tile's arithmetic a row; `max_row_groups` is the narrow tile's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "igr.cuh"

namespace mlp_mma {

struct Bf16Mode {
  static constexpr int kEsz = 2;
  static constexpr bool kSplit = false;
};

struct Tf32x3Mode {
  static constexpr int kEsz = 4;
  static constexpr bool kSplit = true;
};

constexpr int kChunkBytes = 64;  // bytes of K per weight row and stage
constexpr int kPitchW = kChunkBytes + 16;
constexpr int kMaxHidden = 512;  // the widest instance

// The instances' widths, as NJ = H / 32: X(NJ) for each. A kernel source
// builds those up to 256; the same source included by its `_wide.cu` twin
// (MLP_MMA_WIDE_LIB defined) builds those above, a library of its own that
// nvcc compiles beside the first, so the wide instances do not lengthen
// the slowest build. The wrappers load the library of the pack's width.
#define MLP_MMA_NARROW(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)
#define MLP_MMA_WIDE(X) X(12) X(16)
#ifdef MLP_MMA_WIDE_LIB
#define MLP_MMA_WIDTHS MLP_MMA_WIDE
#else
#define MLP_MMA_WIDTHS MLP_MMA_NARROW
#endif

// whether the f32 mode reads the tf32 lo part through a pointer of its own
// (wh_lo); the wide tile reads hi and lo from one pack (mlp_wide.cuh)
#ifdef MLP_MMA_WIDE_LIB
constexpr bool kLoApart = false;
#else
constexpr bool kLoApart = true;
#endif

// hidden is one of this library's instances
__host__ __device__ constexpr bool in_library(int hidden) {
#ifdef MLP_MMA_WIDE_LIB
  return hidden == 384 || hidden == kMaxHidden;
#else
  return hidden > 0 && hidden % 32 == 0 && hidden <= 256;
#endif
}

// The row groups a block of width `hidden` holds at most in `Mode`: 4 up to
// 256; above, 1 in f32 and 2 in bf16 (see "Widths" above).
template <class Mode>
__host__ __device__ constexpr int max_row_groups(int hidden) {
  return hidden <= 256 ? 4 : (Mode::kSplit ? 1 : 2);
}

struct Net {
  const float* w0;    // (H, 3) first layer, (out, in); rows past its width zero
  const float* b0;    // (H,)
  const void* wh;     // (L, H, H) hidden layers (out, in), zero-padded: bf16
                      // values (bf16 mode) or the tf32 hi part (f32 mode)
  const void* wh_lo;  // (L, H, H) the tf32 lo part (f32 mode; unused in bf16)
  const float* bh;    // (L, H)
  const float* wout;  // (H,) head of out_dim 1
  const float* bout;  // (1,)
  int n_hidden;       // L
  unsigned skip;      // bit l set: layer l (1 <= l <= L + 1) takes [h, x] / sqrt(2)
  int final_tanh;
  float omega_first;   // SIREN: the first layer's omega (SirenAct only)
  float omega_hidden;  // SIREN: the other layers' omega (SirenAct only)
};

// The activation after every layer but the head: a = act(z) and, where the
// tangent rows need it (kGrad), d = act'(z).
struct IgrAct {  // softplus(beta z) / beta, beta = 100; omega unused
  template <bool kGrad>
  __device__ static __forceinline__ void apply(float z, float, float& a, float& d) {
    igr::softplus(z, a, d);
  }
};

struct SirenAct {  // sin(omega z), omega cos(omega z)
  template <bool kGrad>
  __device__ static __forceinline__ void apply(float z, float omega, float& a, float& d) {
    const float w = __fmul_rn(omega, z);
    if constexpr (kGrad) {
      float c;
      sincosf(w, &a, &c);
      d = __fmul_rn(omega, c);
    } else {
      a = sinf(w);
      d = 0.f;
    }
  }
};

// bytes of one activation row in shared memory (16 bytes of padding)
template <class Mode>
__host__ __device__ constexpr int pitch_a(int hidden) {
  return hidden * Mode::kEsz + 16;
}

// bytes of one weight stage (hi, and lo in f32 mode)
template <class Mode>
__host__ __device__ constexpr int stage_bytes(int hidden) {
  return (Mode::kSplit ? 2 : 1) * hidden * kPitchW;
}

// dynamic shared memory of one block of RG row groups: activations, two
// weight stages, points
template <class Mode, int C, int RG = 4>
__host__ __device__ constexpr int smem_bytes(int hidden) {
  return 32 * RG * pitch_a<Mode>(hidden) + 2 * stage_bytes<Mode>(hidden) + (32 * RG / C) * 3 * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round to the nearest tf32, ties away from zero (the low 13 bits cleared)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// row of component `comp` (0 value, 1..3 tangents) of block-local point p
template <int C>
__device__ __forceinline__ int row_of(int p, int comp) {
  return C == 1 ? p : (p >> 3) * 32 + comp * 8 + (p & 7);
}

template <class Mode>
__device__ __forceinline__ void put(unsigned char* row, int c, float v) {
  if constexpr (Mode::kSplit)
    reinterpret_cast<float*>(row)[c] = v;
  else
    reinterpret_cast<__nv_bfloat16*>(row)[c] = __float2bfloat16_rn(v);
}

template <class Mode>
__device__ __forceinline__ float get(const unsigned char* row, int c) {
  if constexpr (Mode::kSplit)
    return reinterpret_cast<const float*>(row)[c];
  else
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[c]);
}

// Stores column c of point p's activation (value a, tangents d * t[q]) as
// the next layer's operand, doing that layer's skip when `skip` is set.
template <class Mode, int H, int C>
__device__ __forceinline__ void store_col(unsigned char* act, int p, int c, float a, float d,
                                          const float (&t)[3], const float* x, bool skip) {
  constexpr int kPitch = pitch_a<Mode>(H);
  const int k = c - (H - 3);
  const bool xcol = skip && k >= 0;
  float v = xcol ? x[k] : a;
  if (skip) v = __fmul_rn(v, igr::kInvSqrt2);
  put<Mode>(act + row_of<C>(p, 0) * kPitch, c, v);
  if constexpr (C == 4) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float tv = xcol ? (k == q ? 1.f : 0.f) : __fmul_rn(d, t[q]);
      if (skip) tv = __fmul_rn(tv, igr::kInvSqrt2);
      put<Mode>(act + row_of<C>(p, q + 1) * kPitch, c, tv);
    }
  }
}

// First layer (3 inputs) on the CUDA cores, straight from the points xs
// (32 RG / C, 3), into the activation tile.
template <class Mode, class Act, int H, int C, int RG>
__device__ void layer0(const Net& net, const float* xs, unsigned char* act) {
  constexpr int P = 32 * RG / C;
  constexpr bool kBf16 = !Mode::kSplit;
  const bool skip = (net.skip >> 1) & 1u;
  for (int e = threadIdx.x; e < P * H; e += 128 * RG) {
    const int p = e / H, c = e - p * H;
    const float* x = xs + p * 3;
    const float x0 = igr::operand(x[0], kBf16), x1 = igr::operand(x[1], kBf16),
                x2 = igr::operand(x[2], kBf16);
    const float* w = net.w0 + c * 3;
    const float w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
    const float z = __fadd_rn(fmaf(x2, w2, fmaf(x1, w1, __fmul_rn(x0, w0))), __ldg(net.b0 + c));
    float a, d;
    Act::template apply<C == 4>(z, net.omega_first, a, d);
    const float t[3] = {w0, w1, w2};
    store_col<Mode, H, C>(act, p, c, a, d, t, x, skip);
  }
}

// One 64-byte k-chunk of a hidden product: acc[mt][nt] (the warp's two m16
// tiles x NT n8 tiles) += act[:, chunk] @ W[:, chunk]^T. The tensor cores
// sum the chunk into a zeroed tile, which is then added to acc with an
// IEEE add (see "Accumulation" above).
template <class Mode, int H, int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][NT][4], const unsigned char* act,
                                          const unsigned char* wb, int chunk) {
  constexpr int kPitch = pitch_a<Mode>(H);
  constexpr int KS = kChunkBytes / 32;  // k-steps per chunk
  static_assert(KS == 2, "one ldmatrix.x4 of B covers the chunk's two k-steps");
  constexpr int kParts = Mode::kSplit ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  // ldmatrix x4: lanes 8i..8i+7 address the rows of matrix i, and k lo / hi
  // below are the two 16-byte halves of a 32-byte k-step. A: matrices
  // (rows 0-7, k lo), (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi)
  // of one k-step; B: (n 0-7, k lo), (n 0-7, k hi) of k-step 0, then of
  // k-step 1, so regs 0-1 are k-step 0's b0, b1 and regs 2-3 k-step 1's
  const uint32_t a_addr = smem_u32(act) +
                          (wr * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                          chunk * kChunkBytes + (lane >> 4) * 16;
  const uint32_t b_addr =
      smem_u32(wb) + (wc * (H / 4) + (lane & 7)) * kPitchW + (lane >> 3) * 16;
  // A fragments of the chunk: [ks][mt]; in f32 mode split into hi (a) and lo
  uint32_t a[KS][2][4], lo[Mode::kSplit ? KS : 1][2][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(a_addr + ks * 32, a[ks][0]);
    ldsm_x4(a_addr + 16 * kPitch + ks * 32, a[ks][1]);
    if constexpr (Mode::kSplit) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __uint_as_float(a[ks][mt][i]);
          const uint32_t hi = tf32_rna(v);
          lo[ks][mt][i] = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
          a[ks][mt][i] = hi;
        }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t b[kParts][4];  // [hi, lo]: b0, b1 of k-step 0, then of k-step 1
#pragma unroll
    for (int part = 0; part < kParts; ++part)
      ldsm_x4(b_addr + (part * H + nt * 8) * kPitchW, b[part]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float(&d)[4] = acc[mt][nt];
      if constexpr (Mode::kSplit) {
        // the correction products (lo*hi, hi*lo) in a tile of their own,
        // added once per chunk; hi*hi of each k-step into a zeroed tile,
        // added at once (see "Accumulation")
        float c[4] = {0.f, 0.f, 0.f, 0.f};
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
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], c[i]);
      } else {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_bf16(t, a[ks][mt], b[0][2 * ks], b[0][2 * ks + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
      }
    }
  }
}

// Bias, softplus and the operand store of hidden layer l from the warp's
// accumulators (c0, c1: row g, columns 2t, 2t+1 of an n8 tile; c2, c3: row
// g + 8).
template <class Mode, class Act, int H, int C, int NT>
__device__ __forceinline__ void epilogue(const float (&acc)[2][NT][4], const Net& net, int l,
                                         const float* xs, unsigned char* act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool skip = (net.skip >> (l + 2)) & 1u;
  const float* b = net.bh + (size_t)l * H;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wc * (H / 4) + nt * 8 + 2 * t + e;
      const float bc = __ldg(b + c);
      if constexpr (C == 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows g, g + 8 of m-tile 0, then of m-tile 1
          const int p = wr * 32 + r * 8 + g;
          float a, d;
          Act::template apply<false>(__fadd_rn(acc[r >> 1][nt][(r & 1) * 2 + e], bc),
                                     net.omega_hidden, a, d);
          const float none[3] = {0.f, 0.f, 0.f};
          store_col<Mode, H, 1>(act, p, c, a, d, none, xs + p * 3, skip);
        }
      } else {
        const int p = wr * 8 + g;
        float a, d;
        Act::template apply<true>(__fadd_rn(acc[0][nt][e], bc), net.omega_hidden, a, d);
        const float tq[3] = {acc[0][nt][2 + e], acc[1][nt][e], acc[1][nt][2 + e]};
        store_col<Mode, H, 4>(act, p, c, a, d, tq, xs + p * 3, skip);
      }
    }
  }
}

// Head (out_dim 1): one warp-shuffle dot product per row, then tanh; the
// block's points p0 .. p0 + 32 RG / C written to val (and grad).
template <class Mode, int H, int C>
__device__ void head(const Net& net, const unsigned char* act, int p0, int n, float* val,
                     float* grad) {
  constexpr int NJ = H / 32;
  constexpr int kPitch = pitch_a<Mode>(H);
  constexpr int kPerWarp = 32 / C / 4;  // a row group's points over its 4 warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wo[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wo[j] = __ldg(net.wout + lane + 32 * j);
  const float bo = __ldg(net.bout);
  for (int i = 0; i < kPerWarp; ++i) {
    const int p = warp * kPerWarp + i;
    float s[C];
#pragma unroll
    for (int comp = 0; comp < C; ++comp) {
      const unsigned char* row = act + row_of<C>(p, comp) * kPitch;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) v = fmaf(get<Mode>(row, lane + 32 * j), wo[j], v);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      s[comp] = v;
    }
    if (lane == 0 && p0 + p < n) {
      float h = __fadd_rn(s[0], bo);
      float d = 1.f;
      if (net.final_tanh) {
        const float th = tanhf(h);
        d = __fsub_rn(1.f, __fmul_rn(th, th));
        h = th;
      }
      val[p0 + p] = h;
      if constexpr (C == 4) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          grad[(size_t)(p0 + p) * 3 + q] = net.final_tanh ? __fmul_rn(d, s[1 + q]) : s[1 + q];
      }
    }
  }
}

// The whole MLP on one tile of RG row groups (blockDim.x = 128 RG): the
// block-local points xs (32 RG / C, 3, shared memory) -> val[p0 + p] (and
// grad[p0 + p], C == 4) for every p with p0 + p < n; val and grad may be
// shared or device memory. act holds the
// 32 RG activation rows (pitch_a<Mode>(H) bytes each) and wbuf the two
// weight stages (stage_bytes<Mode>(H) each). The hidden layers' weights
// stream through wbuf in 64-byte k-chunks by `cp.async`, the next chunk (also
// the next layer's first) in flight while the current one is multiplied.
// Every thread of the block calls it. It starts with a barrier, so the
// caller's writes of xs need none, and ends with one, so the caller may read
// val and overwrite xs right after it.
template <class Mode, int H, int C, class Act = IgrAct, int RG = 4>
__device__ void tile(const Net& net, const float* xs, unsigned char* act, unsigned char* wbuf,
                     int p0, int n, float* val, float* grad) {
  constexpr int NT = H / 32;  // n8 tiles of a warp's column quarter
  constexpr int kChunks = H * Mode::kEsz / kChunkBytes;  // per layer
  constexpr int kParts = Mode::kSplit ? 2 : 1;
  constexpr int kStage = stage_bytes<Mode>(H);

  // chunk s of the flat (layer, k-chunk) sequence into stage s & 1
  const int total = net.n_hidden * kChunks;
  const unsigned char* wsrc[2] = {static_cast<const unsigned char*>(net.wh),
                                  static_cast<const unsigned char*>(net.wh_lo)};
  auto issue = [&](int s) {
    const int l = s / kChunks, c = s - l * kChunks;
    unsigned char* dst = wbuf + (s & 1) * kStage;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const unsigned char* src = wsrc[part] + (size_t)l * H * H * Mode::kEsz + c * kChunkBytes;
      for (int e = threadIdx.x; e < H * 4; e += 128 * RG) {
        const int r = e >> 2, q = e & 3;
        cp_async16(dst + part * H * kPitchW + r * kPitchW + q * 16,
                   src + (size_t)r * H * Mode::kEsz + q * 16);
      }
    }
    cp_async_commit();
  };
  if (total > 0) issue(0);  // in flight during the first layer
  __syncthreads();          // the points visible, the last tile's reads of act done
  layer0<Mode, Act, H, C, RG>(net, xs, act);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk s and the layer's operand visible to every warp
    const int l = s / kChunks, c = s - l * kChunks;
    mma_chunk<Mode, H, NT>(acc, act, wbuf + (s & 1) * kStage, c);
    if (c == kChunks - 1) {
      __syncthreads();  // every warp done reading the operand
      epilogue<Mode, Act, H, C, NT>(acc, net, l, xs, act);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    __syncthreads();  // stage s & 1 free for chunk s + 2; the epilogue's stores visible
  }
  if (total == 0) __syncthreads();
  head<Mode, H, C>(net, act, p0, n, val, grad);
  __syncthreads();  // val written; xs and act free for the next tile
}

}  // namespace mlp_mma
