// The tensor-core MLP tile above width 256 (the 384 and 512 instances of the
// `_wide` libraries), redesigned for Hopper: `wgmma` fed by TMA bulk copies
// on mbarriers, a pair of blocks a 64-row tile. The fused IGR and SIREN
// kernels, the sampler and the march (fused_igr.cu, fused_mlp.cu,
// fused_sampler.cu, fused_trace.cu) evaluate every point of a wide field
// through `tile()` here; the instances up to 256 keep mlp_mma.cuh's
// `mma.sync` tile. The arithmetic of a row is that of mlp_mma.cuh (the same
// layer stack, activation, skip and head, the same two modes; see there),
// and a row's bits depend only on that row and the weights (not on the
// rows beside it, the tile it falls in or the cluster), so every wide
// kernel gives a point of one field and mode the same value bit for bit.
//
// What bounds it, measured on an H100 (PERF.md): the weight bytes each SM
// takes in from L2, whatever the depth of the ring; so the f32 mode, 8
// bytes a weight (hi and lo) for 64 rows, runs at about 3x its tensor-core
// bound, and the bf16 mode is bound by its epilogue (softplus or sine on
// the CUDA cores) as much as by its stream.
//
// Unit and cluster. A unit of two blocks (a cluster pair) evaluates one
// 64-row tile; block cb of the pair computes output columns [cb H/2,
// (cb + 1) H/2) of every hidden layer, and holds the whole 64 x H operand
// A. The epilogue writes its columns into its own A and, through the
// cluster's distributed shared memory, into its peer's; an mbarrier of the
// pair closes the reads of a layer (before the epilogue overwrites A) and
// its writes (before the next layer reads A). So 64 rows share each read
// of the weight stack. A cluster may hold
// kUnits units whose blocks of the same column half then share each
// weight stage: each block's producer loads 1/kUnits of it and multicasts
// it to them all (128 rows a read at kUnits = 2). Built with kUnits = 1:
// multicast halves the L2 reads but not what each SM takes in, and the
// coupled units took 6-18% longer at large launches and 26-41% at 8192
// points (`python -m isopoints_torch.kernel_variants wide`).
//
// Warps. 384 threads: two consumer warpgroups (warps 0-7) and a producer
// warpgroup (one warp of it runs the loop, one thread issues; setmaxnreg
// moves its registers to the consumers, 216 a thread). Consumer warpgroup wg owns columns cb H/2 +
// wg H/4 + [0, H/4) of all 64 rows as one m64nNk `wgmma` tile (N = H/4: 128
// at 512, 96 at 384), with A from registers (`ldmatrix` from the padded
// rows, as mlp_mma.cuh loads it; the f32 mode splits it into tf32 hi and lo
// there) and B, the weights, from shared memory. The producer keeps a ring
// of kStages weight stages full with bulk copies (`cp.async.bulk`, the TMA
// unit) on `full` mbarriers (expect_tx); consumers release a stage on the
// `empty` mbarrier of every block that received it once its wgmmas have
// completed. No block-wide barrier runs per k-chunk. 8 MMA warps an SM, 64
// accumulators and 64 of the zeroed tile a thread.
//
// Stages. A stage holds 64 bytes of K of the block's H/2 weight rows: one
// k8 step in f32 (hi and lo, 32 bytes each) or two k16 steps in bf16,
// H/2 x 64 bytes (16 KB at 512), laid out as wgmma's K-major operand
// without swizzle: [part][H/16 row groups][K 16-byte halves][8 rows][16 B]
// (a core matrix, 8 rows x 16 bytes, is 128 contiguous bytes; LBO = 128 is
// the K step between core matrices, SBO the row-group step). The host
// writes the weights in that order once (ops/fused_mlp.wide_layout): a
// block's stream is contiguous, [layer][column half][stage].
//
// Accumulation (mlp_mma.cuh "Accumulation": the tensor cores truncate
// their f32 sums). bf16: each stage's two k16 products (a k32 chunk, as
// mlp_mma.cuh sums them) go into a zeroed tile that is added to the f32
// accumulator with IEEE adds. f32: kF32Steps k8 steps (1 as built) go into
// one zeroed tile, each step's three passes small terms first (lo*hi,
// hi*lo, then hi*hi), added with IEEE adds; `python -m
// isopoints_torch.kernel_variants wide` builds 2 steps a tile (2.3x
// cuBLAS's RMS error against exact sums, over the 1.2 bar; 1 step: 0.72x)
// and the clusters of 4 and 8 blocks, and reads each one's time.
//
// Value + gradient (C = 4). A wgmma thread holds rows g and g + 8 of its
// warp's 16, so a point's value row and its three tangent rows cannot share
// a thread: warp w holds points 4w .. 4w + 3 (`row_of`), lane g < 4 a
// point's value row and second tangent, lane g + 4 its first and third.
// The two lanes of a point form its value row's activations, a column
// each, and swap them by shuffles; every warp does its points'.
#pragma once

#include <cooperative_groups.h>

#include "mlp_mma.cuh"

namespace mlp_wide {
// internal linkage: the function-local statics of the launchers stay apart
// in every library that includes this header (a process may load several)
namespace {

namespace cg = cooperative_groups;
using mlp_mma::Net;
using mlp_mma::pitch_a;
using mlp_mma::smem_u32;
using mlp_mma::Tf32x3Mode;

constexpr int kUnits = 1;  // 64-row units a cluster (weights multicast above 1)
constexpr int kCluster = 2 * kUnits;    // blocks a cluster
constexpr int kRows = 64;               // rows of a unit's tile
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
// registers a thread: 168 at launch (384 threads); the producer's
// warpgroup gives back all but kProducerRegs, the consumers take them
constexpr int kProducerRegs = 64, kConsumerRegs = 216;
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536, "the register file");
constexpr int kStages = 4;
constexpr int kF32Steps = 1;  // k8 steps a zeroed tile in f32
static_assert(kCluster <= 8, "a portable cluster");

// bytes of one weight stage: 64 bytes of K of a block's H/2 rows (a k8
// chunk's hi and lo in f32, a k32 chunk in bf16)
template <int H>
__host__ __device__ constexpr int stage_bytes() {
  return H / 2 * 64;
}

// weight stages a hidden layer: H/8 in f32, H/32 in bf16
template <class Mode, int H>
__host__ __device__ constexpr int stages_per_layer() {
  return H * Mode::kEsz * (Mode::kSplit ? 2 : 1) / 64;
}

// shared memory of the tile: A (at the f32 pitch, so that one block runs
// both modes), the ring, act'(z) of the value rows (C = 4), the barriers;
// a kernel puts its own arrays after it
template <int H>
__host__ __device__ constexpr int act_bytes() {
  return kRows * pitch_a<Tf32x3Mode>(H);
}
template <int H, int C>
__host__ __device__ constexpr int smem_bytes() {
  return act_bytes<H>() + kStages * stage_bytes<H>() + 8 * (2 * kStages + 1);
}

struct Ctx {
  unsigned char* act;   // A: kRows rows of pitch_a<Mode>(H) bytes
  unsigned char* ring;  // kStages weight stages
  uint64_t* full;       // kStages: a stage's bytes landed
  uint64_t* empty;      // kStages: every receiving block done with a stage
  uint64_t* pair;       // the unit's two blocks at a layer boundary
  uint32_t q;           // weight stages consumed (or issued) so far
  uint32_t pair_phase;
  int rank, cb, unit;   // rank in the cluster, column half, unit in the cluster
};

// ---- barriers, bulk copies and wgmma, as PTX

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed; a wait past ~10 s of
// the SM's clock traps, so that a fault fails the launch instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  if (mbar_try(b, parity)) return;
  const long long t0 = clock64();
  for (uint32_t i = 1; !mbar_try(b, parity); ++i)
    if ((i & 1023u) == 0 && clock64() - t0 > 20000000000LL) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// arrive on the barrier at `b`'s offset in block `rank` of the cluster,
// with the default (CTA-scope release) semantics: what it orders is either
// the async proxy's completed reads of a stage or, at the pair's barrier,
// writes a cluster-scope fence has ordered already (a cluster-scope release
// here costs a fence a stage)
__device__ __forceinline__ void mbar_arrive_at(uint64_t* b, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(b)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// `bytes` from global `src` to shared `dst` of this block, or of every block
// of `mask` at dst's offset, completing on `bar` there
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask) {
  if constexpr (kUnits == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  }
}

// a warpgroup's registers a thread (every thread of the warpgroup)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// the consumer warpgroups (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of a wgmma's registers above its wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// K-major shared-memory operand without swizzle: core matrices of 8 rows x
// 16 bytes, LBO 128 bytes between the two K halves of a 32-byte k-step,
// `sbo` between 8-row groups
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (m64 x N, f32) = [d +] A (registers, m64 x k) B (shared, N x k): one
// m64nNk8 tf32 or m64nNk16 bf16 wgmma; scale_d 0 starts from zero
template <bool kTf32, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<true, 96>(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<true, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<false, 96>(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<false, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ---- the tile

// every thread of the cluster (not warp-aligned: the producer warp's lanes
// arrive apart)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The context over `smem` (smem_bytes<H, C>() at its start); barriers
// initialized and the cluster synchronised, so peers may arrive on them and
// multicast into this block. Every thread of the block calls it.
template <int H, int C>
__device__ Ctx setup(unsigned char* smem) {
  Ctx c;
  c.act = smem;
  c.ring = smem + act_bytes<H>();
  c.full = reinterpret_cast<uint64_t*>(c.ring + kStages * stage_bytes<H>());
  c.empty = c.full + kStages;
  c.pair = c.empty + kStages;
  c.q = 0;
  c.pair_phase = 0;
  c.rank = (int)cg::this_cluster().block_rank();
  c.cb = c.rank & 1;
  c.unit = c.rank >> 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&c.full[s], 1);            // the producer's expect_tx
      mbar_init(&c.empty[s], 2 * kUnits);  // each receiving block's two warpgroups
    }
    mbar_init(c.pair, 2 * kConsumers / 32);  // every consumer warp of the pair
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  return c;
}

// The end of a kernel: no block leaves while a peer may still write to it or
// arrive on its barriers. The consumer threads call it at the end of their
// branch; the producer's warpgroup leaves once its copies are issued (a
// cluster barrier waits for the threads that have not exited), so that the
// two branches never rejoin: where they do, ptxas ignores setmaxnreg.
__device__ __forceinline__ void finish() { cluster_sync(); }

// The producer (the 32 threads of one warp, lane 0 issuing): the weight
// stages of one tile of net in Mode, each stage's 1/kUnits share multicast
// to the blocks of this column half. The whole warp runs the loop, so that
// no lane waits at a barrier apart from the issuing one.
template <class Mode, int H>
__device__ void produce(Ctx& c, const Net& net) {
  constexpr int KC = stages_per_layer<Mode, H>();
  constexpr int SB = stage_bytes<H>(), kPart = SB / kUnits;
  const unsigned char* src = static_cast<const unsigned char*>(net.wh) +
                             (size_t)c.cb * KC * SB + (size_t)c.unit * kPart;
  const uint16_t mask = (uint16_t)((0x5555u & ((1u << kCluster) - 1u)) << c.cb);
  for (int l = 0; l < net.n_hidden; ++l) {
    for (int kc = 0; kc < KC; ++kc, ++c.q) {
      const uint32_t s = c.q % kStages;
      mbar_wait(&c.empty[s], ((c.q / kStages) & 1u) ^ 1u);  // the first round passes
      if ((threadIdx.x & 31) == 0) {
        mbar_expect_tx(&c.full[s], SB);
        bulk_load(c.ring + s * SB + c.unit * kPart, src + ((size_t)l * 2 * KC + kc) * SB,
                  kPart, &c.full[s], mask);
      }
      __syncwarp();
    }
  }
}

// The thread's index, opaque to the compiler: the tile's addresses derive
// from it, and a kernel that runs the tile in a loop (the march) would
// otherwise have them hoisted out of the loop, live across every tile, and
// spilled.
__device__ __forceinline__ int tile_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// row of component `comp` (0 value, 1..3 tangents) of tile point p: with
// the gradient, warp w's 16 rows hold points 4w .. 4w + 3, components 0 and
// 1 in rows 0-7 and 2 and 3 in rows 8-15, so that a lane's rows g and g + 8
// are one point's and lanes g, g + 4 hold all four (`epilogue`)
template <int C>
__device__ __forceinline__ int row_of(int p, int comp) {
  return C == 1 ? p : (p >> 2) * 16 + (comp & 1) * 4 + (comp >> 1) * 8 + (p & 3);
}

// Column c of point p's first-layer activation (value a, tangents d * t[q])
// into A, doing the skip when set (mlp_mma::store_col in this row order).
template <class Mode, int H, int C>
__device__ __forceinline__ void store_col(unsigned char* act, int p, int c, float a, float d,
                                          const float (&t)[3], const float* x, bool skip) {
  constexpr int kPitch = pitch_a<Mode>(H);
  const int k = c - (H - 3);
  const bool xcol = skip && k >= 0;
  float v = xcol ? x[k] : a;
  if (skip) v = __fmul_rn(v, igr::kInvSqrt2);
  mlp_mma::put<Mode>(act + row_of<C>(p, 0) * kPitch, c, v);
  if constexpr (C == 4) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float tv = xcol ? (k == q ? 1.f : 0.f) : __fmul_rn(d, t[q]);
      if (skip) tv = __fmul_rn(tv, igr::kInvSqrt2);
      mlp_mma::put<Mode>(act + row_of<C>(p, q + 1) * kPitch, c, tv);
    }
  }
}

// First layer (3 inputs) on the CUDA cores: this block's H/2 columns of
// every row into both blocks' A.
template <class Mode, class Act, int H, int C>
__device__ void layer0(Ctx& cx, const Net& net, const float* xs) {
  constexpr int P = kRows / C, NB = H / 2;
  constexpr bool kBf16 = !Mode::kSplit;
  const bool skip = (net.skip >> 1) & 1u;
  unsigned char* peer = cg::this_cluster().map_shared_rank(cx.act, cx.rank ^ 1);
  for (int e = tile_tid(); e < P * NB; e += kConsumers) {
    const int p = e / NB, c = cx.cb * NB + e - p * NB;
    const float* x = xs + p * 3;
    const float x0 = igr::operand(x[0], kBf16), x1 = igr::operand(x[1], kBf16),
                x2 = igr::operand(x[2], kBf16);
    const float* w = net.w0 + c * 3;
    const float w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
    const float z = __fadd_rn(fmaf(x2, w2, fmaf(x1, w1, __fmul_rn(x0, w0))), __ldg(net.b0 + c));
    float a, d;
    Act::template apply<C == 4>(z, net.omega_first, a, d);
    const float t[3] = {w0, w1, w2};
    store_col<Mode, H, C>(cx.act, p, c, a, d, t, x, skip);
    store_col<Mode, H, C>(peer, p, c, a, d, t, x, skip);
  }
}

// One hidden layer's products for this consumer warpgroup: acc (its m64 x
// H/4 tile, wgmma's fragment) = A W^T over the layer's weight stages, each
// zeroed tile (kF32Steps k8 stages in f32, a k32 stage in bf16) added with
// IEEE adds (see "Accumulation"). Releases every stage it consumed.
template <class Mode, int H>
__device__ __forceinline__ void layer_mma(Ctx& c, float (&acc)[H / 8]) {
  constexpr int NW = H / 4, KC = stages_per_layer<Mode, H>();
  constexpr int G = Mode::kSplit ? kF32Steps : 1;  // stages a zeroed tile
  static_assert(KC % G == 0 && kStages >= G, "whole zeroed tiles a layer, held at once");
  constexpr int kPitch = pitch_a<Mode>(H);
  constexpr uint32_t SB = stage_bytes<H>();
  constexpr uint32_t kSbo = Mode::kSplit ? 256 : 512;  // 8 rows x (32 or 64 bytes of K)
  const int tid = tile_tid(), wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  // ldmatrix x4 as mlp_mma::mma_chunk: rows 0-7 / 8-15 of the warp's 16,
  // the two 16-byte halves of a 32-byte k-step
  const uint32_t a_addr = smem_u32(c.act) +
                          (16 * w + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                          (lane >> 4) * 16;
  const uint32_t ring = smem_u32(c.ring) + wg * (NW / 8) * kSbo;
#pragma unroll
  for (int i = 0; i < H / 8; ++i) acc[i] = 0.f;
  float t[H / 8];
  for (int kc = 0; kc < KC; kc += G) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t q = c.q + g, s = q % kStages;
      mbar_wait(&c.full[s], (q / kStages) & 1u);
      const uint32_t sb = ring + s * SB;
      if constexpr (Mode::kSplit) {
        uint32_t hi[4], lo[4];
        mlp_mma::ldsm_x4(a_addr + (kc + g) * 32, hi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = __uint_as_float(hi[j]);
          hi[j] = mlp_mma::tf32_rna(v);
          lo[j] = mlp_mma::tf32_rna(__fsub_rn(v, __uint_as_float(hi[j])));
        }
        wgmma_fence();
        wgmma_rs<true, NW>(t, lo, desc(sb, kSbo), g != 0);      // lo * hi
        wgmma_rs<true, NW>(t, hi, desc(sb + SB / 2, kSbo), 1);  // hi * lo
        wgmma_rs<true, NW>(t, hi, desc(sb, kSbo), 1);           // hi * hi
      } else {
        uint32_t a0[4], a1[4];
        mlp_mma::ldsm_x4(a_addr + kc * 64, a0);
        mlp_mma::ldsm_x4(a_addr + kc * 64 + 32, a1);
        wgmma_fence();
        wgmma_rs<false, NW>(t, a0, desc(sb, kSbo), 0);
        wgmma_rs<false, NW>(t, a1, desc(sb + 256, kSbo), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < H / 8; ++i) fence_operand(t[i]);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        for (int u = 0; u < kUnits; ++u)
          mbar_arrive_at(&c.empty[(c.q + g) % kStages], c.cb + 2 * u);
    }
    c.q += G;
#pragma unroll
    for (int i = 0; i < H / 8; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
  }
}

// The pair's barrier: every consumer warp of both blocks arrives on both
// blocks' barrier, then waits on its own. `writes`: this warp wrote to
// either block's A (made visible at cluster scope first).
__device__ __forceinline__ void pair_sync(Ctx& c, bool writes) {
  if (writes) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive_at(c.pair, c.rank);
    mbar_arrive_at(c.pair, c.rank ^ 1);
  }
  mbar_wait(c.pair, c.pair_phase);
  c.pair_phase ^= 1u;
}

// columns col, col + 1 of A's row `row` in this block and its peer
template <class Mode, int H>
__device__ __forceinline__ void put2(unsigned char* act, unsigned char* peer, int row, int col,
                                     float v0, float v1) {
  const int off = row * pitch_a<Mode>(H) + col * Mode::kEsz;
  if constexpr (Mode::kSplit) {
    const float2 v = make_float2(v0, v1);
    *reinterpret_cast<float2*>(act + off) = v;
    *reinterpret_cast<float2*>(peer + off) = v;
  } else {
    const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    *reinterpret_cast<__nv_bfloat162*>(act + off) = v;
    *reinterpret_cast<__nv_bfloat162*>(peer + off) = v;
  }
}

// Bias, activation and the operand store of hidden layer l from the
// warpgroup's accumulators (wgmma's fragment: n8 block j, regs 4j..4j+3 =
// row g, columns 2t, 2t+1, then row g + 8), into both blocks' A. With the
// gradient (row_of<4>) lane g < 4 holds a point's value row and its second
// tangent row, lane + 16 its first and third tangent rows; the two form the
// value row's activations, a column each, and swap a and act'(z).
template <class Mode, class Act, int H, int C>
__device__ __forceinline__ void epilogue(Ctx& c, const float (&acc)[H / 8], const Net& net, int l,
                                         const float* xs) {
  constexpr int NW = H / 4, NT = NW / 8;
  const int tid = tile_tid(), wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool skip = (net.skip >> (l + 2)) & 1u;
  const float* b = net.bh + (size_t)l * H;
  unsigned char* peer = cg::this_cluster().map_shared_rank(c.act, c.rank ^ 1);
  const int c0 = c.cb * (H / 2) + wg * NW + 2 * t;  // column of reg 0 of n8 block 0
  // the point of rows g and g + 8 and their components
  const int p = C == 1 ? 16 * w + g : 4 * w + (g & 3);
  const int comp = C == 1 ? 0 : g >> 2;  // and comp + 2 at row g + 8
  const float* x = xs + p * 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + 8 * j;
    const float b0 = __ldg(b + col), b1 = __ldg(b + col + 1);
    if constexpr (C == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a, d;
          Act::template apply<false>(__fadd_rn(acc[4 * j + 2 * h + e], e ? b1 : b0),
                                     net.omega_hidden, a, d);
          const int k = col + e - (H - 3);
          v[e] = (skip && k >= 0) ? x[8 * h * 3 + k] : a;
          if (skip) v[e] = __fmul_rn(v[e], igr::kInvSqrt2);
        }
        put2<Mode, H>(c.act, peer, row_of<C>(p + 8 * h, 0), col, v[0], v[1]);
      }
    } else {
      // the value lane's two columns' z: it forms column col's activation,
      // its partner (lane ^ 16) col + 1's, and they swap the results
      const float z0 = __fadd_rn(acc[4 * j], b0), z1 = __fadd_rn(acc[4 * j + 1], b1);
      const float z1p = __shfl_xor_sync(0xffffffffu, z1, 16);
      float a, d;
      Act::template apply<true>(comp == 0 ? z0 : z1p, net.omega_hidden, a, d);
      const float ap = __shfl_xor_sync(0xffffffffu, a, 16);
      const float dp = __shfl_xor_sync(0xffffffffu, d, 16);
      const float av[2] = {a, ap};  // the value row's, on the value lane
      const float dv[2] = {comp == 0 ? d : dp, comp == 0 ? dp : d};
      float v[2][2];  // [row g, row g + 8][column]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = col + e - (H - 3);
        const bool xcol = skip && k >= 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = comp + 2 * h;  // the row's component
          float u;
          if (q == 0)
            u = xcol ? x[k] : av[e];
          else
            u = xcol ? (k == q - 1 ? 1.f : 0.f) : __fmul_rn(dv[e], acc[4 * j + 2 * h + e]);
          v[h][e] = skip ? __fmul_rn(u, igr::kInvSqrt2) : u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put2<Mode, H>(c.act, peer, row_of<C>(p, comp + 2 * h), col, v[h][0], v[h][1]);
    }
  }
}

// Head (out_dim 1) as mlp_mma::head: a warp-shuffle dot product per row,
// then tanh. Block cb of the unit takes half of the tile's points; with
// kShared the values go to val[p] in both blocks' shared memory, else to
// val[p0 + p] (and grad) for p0 + p < n.
template <class Mode, int H, int C, bool kShared>
__device__ void head(Ctx& c, const Net& net, int p0, int n, float* val, float* grad) {
  constexpr int NJ = H / 32, kPitch = pitch_a<Mode>(H);
  constexpr int P = kRows / C, kPer = P / 2 / (kConsumers / 32);
  const int tid = tile_tid(), lane = tid & 31, warp = tid >> 5;
  float* peer_val = kShared ? cg::this_cluster().map_shared_rank(val, c.rank ^ 1) : nullptr;
  float wo[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wo[j] = __ldg(net.wout + lane + 32 * j);
  const float bo = __ldg(net.bout);
  for (int i = 0; i < kPer; ++i) {
    const int p = c.cb * (P / 2) + warp * kPer + i;
    float s[C];
#pragma unroll
    for (int comp = 0; comp < C; ++comp) {
      const unsigned char* row = c.act + row_of<C>(p, comp) * kPitch;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) v = fmaf(mlp_mma::get<Mode>(row, lane + 32 * j), wo[j], v);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      s[comp] = v;
    }
    if (lane == 0) {
      float h = __fadd_rn(s[0], bo);
      float d = 1.f;
      if (net.final_tanh) {
        const float th = tanhf(h);
        d = __fsub_rn(1.f, __fmul_rn(th, th));
        h = th;
      }
      if constexpr (kShared) {
        val[p] = h;
        peer_val[p] = h;
      } else if (p0 + p < n) {
        val[p0 + p] = h;
        if constexpr (C == 4) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
            grad[(size_t)(p0 + p) * 3 + q] = net.final_tanh ? __fmul_rn(d, s[1 + q]) : s[1 + q];
        }
      }
    }
  }
}

// The whole MLP on one unit's tile, run by the 256 consumer threads of both
// blocks of the unit while each block's producer runs produce<Mode, H> on
// the same net: the tile points xs (kRows / C, 3, this block's shared
// memory, the same in both blocks) -> val and grad (see `head`). Starts with
// a consumer barrier, so the caller's writes of xs need none. Writes the
// peer's A from its first layer on, so the peer must be done with its last
// tile: with kShared the tile ends with the pair's barrier (val complete in
// both blocks, xs free), and without it a kernel runs one tile.
template <class Mode, int H, int C, class Act, bool kShared>
__device__ void tile(Ctx& c, const Net& net, const float* xs, int p0, int n, float* val,
                     float* grad) {
  consumer_sync();  // the points visible
  layer0<Mode, Act, H, C>(c, net, xs);
  pair_sync(c, true);  // A complete in both blocks
  float acc[H / 8];
  for (int l = 0; l < net.n_hidden; ++l) {
    layer_mma<Mode, H>(c, acc);
    pair_sync(c, false);  // both blocks done reading A
    epilogue<Mode, Act, H, C>(c, acc, net, l, xs);
    pair_sync(c, true);   // the next layer's A complete in both blocks
  }
  head<Mode, H, C, kShared>(c, net, p0, n, val, grad);
  if constexpr (kShared) pair_sync(c, true);
}

// ---- the fused MLP kernels' wide instance (fused_igr.cu, fused_mlp.cu)

// x (n, 3) -> val (n,) [, grad (n, 3)]: unit u of the grid takes points
// [u kRows / C, (u + 1) kRows / C).
template <class Mode, int H, int C, class Act>
__global__ void __launch_bounds__(kThreads, 1)
    points_kernel(Net net, const float* __restrict__ x, int n, float* __restrict__ val,
                  float* __restrict__ grad) {
  constexpr int P = kRows / C;
  extern __shared__ __align__(128) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  Ctx c = setup<H, C>(smem);
  float* xs = reinterpret_cast<float*>(smem + smem_bytes<H, C>());
  const int p0 = (int)(blockIdx.x >> 1) * P;
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x < kConsumers + 32) produce<Mode, H>(c, net);
  } else {
    consumer_regs();
    for (int e = threadIdx.x; e < P * 3; e += kConsumers)
      xs[e] = (p0 + e / 3 < n) ? x[(size_t)p0 * 3 + e] : 0.f;
    tile<Mode, H, C, Act, false>(c, net, xs, p0, n, val, grad);
    finish();
  }
}

// Launch `kernel` as clusters of kCluster blocks of kThreads threads, two
// blocks a unit, `units` units rounded up to whole clusters (the extra units
// run on no point), with `smem` bytes of dynamic shared memory.
// `limit` caches the kernel's shared-memory limit (common::allow_dynamic_smem).
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int units, int smem, int& limit,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = common::allow_dynamic_smem(kernel, smem, limit);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * units + kCluster - 1) / kCluster * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class Mode, int H, int C, class Act>
int launch_points(const Net& net, const float* x, int n, float* val, float* grad,
                  cudaStream_t stream) {
  constexpr int P = kRows / C;
  constexpr int smem = smem_bytes<H, C>() + P * 3 * 4;
  static_assert(smem <= 232448, "the wide tile exceeds a block's shared memory");
  static int limit = -1;
  return (int)launch(points_kernel<Mode, H, C, Act>, (n + P - 1) / P, smem, limit, stream, net,
                     x, n, val, grad);
}

}  // namespace
}  // namespace mlp_wide
