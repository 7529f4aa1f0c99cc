// The port's GEMM on Hopper's tensor cores, shared by K1's tb_linear
// (transformer_block.cu, bf16 operands) and K4's wa_linear
// (window_attention.cu, f32 operands; K5 runs both):
//
//   out[M, N] = act(A[M, K] . W[N, K]^T + bias) + res,  f32 accumulation
//
// It replaces the four products that the Pallas kernel bodies compute
// themselves (ultrasound_modeling_tpu/ops/pallas_kernels.py: the qkv and
// output projections of _window_attn_kernel and _attn_train_kernel, the
// four matmuls of _tblock_kernel).  Two schedules: linear_wgmma_kernel
// below (a 128 x 128 tile a block; bf16, and f32 at the TransUNet's, the
// ViT's and K5's widths) and, for f32 at the Swin's widths,
// linear_narrow_kernel further down (128 x 96 tiles on persistent blocks);
// the caller picks one by shape (ops/kernels.linear_plan).
//
// Bound: at the serving shapes the products are compute-bound (ViT b64 qkv
// is 100 GFLOP against 0.13 GB moved) except where the epilogue moves much
// f32 (TransUNet's qkv writes 31.5 MB, about as long as its bf16 products).
// The design:
// - a block computes a 128 x 128 output tile.  A producer warpgroup keeps a
//   ring of k-blocks in flight by TMA (cp.async.bulk.tensor, 128-byte
//   swizzle, mbarriers "full" and "empty" per stage) and gives registers to
//   the consumers (setmaxnreg); the consumers run wgmma.mma_async
//   (m64n128, both operands K-major from shared memory) and run the
//   epilogue;
// - a k-block is 128 bytes of K: 64 bf16 or 32 f32.  TMA zero-fills what
//   lies past M, N or K, so ragged shapes need no guard in the mainloop;
// - bf16: one consumer warpgroup for both 64-row halves, 3 stages of 32 KB,
//   two blocks an SM, so that one block's epilogue runs under the other's
//   products;
// - f32 (3xTF32, the f32 contract): the tensor core reads only the TF32 bits
//   of an f32 operand (it ignores the low 13), so the raw tile already is
//   "hi".  The producer warpgroup writes lo = x - (x & 0xffffe000), rounded
//   to TF32, of both tiles beside them ("ready" barrier; the map is
//   elementwise, so the swizzled layout carries over) and the consumers
//   accumulate A_lo.W + A.W_lo + A.W.  The tensor core's own accumulation
//   truncates: with all of K in one accumulator the error reached 1.2e-5 of
//   max|out| at K = 2048 on an H100, a bias that adds up coherently
//   downstream.  So each k-step's products start from zero and are added
//   into f32 registers.  Those registers take two consumer warpgroups (a
//   64-row half each), which also keep the tensor core busy while one of
//   them adds; 3 stages of 64 KB, one block an SM;
// - epilogue: the accumulators go through shared memory (row stride 136
//   floats: conflict-free float2 writes), then each thread applies bias,
//   GELU and the residual in f32 to 8 consecutive columns and stores them as
//   16-byte vectors (scalar stores at a ragged edge); one round to bf16 at
//   the store, as epilogue_store (common.cuh) does;
// - grid: one block per tile, N-tiles fastest (the blocks in flight share
//   their A rows and all of W in L2).  A wave of 264 bf16 blocks (132 f32)
//   leaves partial last waves (ViT qkv: 2,400 tiles, 9.1 waves); a
//   persistent or stream-K schedule is left for later.
// The TMA descriptors hold the operands' pointers, so the host encodes them
// for every launch (cuTensorMapEncodeTiled, looked up once through the CUDA
// runtime) and passes them as __grid_constant__ parameters.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace um {

constexpr int GEMM_BM = 128, GEMM_BN = 128;  // the block tile (wgmma m64n128, two halves)
constexpr int GEMM_ROW_BYTES = 128;                    // a k-block: 128 bytes of K
constexpr int GEMM_A_BYTES = GEMM_BM * GEMM_ROW_BYTES;  // the A tile of a stage
constexpr int GEMM_STAGES = 3;                         // k-blocks in the ring

template <typename T> struct GemmCfg;
// bf16: one consumer warpgroup (both 64-row halves), two blocks an SM.
// f32: two consumer warpgroups (a half each), one block an SM: each adds its
// wgmma accumulator into f32 register sums after every k-step (see above),
// which takes a second set of 64 registers a thread.
template <> struct GemmCfg<bf16> {
  static constexpr int CONSUMERS = 1, MIN_BLOCKS = 2;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;
  static constexpr bool LO = false;   // no lo tiles
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct GemmCfg<float> {
  static constexpr int CONSUMERS = 2, MIN_BLOCKS = 1;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr bool LO = true;    // 3xTF32: the lo tiles beside the raw ones
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// a stage: the A and W tiles TMA loads, then for f32 their lo tiles
constexpr int GEMM_LOAD_BYTES = GEMM_A_BYTES + GEMM_BN * GEMM_ROW_BYTES;
template <typename T> __host__ __device__ constexpr int gemm_stage_bytes() {
  return (GemmCfg<T>::LO ? 2 : 1) * GEMM_LOAD_BYTES;
}
template <typename T> __host__ __device__ constexpr size_t gemm_smem_bytes() {
  return 1024 + (size_t)GEMM_STAGES * gemm_stage_bytes<T>() +
         3 * GEMM_STAGES * sizeof(uint64_t);
}

// ---- PTX wrappers ----

// 2-D TMA load of the box at (k, row) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// 2-D TMA store of the box at (col, row) from shared memory (the narrow
// schedule's epilogue), in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory operand descriptor of a K-major tile in the 128-byte swizzle
// (8-row atoms of 1024 bytes; the leading offset is unused for this layout)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching the accumulators across a wgmma boundary
template <int R> __device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define UM_R8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define UM_R64(d)                                                                      \
  UM_R8(d, 0), UM_R8(d, 8), UM_R8(d, 16), UM_R8(d, 24), UM_R8(d, 32), UM_R8(d, 40),    \
      UM_R8(d, 48), UM_R8(d, 56)
#define UM_D64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] = A[64 x k] . B[128 x k]^T + (scale_d ? d : 0), one k-step
// (16 bf16 or 8 tf32)
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db, int scale_d,
                                           bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UM_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : UM_R64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db, int scale_d,
                                           float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " UM_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : UM_R64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#define UM_D48                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"

// d[64 x 96] = A[64 x 8] . B[96 x 8]^T + (scale_d ? d : 0), tf32 (the
// narrow schedule's k-step)
__device__ __forceinline__ void wgmma_step(float (&d)[48], uint64_t da, uint64_t db, int scale_d,
                                           float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " UM_D48
      ", %48, %49, p, 1, 1;\n}\n"
      : UM_R8(d, 0), UM_R8(d, 8), UM_R8(d, 16), UM_R8(d, 24), UM_R8(d, 32), UM_R8(d, 40)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same with A from registers: a[i] holds A[16 warp + g + 8 (i % 2)][t +
// 4 (i / 2)] of the warpgroup's 64 x 8 slice (g = lane / 4, t = lane % 4;
// the tensor core reads the TF32 bits of each)
__device__ __forceinline__ void wgmma_step(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " UM_D48
      ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : UM_R8(d, 0), UM_R8(d, 8), UM_R8(d, 16), UM_R8(d, 24), UM_R8(d, 32), UM_R8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef UM_R8
#undef UM_R64
#undef UM_D64
#undef UM_D48

// out[row, col .. col + 8) = act(v + bias) + res, 16-byte vectors (row and
// col in bounds, every pointer 16-byte aligned, N % 8 == 0)
template <typename TRes, typename TOut>
__device__ __forceinline__ void epilogue_store8(float (&v)[8], size_t at, int col,
                                                const float* __restrict__ bias,
                                                const TRes* __restrict__ res, int gelu,
                                                TOut* __restrict__ out) {
  if (bias) {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
    v[0] += b0.x; v[1] += b0.y; v[2] += b0.z; v[3] += b0.w;
    v[4] += b1.x; v[5] += b1.y; v[6] += b1.z; v[7] += b1.w;
  }
  if (gelu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
  }
  if (res) {
    if constexpr (std::is_same<TRes, float>::value) {
      const float4 r0 = *reinterpret_cast<const float4*>(res + at);
      const float4 r1 = *reinterpret_cast<const float4*>(res + at + 4);
      v[0] += r0.x; v[1] += r0.y; v[2] += r0.z; v[3] += r0.w;
      v[4] += r1.x; v[5] += r1.y; v[6] += r1.z; v[7] += r1.w;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(res + at);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        v[2 * e] += __low2float(p);
        v[2 * e + 1] += __high2float(p);
      }
    }
  }
  if constexpr (std::is_same<TOut, float>::value) {
    float* o = reinterpret_cast<float*>(out + at);
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(out + at) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// vec: N % 8 == 0 and bias, res and out 16-byte aligned (else scalar stores)
template <typename T, typename TRes, typename TOut>
__global__ void __launch_bounds__(128 * (GemmCfg<T>::CONSUMERS + 1), GemmCfg<T>::MIN_BLOCKS)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                    const TRes* __restrict__ res, TOut* __restrict__ out, int M, int N, int K,
                    int gelu, int vec) {
  using Cfg = GemmCfg<T>;
  constexpr int S = GEMM_STAGES, STAGE = gemm_stage_bytes<T>();
  constexpr int BK = GEMM_ROW_BYTES / (int)sizeof(T);
  constexpr int KSTEP_BYTES = 32;  // a wgmma k-step: 16 bf16 or 8 tf32
  constexpr int BN = GEMM_BN, LOAD = GEMM_LOAD_BYTES;
  constexpr int LDS = BN + 8;  // staging row stride (floats): conflict-free float2 writes
  static_assert(GEMM_BM * LDS * 4 <= S * STAGE, "the staging tile must fit in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * STAGE);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(bars), empty = full + 8 * S, ready = full + 16 * S;

  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Cfg::CONSUMERS);
      mbar_init(ready + 8 * s, 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == Cfg::CONSUMERS) {
    // ---- producer: TMA ring (thread 0), lo tiles for f32 (all 128) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (!Cfg::LO && tid != 0) return;
    // k-block kb's lo tiles are written while kb + LAG loads; the conversion
    // comes first in an iteration, as the stage that the load waits for is
    // released only once the consumer has the k-block converted before it
    constexpr int LAG = Cfg::LO ? S - 1 : 0;
    for (int it = 0; it < nk + LAG; ++it) {
      if (Cfg::LO && it >= LAG) {
        const int kb = it - LAG, s = kb % S;
        mbar_wait(full + 8 * s, (kb / S) & 1);
        const float4* hi = reinterpret_cast<const float4*>(smem + s * STAGE);
        float4* lo = reinterpret_cast<float4*>(smem + s * STAGE + LOAD);
#pragma unroll 4
        for (int i = tid; i < LOAD / 16; i += 128) {
          const float4 x = hi[i];
          lo[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
        }
        // generic-proxy writes, read next by wgmma (the async proxy)
        fence_proxy_async();
        mbar_arrive(ready + 8 * s);
      }
      if (it < nk && tid == 0) {
        const int s = it % S;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, LOAD);
        tma_load(ring + s * STAGE, &tm_a, full + 8 * s, it * BK, m0);
        tma_load(ring + s * STAGE + GEMM_A_BYTES, &tm_w, full + 8 * s, it * BK, n0);
      }
    }
    return;
  }

  // ---- consumers: wgmma over the ring, then the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Cfg::CONSUMER_REGS));
  constexpr int HALVES = 2 / Cfg::CONSUMERS;  // 64-row halves of this warpgroup
  constexpr int R = BN / 2;  // accumulators a thread holds for a 64-row half
  constexpr int KSTEPS = GEMM_ROW_BYTES / KSTEP_BYTES;
  const T tag{};
  float acc[HALVES][R];
  if constexpr (Cfg::LO) {
    // f32: the tensor core's accumulation truncates, a bias of about half an
    // ulp of the accumulator each time it adds a product.  So each k-step's
    // three products start from zero and are then added into f32 registers
    // (a wgmma group a k-step; the other consumer warpgroup's products run
    // while this one waits and adds).  One 64-row half per warpgroup.
    float part[R], sum[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] = 0.f;
    const uint32_t row_off = wg * 64 * GEMM_ROW_BYTES;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      mbar_wait(ready + 8 * s, (kb / S) & 1);
      const uint32_t a = ring + s * STAGE, w = a + GEMM_A_BYTES;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t off = row_off + ks * KSTEP_BYTES;
        const uint64_t da = wgmma_desc(a + off), db = wgmma_desc(w + ks * KSTEP_BYTES);
        wgmma_fence();
        wgmma_step(part, wgmma_desc(a + LOAD + off), db, 0, tag);
        wgmma_step(part, da, wgmma_desc(w + LOAD + ks * KSTEP_BYTES), 1, tag);
        wgmma_step(part, da, db, 1, tag);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(part);
#pragma unroll
        for (int i = 0; i < R; ++i) sum[i] += part[i];
      }
      if (tid == 0) mbar_arrive(empty + 8 * s);  // the stage goes back to the producer
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[0][i] = sum[i];
  } else {
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[hh][i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      mbar_wait(full + 8 * s, (kb / S) & 1);
      const uint32_t a = ring + s * STAGE, w = a + GEMM_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          wgmma_step(acc[hh], wgmma_desc(a + (wg * HALVES + hh) * 64 * GEMM_ROW_BYTES +
                                         ks * KSTEP_BYTES),
                     wgmma_desc(w + ks * KSTEP_BYTES), 1, tag);
      wgmma_commit();
      wgmma_wait<1>();  // k-block kb - 1 is done: its stage goes back to the producer
      if (kb > 0 && tid == 0) mbar_arrive(empty + 8 * ((kb - 1) % S));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) acc_fence(acc[hh]);
  }

  // the ring is idle once every consumer is past its last k-block: stage
  // the tile there
  constexpr int CONSUMER_THREADS = 128 * Cfg::CONSUMERS;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  float* st = reinterpret_cast<float*>(smem);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
    const int r = (wg * HALVES + hh) * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(st + r * LDS + c) =
          make_float2(acc[hh][4 * j], acc[hh][4 * j + 1]);
      *reinterpret_cast<float2*>(st + (r + 8) * LDS + c) =
          make_float2(acc[hh][4 * j + 2], acc[hh][4 * j + 3]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  constexpr int CHUNKS = BN / 8;  // 8-column chunks of a row
#pragma unroll 1
  for (int e = tid; e < HALVES * 64 * CHUNKS; e += 128) {
    const int r = wg * HALVES * 64 + e / CHUNKS, c = (e % CHUNKS) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const float4 v0 = *reinterpret_cast<const float4*>(st + r * LDS + c);
    const float4 v1 = *reinterpret_cast<const float4*>(st + r * LDS + c + 4);
    float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    if (vec && col + 8 <= N) {
      epilogue_store8(v, (size_t)row * N + col, col, bias, res, gelu, out);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (col + q < N) epilogue_store(v[q], row, col + q, N, bias, res, gelu, out);
    }
  }
}

// ---- the narrow schedule: f32 (3xTF32) at the Swin's widths ----
//
// K4's products at the Swin's stages have K (and N) whole multiples of 96
// (N 96 .. 2304, K 96 .. 2304; M up to 81,920 at stage 1 b64).  On the
// 128 x 128 schedule above, N = 288 pads a third tile to 25% waste, and at
// K = 96 (three k-blocks) a tile is over before its 3-stage ring has
// filled: each tile pays a whole load latency, and its epilogue stalls the
// SM.  This schedule:
// - a 128 x 96 output tile (two consumer warpgroups of wgmma m64n96k8): no
//   padding at any Swin width;
// - persistent blocks, one an SM, each walking the tiles blockIdx.x, +
//   gridDim.x, ... (N-tiles fastest: the blocks in flight share their A
//   rows in L2), through a 4-stage ring (40 KB a stage with W's lo tile)
//   with no break between tiles: the next tile's loads run under this
//   tile's products and epilogue;
// - the producer warpgroup split: one thread issues the TMA loads, bounded
//   only by free stages (up to three k-blocks in flight), while three warps
//   write W's lo tile of each k-block that has landed;
// - A from registers for three passes: the products are bound by shared
//   memory's bandwidth (each wgmma reads its operands there, and the lo
//   tiles are written and read again), so each consumer thread reads its A
//   fragment of a k-block once and splits it into hi and lo in registers:
//   per k-block 40 KB of shared memory traffic less a warpgroup, and no A
//   lo tile.  The two passes of a_tf32 (no split) read A from shared
//   memory, which timed faster there;
// - each k-block's products (4 k-steps x 3 passes, the small ones first)
//   start from zero and are added into f32 registers once they are done:
//   the accumulation rule above at a k-block's grain, one drain of the
//   tensor core's pipeline a k-block, not four (a k-step's three dependent
//   products cannot fill it);
// - the epilogue: an f32 out (every K4 product but a bf16 x's projection)
//   goes through a 48 KB staging tile and leaves by TMA stores, which run
//   under the next tile's products: stored from registers, the output (94
//   MB for stage 1's qkv at b64) took as long as the products.  A bf16 out
//   or a residual is stored from registers (a lane quad writes a row's
//   32 bytes);
// - a_tf32: A is exactly TF32 (an f32 upcast of bf16), its lo part 0: the
//   consumers skip A_lo.W, which added exact zeros, so the result has the
//   same bits.
constexpr int NARROW_BM = 128, NARROW_BN = 96;
constexpr int NARROW_STAGES = 4;
constexpr int NARROW_A_BYTES = NARROW_BM * GEMM_ROW_BYTES;                        // 16 KB
constexpr int NARROW_W_BYTES = NARROW_BN * GEMM_ROW_BYTES;                        // 12 KB
constexpr int NARROW_LOAD_BYTES = NARROW_A_BYTES + NARROW_W_BYTES;               // 28 KB
constexpr int NARROW_STAGE_BYTES = NARROW_LOAD_BYTES + NARROW_W_BYTES;  // + W's lo tile
constexpr int NARROW_OUT_BYTES = NARROW_BM * NARROW_BN * 4;  // the f32 staging tile, 48 KB
constexpr int NARROW_CONVERTERS = 96;  // producer threads writing lo tiles
constexpr int NARROW_PRODUCER_REGS = 40, NARROW_CONSUMER_REGS = 232;
constexpr size_t narrow_smem_bytes() {
  return 1024 + (size_t)NARROW_STAGES * NARROW_STAGE_BYTES + NARROW_OUT_BYTES +
         3 * NARROW_STAGES * sizeof(uint64_t);
}

// out[row, col], out[row, col + 1] = act(v + bias) + res (col + 1 < N, N
// even, bias, res and out 8-byte aligned)
template <typename TRes, typename TOut>
__device__ __forceinline__ void epilogue_store2(float v0, float v1, size_t at, int col,
                                                const float* __restrict__ bias,
                                                const TRes* __restrict__ res, int gelu,
                                                TOut* __restrict__ out) {
  if (bias) {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    v0 += b.x;
    v1 += b.y;
  }
  if (gelu) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (res) {
    if constexpr (std::is_same<TRes, float>::value) {
      const float2 r = *reinterpret_cast<const float2*>(res + at);
      v0 += r.x;
      v1 += r.y;
    } else {
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + at);
      v0 += __low2float(r);
      v1 += __high2float(r);
    }
  }
  if constexpr (std::is_same<TOut, float>::value)
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
}

// tma_out: an f32 out without a residual leaves through tm_o (boxes of 32
// columns x 64 rows, 128-byte swizzle); else vec: N even and bias, res and
// out 8-byte aligned (else scalar stores)
template <typename TRes, typename TOut>
__global__ void __launch_bounds__(384, 1)
linear_narrow_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ bias,
                     const TRes* __restrict__ res, TOut* __restrict__ out, int M, int N, int K,
                     int gelu, int vec, int a_tf32, int tma_out) {
  constexpr int S = NARROW_STAGES, STAGE = NARROW_STAGE_BYTES, LOAD = NARROW_LOAD_BYTES;
  constexpr int BM = NARROW_BM, BN = NARROW_BN;
  constexpr int BK = GEMM_ROW_BYTES / (int)sizeof(float);  // 32 floats a k-block
  constexpr int KSTEP_BYTES = 32, KSTEPS = GEMM_ROW_BYTES / KSTEP_BYTES;
  constexpr int R = BN / 2;  // accumulators a thread holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* const staging = reinterpret_cast<float*>(smem + S * STAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * STAGE + NARROW_OUT_BYTES);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(bars), empty = full + 8 * S, ready = full + 16 * S;

  const int nk = (K + BK - 1) / BK;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int mine =
      (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = mine * nk;  // k-blocks this block walks, over all its tiles
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
      mbar_init(ready + 8 * s, NARROW_CONVERTERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NARROW_PRODUCER_REGS));
    if (tid == 0) {
      // ---- the TMA thread: k-block `it` into stage it % S once the
      // consumers have released what it held ----
      for (int it = 0; it < total; ++it) {
        const int s = it % S, q = it / nk, tile = (int)blockIdx.x + q * (int)gridDim.x;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, LOAD);
        tma_load(ring + s * STAGE, &tm_a, full + 8 * s, (it - q * nk) * BK,
                 (tile / tiles_n) * BM);
        tma_load(ring + s * STAGE + NARROW_A_BYTES, &tm_w, full + 8 * s, (it - q * nk) * BK,
                 (tile % tiles_n) * BN);
      }
    } else if (tid >= 32) {
      // ---- three warps: W's lo tile of each k-block that has landed
      // (A's lo part is taken in the consumers' registers) ----
      for (int g = 0; g < total; ++g) {
        const int s = g % S;
        mbar_wait(full + 8 * s, (g / S) & 1);
        const float4* hi = reinterpret_cast<const float4*>(smem + s * STAGE + NARROW_A_BYTES);
        float4* lo = reinterpret_cast<float4*>(smem + s * STAGE + LOAD);
#pragma unroll 4
        for (int i = tid - 32; i < NARROW_W_BYTES / 16; i += NARROW_CONVERTERS) {
          const float4 x = hi[i];
          lo[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
        }
        fence_proxy_async();  // generic-proxy writes, read next by wgmma
        mbar_arrive(ready + 8 * s);
      }
    }
    return;
  }

  // ---- consumers: a 64-row half of each tile each, wgmma over the ring,
  // then the epilogue from registers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NARROW_CONSUMER_REGS));
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  int g = 0;  // k-blocks consumed, over all tiles
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    const int tile = (int)blockIdx.x + i * (int)gridDim.x;
    const int m0 = (tile / tiles_n) * BM + wg * 64, n0 = (tile % tiles_n) * BN;
    // a k-block's products, small ones first (A_lo.W_hi, A_hi.W_lo, then
    // A_hi.W_hi: 12 wgmmas, 8 under a_tf32), start from zero in `part` and
    // are added into f32 registers once the group is done.  With A_lo, A
    // comes from registers: this thread's fragment of each k-step read once
    // from the swizzled tile (16-byte chunk c of row r at chunk c ^ (r % 8))
    // and split there into its raw bits (read as hi) and lo.  Under a_tf32
    // the two passes read A from shared memory, as W.
    float part[R], sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = 0.f;
    const float tag = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < nk; ++kb, ++g) {
      const int s = g % S;
      mbar_wait(full + 8 * s, (g / S) & 1);  // A, as the generic proxy reads it
      mbar_wait(ready + 8 * s, (g / S) & 1);  // W's lo tile
      const uint32_t a = ring + s * STAGE + wg * 64 * GEMM_ROW_BYTES;
      const uint32_t w = ring + s * STAGE + NARROW_A_BYTES;
      if (a_tf32) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_step(part, wgmma_desc(a + ks * KSTEP_BYTES),
                     wgmma_desc(w + NARROW_W_BYTES + ks * KSTEP_BYTES), ks > 0, tag);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_step(part, wgmma_desc(a + ks * KSTEP_BYTES), wgmma_desc(w + ks * KSTEP_BYTES),
                     1, tag);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(part);
      } else {
        const float* arow = reinterpret_cast<const float*>(smem + s * STAGE) +
                            (wg * 64 + 16 * warp + gq) * BK;  // rows gq and gq + 8 of the warp
        uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = arow[8 * BK * (i % 2) + (((2 * ks + i / 2) ^ gq) << 2) + tq];
            ah[ks][i] = __float_as_uint(x);
            al[ks][i] = __float_as_uint(tf32_lo(x));
          }
        wgmma_fence();  // after every write of the registers the products read
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_step(part, al[ks], wgmma_desc(w + ks * KSTEP_BYTES), ks > 0);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_step(part, ah[ks], wgmma_desc(w + NARROW_W_BYTES + ks * KSTEP_BYTES), 1);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_step(part, ah[ks], wgmma_desc(w + ks * KSTEP_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(part);
        // the tensor core reads A's registers until the group is done: keep
        // them live (unmoved, not reused) up to here
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            asm volatile("" : "+r"(ah[ks][i]), "+r"(al[ks][i])::"memory");
      }
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] += part[r];
      if (tid == 0) mbar_arrive(empty + 8 * s);  // the stage goes back to the producer
    }
    // sum[4j + 2h + e] is row m0 + 16 warp + gq + 8h, column n0 + 8j + 2tq + e
    if (tma_out) {
      // act(sum + bias) into this warpgroup's 64 rows of the staging tile
      // (three boxes of 32 columns, each [128 rows][128 bytes] in the
      // 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)),
      // once the previous tile's stores have read it; then one thread
      // stores the boxes and the warpgroup goes on to its next tile (TMA
      // clips what lies past M or N)
      if (tid == 0) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        const float b0 = bias && col < N ? bias[col] : 0.f;
        const float b1 = bias && col + 1 < N ? bias[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + 16 * warp + gq + 8 * h;  // row of the tile
          float v0 = sum[4 * j + 2 * h] + b0, v1 = sum[4 * j + 2 * h + 1] + b1;
          if (gelu) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          const int chunk = ((j % 4) * 2 + (tq >> 1)) ^ (r & 7);
          *reinterpret_cast<float2*>(staging + (j / 4) * BM * 32 + r * 32 + chunk * 4 +
                                     2 * (tq & 1)) = make_float2(v0, v1);
        }
      }
      fence_proxy_async();  // generic-proxy writes, read next by the TMA store
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (tid == 0) {
        const uint32_t src = smem_u32(staging) + wg * 64 * GEMM_ROW_BYTES;
#pragma unroll
        for (int box = 0; box < BN / 32; ++box)
          tma_store(&tm_o, src + box * BM * GEMM_ROW_BYTES, n0 + 32 * box, m0);
        bulk_commit();
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * warp + gq + 8 * h;
        if (row >= M || col >= N) continue;
        const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
        if (vec && col + 1 < N) {
          epilogue_store2(v0, v1, (size_t)row * N + col, col, bias, res, gelu, out);
        } else {
          epilogue_store(v0, row, col, N, bias, res, gelu, out);
          if (col + 1 < N) epilogue_store(v1, row, col + 1, N, bias, res, gelu, out);
        }
      }
    }
  }
  if (tma_out && tid == 0) bulk_wait();  // the last stores, before the block's memory goes
}

// ---- host side ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// a [rows, K] row-major operand read in boxes of 128 rows x 128 bytes,
// 128-byte swizzled, zeros past the edges
template <typename T>
inline bool encode_operand(CUtensorMap* map, const T* p, int rows, int K, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {GEMM_ROW_BYTES / (cuuint32_t)sizeof(T), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, GemmCfg<T>::TMA_TYPE, 2, (void*)p, dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// static: each library keeps its own attribute flag (a static local of an
// inline template is one object in the whole process)
template <typename T, typename TRes, typename TOut>
static inline int launch_linear_wgmma(const TRes* res, TOut* out, const T* A, const T* W,
                               const float* bias, int M, int N, int K, int gelu,
                               cudaStream_t stream) {
  // TMA: 16-byte aligned operands and row strides
  if (M <= 0 || N <= 0 || K <= 0 || (K * sizeof(T)) % 16 || (uintptr_t)A % 16 ||
      (uintptr_t)W % 16)
    return (int)cudaErrorInvalidValue;
  // cuTensorMapEncodeTiled needs a context current in this host thread; a
  // thread whose first CUDA call lands here (autograd's backward thread,
  // before any PyTorch op ran in it) has none until a runtime call binds
  // the device's primary context
  int dev;
  cudaError_t bound = cudaGetDevice(&dev);
  if (bound == cudaSuccess) bound = cudaSetDevice(dev);
  if (bound != cudaSuccess) return (int)bound;
  CUtensorMap tm_a, tm_w;
  if (!encode_operand(&tm_a, A, M, K, GEMM_BM) ||
      !encode_operand(&tm_w, W, N, K, GEMM_BN))
    return (int)cudaErrorNotSupported;
  const size_t smem = gemm_smem_bytes<T>();
  auto kern = linear_wgmma_kernel<T, TRes, TOut>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = N % 8 == 0 && (uintptr_t)out % 16 == 0 && (uintptr_t)res % 16 == 0 &&
                   (uintptr_t)bias % 16 == 0;
  const dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  kern<<<grid, 128 * (GemmCfg<T>::CONSUMERS + 1), smem, stream>>>(tm_a, tm_w, bias, res, out, M, N, K, gelu,
                                             vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// The narrow schedule on `grid` persistent blocks (ops/kernels.linear_plan:
// min(tiles, SMs)); a_tf32 as for linear_narrow_kernel.
template <typename TRes, typename TOut>
static inline int launch_linear_narrow(const TRes* res, TOut* out, const float* A, const float* W,
                                       const float* bias, int M, int N, int K, int gelu,
                                       int a_tf32, int grid, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || grid <= 0 || (K * sizeof(float)) % 16 ||
      (uintptr_t)A % 16 || (uintptr_t)W % 16)
    return (int)cudaErrorInvalidValue;
  int dev;  // a context bound in this thread before the encode (as above)
  cudaError_t bound = cudaGetDevice(&dev);
  if (bound == cudaSuccess) bound = cudaSetDevice(dev);
  if (bound != cudaSuccess) return (int)bound;
  // an f32 out without a residual leaves by TMA stores: rows of 16-byte
  // multiples, a 16-byte aligned base
  const bool tma_out = std::is_same<TOut, float>::value && res == nullptr && N % 4 == 0 &&
                       (uintptr_t)out % 16 == 0;
  CUtensorMap tm_a, tm_w, tm_o;
  if (!encode_operand(&tm_a, A, M, K, NARROW_BM) || !encode_operand(&tm_w, W, N, K, NARROW_BN) ||
      (tma_out && !encode_operand(&tm_o, (const float*)out, M, N, 64)))
    return (int)cudaErrorNotSupported;
  if (!tma_out) tm_o = tm_a;  // not read
  const size_t smem = narrow_smem_bytes();
  auto kern = linear_narrow_kernel<TRes, TOut>;
  static const cudaError_t attr = [&] {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = N % 2 == 0 && (uintptr_t)out % 8 == 0 && (uintptr_t)res % 8 == 0 &&
                   (uintptr_t)bias % 8 == 0;
  kern<<<grid, 384, smem, stream>>>(tm_a, tm_w, tm_o, bias, res, out, M, N, K, gelu,
                                    vec ? 1 : 0, a_tf32 ? 1 : 0, tma_out ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace um
