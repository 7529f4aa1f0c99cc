// Shared device helpers for the port's kernels (built for sm_90a).
//
// Every C entry point in csrc/*.cu launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() as an int; the Python
// wrapper in ops/kernels.py raises when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace um {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round-to-nearest-even, as torch's .to(bfloat16) and jax's astype
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x's part below its TF32 truncation (what the tensor core reads of x),
// itself rounded to the nearest TF32 value: unbiased, within 2^-21 of x
// (left to the tensor core's truncation, every product would come out
// short by ~2^-21 of itself on average)
__device__ __forceinline__ float tf32_lo(float x) {
  const float lo = x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float((__float_as_uint(lo) + 0x1000u) & 0xffffe000u);
}

// ---- shared-memory barriers and bulk copies (the GEMM's TMA ring, K2's
// tile ring) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// makes the mbarrier inits visible to the async proxy (bulk copies, TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's earlier generic-proxy shared-memory accesses before
// its later async-proxy ones (a bulk copy into a buffer threads have written)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// exact-erf GELU (the JAX kernel's rational _erf exists only because Mosaic
// lowers no erf)
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// GEMM epilogue shared by both matmul kernels:
//   out[row, col] = act(acc + bias[col]) + res[row, col]
template <typename TRes, typename TOut>
__device__ __forceinline__ void epilogue_store(float acc, int row, int col, int N,
                                               const float* __restrict__ bias,
                                               const TRes* __restrict__ res,
                                               int gelu, TOut* __restrict__ out) {
  float v = acc;
  if (bias) v += bias[col];
  if (gelu) v = gelu_erf(v);
  const size_t at = (size_t)row * N + col;
  if (res) v += to_f32(res[at]);
  out[at] = from_f32<TOut>(v);
}

}  // namespace um

// Instantiate LAUNCH<TRes, TOut>(ARGS...) for the residual kind
// (0 none, 1 float32, 2 bfloat16) and the output type; evaluates to the
// launch's cudaError_t as int.
#define UM_DISPATCH_EPILOGUE(LAUNCH, res_kind, out_bf16, res, out, ...)        \
  ([&]() -> int {                                                               \
    using um::bf16;                                                             \
    if ((res_kind) == 0) {                                                      \
      if (out_bf16) return LAUNCH<float, bf16>((const float*)nullptr,           \
                                               (bf16*)(out), __VA_ARGS__);      \
      return LAUNCH<float, float>((const float*)nullptr, (float*)(out),         \
                                  __VA_ARGS__);                                 \
    }                                                                           \
    if ((res_kind) == 1) {                                                      \
      if (out_bf16) return LAUNCH<float, bf16>((const float*)(res),             \
                                               (bf16*)(out), __VA_ARGS__);      \
      return LAUNCH<float, float>((const float*)(res), (float*)(out),           \
                                  __VA_ARGS__);                                 \
    }                                                                           \
    if ((res_kind) == 2) {                                                      \
      if (out_bf16) return LAUNCH<bf16, bf16>((const bf16*)(res), (bf16*)(out), \
                                              __VA_ARGS__);                     \
      return LAUNCH<bf16, float>((const bf16*)(res), (float*)(out),             \
                                 __VA_ARGS__);                                  \
    }                                                                           \
    return (int)cudaErrorInvalidValue;                                          \
  }())
