// K1: the bf16 inference transformer block, as three hand-written kernels.
//
// Replaces transformer_block_fused / _tblock_kernel
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:781, body :703-775), which
// the JAX package runs once per layer for bf16 serving
// (models/transunet.py:247-267).
//
// On a v5e the whole layer is one kernel because VMEM holds the layer's
// ~14 MB of weights.  An H100 block has 227 KB of shared memory, so the
// layer is decomposed (ops/kernels.py transformer_block sequences them):
//   LN1 -> GEMM(qkv, +b, f32) -> attention core (P, V rounded to bf16)
//   -> GEMM(proj, +b, +x, f32 x1) -> LN2 -> GEMM(fc1, +b, GELU, bf16)
//   -> GEMM(fc2, +b, +x1) [-> final LN] -> bf16
// keeping the JAX kernel's numeric contract: the residual stream inside a
// layer is f32, the stream between layers bf16, matmuls take bf16 operands
// with f32 accumulation, GELU is exact erf.
//
// Bound: at batch 64 (M = 5120 rows) the four GEMMs are 2*M*C*(3C+C+2*4C)
// = 32 GFLOP per layer against ~0.1 GB of activation and weight traffic, so
// the GEMMs are compute-bound (989 TFLOP/s bf16: 33 us a layer) and
// everything else is a small memory-bound pass.  The GEMM (tb_linear) is
// gemm_sm90.cuh's wgmma kernel on bf16 operands: TMA-fed 128x128x64 tiles in
// a 3-stage mbarrier ring, two blocks an SM, the bias/GELU/residual epilogue
// fused into 16-byte stores.

#include "attention_core.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

using um::bf16;

namespace {

// ---- LayerNorm: one warp per row, f32 statistics (two-pass, centered) ----

constexpr int LN_THREADS = 256;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, TOut* __restrict__ y, int rows, int C,
                  float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + warp;
  if (row >= rows) return;  // whole warp leaves together
  const TIn* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += um::to_f32(xr[c]);
  const float mean = um::warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float z = um::to_f32(xr[c]) - mean;
    v += z * z;
  }
  const float rstd = rsqrtf(um::warp_sum(v) / C + eps);
  TOut* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = um::from_f32<TOut>((um::to_f32(xr[c]) - mean) * rstd * w[c] + b[c]);
}

template <typename TIn, typename TOut>
int launch_layer_norm(const void* x, const float* w, const float* b, void* y, int rows,
                      int C, float eps, cudaStream_t stream) {
  const int per_block = LN_THREADS / 32;
  layer_norm_kernel<TIn, TOut><<<(rows + per_block - 1) / per_block, LN_THREADS, 0,
                                 stream>>>((const TIn*)x, w, b, (TOut*)y, rows, C, eps);
  return (int)cudaGetLastError();
}

template <typename TRes, typename TOut>
int launch_linear_bf16(const TRes* res, TOut* out, const bf16* A, const bf16* W,
                       const float* bias, int M, int N, int K, int gelu,
                       cudaStream_t stream) {
  return um::launch_linear_wgmma<bf16, TRes, TOut>(res, out, A, W, bias, M, N, K, gelu,
                                                   stream);
}

}  // namespace

extern "C" {

// y[rows, C] = LN(x) * w + b; x and y each float32 or bfloat16.
int tb_layer_norm(const void* x, int x_bf16, const float* w, const float* b, void* y,
                  int y_bf16, int rows, int C, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    return y_bf16 ? launch_layer_norm<bf16, bf16>(x, w, b, y, rows, C, eps, st)
                  : launch_layer_norm<bf16, float>(x, w, b, y, rows, C, eps, st);
  }
  return y_bf16 ? launch_layer_norm<float, bf16>(x, w, b, y, rows, C, eps, st)
                : launch_layer_norm<float, float>(x, w, b, y, rows, C, eps, st);
}

// out[M, N] = act(A[M, K] . W[N, K]^T + bias) + res, bf16 operands, f32
// accumulation; res_kind 0 none / 1 float32 / 2 bfloat16; bias may be null.
int tb_linear(const void* A, const void* W, const float* bias, const void* res,
              int res_kind, void* out, int out_bf16, int M, int N, int K, int gelu,
              void* stream) {
  return UM_DISPATCH_EPILOGUE(launch_linear_bf16, res_kind, out_bf16, res, out,
                              (const bf16*)A, (const bf16*)W, bias, M, N, K, gelu,
                              (cudaStream_t)stream);
}

// ctx[B*S, C] (bf16) = per (sequence, head) softmax(q*scale . k^T) . v with P
// and V rounded to bf16; qkv is the f32 [B*S, 3C] projection.
int tb_attention_core(const float* qkv, void* out, int B, int S, int C, int H,
                      float scale, void* stream) {
  return um::launch_attention_fwd<float, true, bf16>(qkv, nullptr, (bf16*)out, nullptr, B, S,
                                                     C, H, 1, scale, true,
                                                     (cudaStream_t)stream);
}

}  // extern "C"
