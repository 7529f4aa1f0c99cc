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
// the GEMMs are compute-bound and everything else is a small memory-bound
// pass.
// This first version tiles the GEMM for the tensor cores with WMMA
// (16x16x16 bf16 fragments, f32 accumulators), a 64x128x32 block tile,
// cp.async double buffering, and the bias/GELU/residual epilogue fused
// into the store; wgmma/TMA are left for later work.

#include <mma.h>

#include "attention_core.cuh"
#include "common.cuh"

using namespace nvcuda;
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

// ---- bf16 GEMM: out[M,N] = epilogue(A[M,K] . W[N,K]^T) ----

constexpr int BM = 64, BN = 128, BK = 32, PADK = BK + 8;  // 80-byte smem rows
constexpr int GEMM_THREADS = 128;                          // 2x2 warps, 32x64 each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // src-size 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

template <typename TRes, typename TOut>
__global__ void __launch_bounds__(GEMM_THREADS)
linear_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                   const float* __restrict__ bias, const TRes* __restrict__ res,
                   TOut* __restrict__ out, int M, int N, int K, int gelu) {
  __shared__ __align__(128) bf16 As[2][BM][PADK];
  __shared__ __align__(128) bf16 Ws[2][BN][PADK];
  __shared__ __align__(128) float stage[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const int wm = warp >> 1, wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = bm + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(&As[buf][r][kc], ok ? A + (size_t)gr * K + gk : A, ok);
    }
    for (int c = tid; c < BN * BK / 8; c += GEMM_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = bn + r, gk = k0 + kc;
      const bool ok = gr < N && gk < K;
      cp_async16(&Ws[buf][r][kc], ok ? W + (size_t)gr * K + gk : W, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tile(kt + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][wm * 32 + i * 16][kk], PADK);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], &Ws[buf][wn * 64 + j * 16][kk], PADK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 accumulator tile at a time
  float* st = stage[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = bm + wm * 32 + i * 16 + r;
      if (row < M) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = bn + wn * 64 + j * 16 + c0 + t;
          if (col < N) um::epilogue_store(st[r * 16 + c0 + t], row, col, N, bias, res, gelu, out);
        }
      }
      __syncwarp();
    }
  }
}

template <typename TRes, typename TOut>
int launch_linear_bf16(const TRes* res, TOut* out, const bf16* A, const bf16* W,
                       const float* bias, int M, int N, int K, int gelu,
                       cudaStream_t stream) {
  if (K % 8) return (int)cudaErrorInvalidValue;  // 16-byte cp.async chunks
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_bf16_kernel<TRes, TOut><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, res, out,
                                                                    M, N, K, gelu);
  return (int)cudaGetLastError();
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
