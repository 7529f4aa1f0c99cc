// K4: fused window attention (forward), as hand-written kernels: the GEMM
// and the attention core.
//
// Replaces window_attention_fused / _fused_attn_fwd_pallas / _window_attn_kernel
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:83, :152, body :49-80): on
// the TransUNet f32 serving path every Attention at eval runs it with each
// batch element as one 80-token "window" and zero bias
// (models/transunet.py:85-96); Swin (N = 20 windows, relative-position bias,
// shifted mask) is its other user, in serving and training.  A bf16 x (the
// Swin under bf16) is upcast once in the wrapper (exact) and the projection
// stores bf16, so the products stay f32 as in _window_attn_kernel.  The
// backward (ops/kernels.py window_attention_bwd; _fused_attn_bwd, XLA in the
// JAX package) recomputes qkv and do = g.proj_w with wa_linear, runs its
// attention part in window_attention_bwd.cu and dx = dqkv.qkv_w on
// wa_linear again.
//
// Decomposition (ops/kernels.py window_attention sequences them):
//   GEMM(qkv, +b, f32) -> attention core (+ per-(window mod nW, head)
//   additive matrix built in the wrapper from the bias table, rel_index and
//   the mask) -> GEMM(proj, +b, f32).
// The TPU kernel's -1e9 block-diagonal packing of T windows into one MXU
// matmul (:116-140) is a Mosaic artifact and is dropped.  The core runs in
// one of two kernels, by the window's length:
// - N <= 32 (every Swin window: 4x5, and stage 4's padded 3x3):
//   wa_window_fwd_kernel below, one warp per (window, head);
// - N > 32 (the TransUNet's 80 and the ViT's 160 tokens, f32 serving):
//   attention_core.cuh's attention_fwd_kernel, a block per (sequence,
//   head, 64 query rows).
//
// Bound: the f32 GEMMs (2*M*C*4C = 10.7 GFLOP per layer at batch 64) are
// compute-bound at the TransUNet and ViT widths.  They keep the f32
// contract on the tensor cores with 3xTF32 (A_lo.W + A.W_lo + A.W, ~1e-6
// relative; the fastest f32-accurate product on the card: 495 / 3 = 165
// TFLOP/s): wa_linear is gemm_sm90.cuh's wgmma kernel on f32 operands,
// TMA-fed tiles whose lo parts the producer warpgroup writes beside them,
// the epilogue fused into the store.  At the Swin's widths (N and K whole
// multiples of 96) it takes the narrow schedule (128 x 96 tiles, persistent,
// a 4-stage ring; gemm_sm90.cuh), chosen by the caller's plan
// (ops/kernels.linear_plan); where A is known to be exactly TF32 (the qkv
// product of a bf16 x, upcast) the A_lo pass is dropped.
//
// The window core's bound: at the Swin's stage 1, b64 (4,096 windows, N 20,
// C 96, 3 heads) it reads qkv (94 MB) and writes the context (31 MB), 37
// us at 3.35 TB/s, for 0.6 GFLOP of f32-contract products (4 us at 165
// TFLOP/s): bytes bind.  A 64-row query tile per (window, head), as
// attention_fwd_kernel runs it, fills 20 of its 64 rows, leaves two of its
// four warps idle and stages K and V for a third of a tile's work.  So:
// - one warp per (window, head), four warps a block, each warp's q, k and v
//   tiles (rows padded to 16 * MT, columns to pad_d(d), zeros) staged with
//   cp.async in its own slice of shared memory: 13.8 KB a warp at d = 32,
//   four blocks (16 warps) on each SM, 125 KB of loads in flight an SM
//   (the carveout set to all shared memory: left to the CUDA runtime's
//   choice, fewer blocks fit); v's copy and the additive matrix's loads are in
//   flight under q.k^T;
// - s = (q*scale).k^T + A[b % nW, h] and ctx = P.v on mma.sync m16n8k8 as
//   3xTF32 (rows_product, cols_product), s and P in registers; the exact
//   row softmax in f32 (window_softmax: padded key columns take -inf before
//   the row max, padded query rows are not stored);
// - the context leaves from registers, each lane quad writing 32 bytes of a
//   row; no block barrier: a warp leaves when its window is done.

#include <algorithm>

#include "attention_core.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

using um::bf16;

namespace {

constexpr int WF_MAX_N = 32;        // the window kernel's longest window
constexpr int WF_MAX_WARPS = 4;

// narrow_grid > 0: the narrow schedule on that many persistent blocks;
// 0: the 128 x 128 schedule (a_tf32 changes no bit there and is not used)
template <typename TRes, typename TOut>
int launch_linear_f32(const TRes* res, TOut* out, const float* A, const float* W,
                      const float* bias, int M, int N, int K, int gelu, int a_tf32,
                      int narrow_grid, cudaStream_t stream) {
  if (narrow_grid > 0)
    return um::launch_linear_narrow<TRes, TOut>(res, out, A, W, bias, M, N, K, gelu,
                                                a_tf32, narrow_grid, stream);
  return um::launch_linear_wgmma<float, TRes, TOut>(res, out, A, W, bias, M, N, K, gelu,
                                                    stream);
}

// One warp per (window b, head h) = (w / H, w % H) for w < work = B * H:
// ctx[b*N + i, h*d + c] = sum_j softmax_j(scale q_i.k_j + A[b % nW, h, i, j])
// v_j[c], NT key tiles of 8 (N <= 8 NT), MT = ceil(NT / 2) query tiles of 16.
template <int NT>
__global__ void __launch_bounds__(32 * WF_MAX_WARPS, 4)
wa_window_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ addmask,
                     float* __restrict__ out, int N, int C, int H, int nW, int work,
                     float scale) {
  constexpr int MT = um::win_mtiles(NT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= work) return;  // no block barrier below: warps leave on their own
  const int h = w % H;
  const size_t b = w / H;
  const int d = C / H, dk = um::pad_d(d), ld = um::smem_ld<float>(dk), nks = dk / 8;
  const int rows_pad = 16 * MT, tile = rows_pad * ld;
  float* const Qs = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 3 * tile;
  float* const Ks = Qs + tile;
  float* const Vs = Ks + tile;
  const size_t row3 = 3 * (size_t)C;
  const float* base = qkv + b * N * row3 + (size_t)h * d;
  const bool vec = um::stage_vec(base, row3, d);
  um::warp_stage(Qs, ld, base, row3, N, d, rows_pad, dk, vec);
  um::warp_stage(Ks, ld, base + C, row3, N, d, rows_pad, dk, vec);
  um::cp_async_commit();
  um::warp_stage(Vs, ld, base + 2 * C, row3, N, d, rows_pad, dk, vec);  // lands under q.k^T
  um::cp_async_commit();
  const float* am = addmask ? addmask + ((b % nW) * H + h) * N * N : nullptr;
  float add[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) um::load_addmask<NT>(add[mt], am, mt, N);
  um::cp_async_wait_but<1>();  // q and k
  __syncwarp();

  float s[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
  um::rows_product<MT, NT>(s, Qs, Ks, ld, nks, scale);  // (q*scale).k^T
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) um::window_softmax<NT>(s[mt], add[mt], mt, N);
  um::cp_async_wait();  // v
  __syncwarp();
  float* const orow = out + b * N * C + (size_t)h * d;
  const bool pair = d % 2 == 0 && C % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int q0 = 16 * mt + g, q1 = q0 + 8;
    um::cols_product<NT, false>(s[mt], Vs, ld, d, q0 < N ? orow + (size_t)q0 * C : nullptr,
                                q1 < N ? orow + (size_t)q1 * C : nullptr, pair);
  }
}

int launch_window_fwd(const float* qkv, const float* addmask, float* out, int B, int N,
                      int C, int H, int nW, float scale, cudaStream_t stream) {
  const int nt = (N + 7) / 8;
  const size_t warp_bytes =
      (size_t)3 * 16 * um::win_mtiles(nt) * um::smem_ld<float>(um::pad_d(C / H)) * sizeof(float);
  const int warps = (int)std::min<size_t>(WF_MAX_WARPS, um::WIN_SMEM_MAX / warp_bytes);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * warp_bytes;
  const int work = B * H;
  auto launch = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // four blocks an SM need all of its shared memory as such
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kern<<<(work + warps - 1) / warps, 32 * warps, smem, stream>>>(qkv, addmask, out, N, C, H,
                                                                 nW, work, scale);
    return (int)cudaGetLastError();
  };
  return nt == 1   ? launch(wa_window_fwd_kernel<1>)
         : nt == 2 ? launch(wa_window_fwd_kernel<2>)
         : nt == 3 ? launch(wa_window_fwd_kernel<3>)
                   : launch(wa_window_fwd_kernel<4>);
}

}  // namespace

extern "C" {

// out[M, N] = act(A[M, K] . W[N, K]^T + bias) + res, all float32 math;
// res_kind 0 none / 1 float32 / 2 bfloat16; bias may be null.  a_tf32: the
// caller knows every A value to be exactly TF32 (its low 13 bits zero), so
// A_lo is 0 and the narrow schedule drops its pass (the same bits);
// narrow_grid: the narrow schedule's persistent blocks, or 0 for the
// 128 x 128 schedule (ops/kernels.linear_plan).
int wa_linear(const void* A, const void* W, const float* bias, const void* res,
              int res_kind, void* out, int out_bf16, int M, int N, int K, int gelu,
              int a_tf32, int narrow_grid, void* stream) {
  return UM_DISPATCH_EPILOGUE(launch_linear_f32, res_kind, out_bf16, res, out,
                              (const float*)A, (const float*)W, bias, M, N, K, gelu,
                              a_tf32, narrow_grid, (cudaStream_t)stream);
}

// ctx[B*S, C] (f32) = per (window, head) softmax(q*scale . k^T + A[b % nW, h]) . v;
// addmask A [nW, H, S, S] may be null.  Windows of at most 32 tokens run
// wa_window_fwd_kernel, longer ones attention_fwd_kernel.
int wa_attention_core(const float* qkv, const float* addmask, float* out, int B, int S,
                      int C, int H, int nW, float scale, void* stream) {
  if (S <= WF_MAX_N) {
    if (um::att_bad_shape(B, S, C, H) || nW <= 0) return (int)cudaErrorInvalidValue;
    return launch_window_fwd(qkv, addmask, out, B, S, C, H, nW, scale, (cudaStream_t)stream);
  }
  return um::launch_attention_fwd<float, false, float>(qkv, addmask, out, nullptr, B, S, C,
                                                       H, nW, scale, true,
                                                       (cudaStream_t)stream);
}

}  // extern "C"
