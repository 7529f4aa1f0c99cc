// K4: fused window attention (forward), as two hand-written kernels.
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
// matmul (:116-140) is a Mosaic artifact and is dropped: the core
// (attention_core.cuh) runs a block per (window, head, 64 query rows).
//
// Bound: the f32 GEMMs (2*M*C*4C = 10.7 GFLOP per layer at batch 64) are
// compute-bound.  They keep the f32 contract on the tensor cores with 3xTF32
// (A_lo.W + A.W_lo + A.W, ~1e-6 relative; the fastest f32-accurate product
// on the card: 495 / 3 = 165 TFLOP/s): wa_linear is gemm_sm90.cuh's wgmma
// kernel on f32 operands, TMA-fed 128x128x32 tiles whose lo parts the
// producer warpgroup writes beside them, the epilogue fused into the store.

#include "attention_core.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

using um::bf16;

namespace {

template <typename TRes, typename TOut>
int launch_linear_f32(const TRes* res, TOut* out, const float* A, const float* W,
                      const float* bias, int M, int N, int K, int gelu,
                      cudaStream_t stream) {
  return um::launch_linear_wgmma<float, TRes, TOut>(res, out, A, W, bias, M, N, K, gelu,
                                                    stream);
}

}  // namespace

extern "C" {

// out[M, N] = act(A[M, K] . W[N, K]^T + bias) + res, all float32 math;
// res_kind 0 none / 1 float32 / 2 bfloat16; bias may be null.
int wa_linear(const void* A, const void* W, const float* bias, const void* res,
              int res_kind, void* out, int out_bf16, int M, int N, int K, int gelu,
              void* stream) {
  return UM_DISPATCH_EPILOGUE(launch_linear_f32, res_kind, out_bf16, res, out,
                              (const float*)A, (const float*)W, bias, M, N, K, gelu,
                              (cudaStream_t)stream);
}

// ctx[B*S, C] (f32) = per (window, head) softmax(q*scale . k^T + A[b % nW, h]) . v;
// addmask A [nW, H, S, S] may be null.
int wa_attention_core(const float* qkv, const float* addmask, float* out, int B, int S,
                      int C, int H, int nW, float scale, void* stream) {
  return um::launch_attention_fwd<float, false, float>(qkv, addmask, out, nullptr, B, S, C,
                                                       H, nW, scale, true,
                                                       (cudaStream_t)stream);
}

}  // extern "C"
