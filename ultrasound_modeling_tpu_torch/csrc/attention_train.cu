// K5: the train-path attention forward that saves its backward's inputs.
//
// Replaces attention_train_fused / _attn_train_fwd_pallas / _attn_train_kernel
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:446, :311, body :276-308),
// which the JAX package runs in every Attention of a train step under
// attn_train_impl='pallas' (models/transunet.py:97-102; the ViT reaches it
// through the same Block).
//
// Decomposition (ops/kernels.py attention_train_fwd sequences them):
//   GEMM(qkv, +b, f32: tb_linear for bf16, wa_linear for f32)
//   -> this attention core, which per (sequence, head) takes the scores from
//      the float32 projection (q*scale in f32), keeps P in f32 through P.V,
//      writes the float32 context, and stores P [B, H, S, S] and (bf16 only)
//      the rounded qkv copy in the train dtype, both in natural layouts
//   -> GEMM(proj, +b) of the f32 context and the upcast weights (wa_linear),
//      rounded once to the train dtype.
// Dropped from the TPU kernel, all Mosaic/VMEM artifacts: the (batch tile,
// head) grid with head-sliced weights, the head-major [H, B*N, 3d] qkv and
// [G, H, rows, rows] probs layouts (whose relayouts made K5 the measured
// loser on the TPU, :492-495), and the -1e9 block-diagonal packing.
//
// Numerics against the TPU kernel: the same contract, f32 sums in another
// order; as there (:294-308), the context enters the output projection in
// f32 and the output is rounded once.
//
// Bound: at the ViT train shape (b8, S 160, C 1280, 8 heads) the core
// (attention_core.cuh: a block per (sequence, head, 64 query rows), both
// products on the tensor cores) reads 26 MB of f32 qkv and writes P (6.6 MB
// in f32), the context and, under bf16, the qkv copy; bytes bind (~11 us in
// f32 at 3.35 TB/s).  The projections (2*1280*C*4C = 16.8 GFLOP) dominate
// the layer and run on the GEMM kernels.

#include "attention_core.cuh"
#include "common.cuh"

using um::bf16;

extern "C" {

// ctx[B*S, C] (float32) = per (sequence, head) softmax(q*scale . k^T) . v on
// the f32 projection qkv [B*S, 3C]; probs [B, H, S, S] = that softmax;
// save_bf16 selects bf16 for probs and then also writes qkv_save [B*S, 3C],
// qkv rounded to bf16 (with float32 probs qkv_save must be null: the
// projection is its own copy).
int at_attention_core(const float* qkv, float* out, void* probs, void* qkv_save,
                      int save_bf16, int B, int S, int C, int H, float scale,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (save_bf16)
    return um::launch_attention_fwd<float, false, float, bf16>(
        qkv, nullptr, out, nullptr, B, S, C, H, 1, scale, true, st, (bf16*)probs,
        (bf16*)qkv_save);
  if (qkv_save) return (int)cudaErrorInvalidValue;
  return um::launch_attention_fwd<float, false, float, float>(
      qkv, nullptr, out, nullptr, B, S, C, H, 1, scale, true, st, (float*)probs,
      (float*)nullptr);
}

}  // extern "C"
