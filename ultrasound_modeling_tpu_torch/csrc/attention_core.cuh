// Attention core shared by K1 (transformer_block.cu), K4
// (window_attention.cu) and K5 (attention_train.cu): per (sequence, head),
// softmax(q*scale . k^T + A) . v on a packed qkv [B*S, 3C] float32
// projection.  K5 also stores what its backward consumes: the probabilities
// P [B, H, S, S] and, when the train dtype is bf16, a rounded copy of qkv.
//
// Replaces the per-head score/softmax/PV part of the Pallas kernel bodies
// _tblock_kernel and _window_attn_kernel (ultrasound_modeling_tpu/ops/
// pallas_kernels.py).  The TPU kernels packed T sequences into one
// [T*S, T*S] MXU matmul with a -1e9 off-block mask; here one block owns one
// (sequence, head) and nothing is packed.
//
// Bound: at the shapes of this model (S = 80, d = 128, 4 heads) a block does
// 2*S*S*d = 1.6 MFLOP on 80 KB of K/V: tiny next to the projections, so the
// design keeps it simple and exact rather than fast.  K and V of the head sit
// in shared memory (row stride d|1, odd, so that lane j reading row j hits a
// distinct bank); each warp takes one query row at a time, each lane scores
// up to MAX_S/32 keys, the row softmax reduces across the warp in float32,
// and lanes then split the head dimension for P.V.
#pragma once

#include "common.cuh"

namespace um {

constexpr int ATT_THREADS = 256;
constexpr int ATT_MAX_S = 160;  // ViT's 160 tokens is the longest user
constexpr int ATT_MAX_D = 160;  // ViT's 1280 / 8 heads

// PV_BF16: round P and V to bfloat16 before the P.V product (K1's numeric
// contract, _tblock_kernel:749-752); K4 and K5 keep them float32.
// p_save (may be null): the normalized float32 P of every (sequence, head,
// query row) in TSave, [B, H, S, S].  qkv_save (may be null): qkv in TSave,
// the same [B*S, 3C] layout; each block writes its own head's q, k, v
// columns, so the grid covers the tensor once.  Each warp already holds its
// row of P (Pw), so neither store needs shared memory.
template <typename TOut, bool PV_BF16, typename TSave = float>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_kernel(const float* __restrict__ qkv, const float* __restrict__ addmask,
                      TOut* __restrict__ out, int S, int C, int H, int nW,
                      float scale, TSave* __restrict__ p_save,
                      TSave* __restrict__ qkv_save) {
  extern __shared__ float smem[];
  const int seq = blockIdx.x, h = blockIdx.y;
  const int d = C / H, ld = d | 1;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ks = smem;
  float* Vs = Ks + S * ld;
  float* Qw = Vs + S * ld + warp * d;             // this warp's scaled query row
  float* Pw = Vs + S * ld + nwarps * d + warp * S;  // this warp's probabilities

  const size_t row3 = 3 * (size_t)C;
  const size_t base_at = (size_t)seq * S * row3 + (size_t)h * d;
  const float* base = qkv + base_at;
  TSave* save = qkv_save ? qkv_save + base_at : nullptr;
  for (int e = threadIdx.x; e < S * d; e += blockDim.x) {
    const int j = e / d, c = e - j * d;
    const float* r = base + j * row3 + c;
    const float k = r[C], v = r[2 * C];
    Ks[j * ld + c] = k;
    Vs[j * ld + c] = PV_BF16 ? round_bf16(v) : v;
    if (save) {
      save[j * row3 + c + C] = from_f32<TSave>(k);
      save[j * row3 + c + 2 * C] = from_f32<TSave>(v);
    }
  }
  __syncthreads();

  const float* am = addmask ? addmask + ((size_t)(seq % nW) * H + h) * S * S : nullptr;
  constexpr int T = ATT_MAX_S / 32;
  for (int i = warp; i < S; i += nwarps) {
    for (int c = lane; c < d; c += 32) {
      const float q = base[i * row3 + c];
      Qw[c] = q * scale;
      if (save) save[i * row3 + c] = from_f32<TSave>(q);
    }
    __syncwarp();
    float sc[T];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < S) {
        const float* kr = Ks + j * ld;
        float a = 0.f;
        for (int c = 0; c < d; ++c) a = fmaf(Qw[c], kr[c], a);
        s = am ? a + am[i * S + j] : a;
      }
      sc[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float p = (lane + 32 * t < S) ? expf(sc[t] - mx) : 0.f;
      sc[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    TSave* prow = p_save ? p_save + (((size_t)seq * H + h) * S + i) * S : nullptr;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        const float p = sc[t] / sum;
        Pw[j] = PV_BF16 ? round_bf16(p) : p;
        if (prow) prow[j] = from_f32<TSave>(p);
      }
    }
    __syncwarp();
    TOut* orow = out + ((size_t)seq * S + i) * C + (size_t)h * d;
    for (int c = lane; c < d; c += 32) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(Pw[j], Vs[j * ld + c], a);
      orow[c] = from_f32<TOut>(a);
    }
    __syncwarp();
  }
}

// B sequences of S tokens; addmask (may be null) is [nW, H, S, S] and
// sequence b uses addmask[b % nW]; p_save / qkv_save as for the kernel.
template <typename TOut, bool PV_BF16, typename TSave = float>
inline int launch_attention_core(const float* qkv, const float* addmask, TOut* out,
                                 int B, int S, int C, int H, int nW, float scale,
                                 cudaStream_t stream, TSave* p_save = nullptr,
                                 TSave* qkv_save = nullptr) {
  if (H <= 0 || C % H || S > ATT_MAX_S || C / H > ATT_MAX_D || nW <= 0)
    return (int)cudaErrorInvalidValue;
  const int d = C / H, ld = d | 1, nwarps = ATT_THREADS / 32;
  const size_t smem = (size_t)(2 * S * ld + nwarps * (d + S)) * sizeof(float);
  auto kern = attention_core_kernel<TOut, PV_BF16, TSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, H), ATT_THREADS, smem, stream>>>(qkv, addmask, out, S, C, H, nW, scale,
                                                  p_save, qkv_save);
  return (int)cudaGetLastError();
}

}  // namespace um
