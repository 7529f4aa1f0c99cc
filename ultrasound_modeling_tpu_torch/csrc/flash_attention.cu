// K3: flash-style attention core of the train path, forward and backward,
// on the tensor cores.
//
// Replaces flash_mha (ultrasound_modeling_tpu/ops/pallas_kernels.py:655): the
// forward _flash_fwd_pallas (:576, kernel _flash_core_fwd_kernel :510-529) and
// the backward _flash_bwd_pallas (:607, kernel _flash_core_bwd_kernel
// :532-565).  The JAX package runs it under `--attn-train flash` in every
// TransUNet layer (models/transunet.py:103-112) and as the ViT's train default.
//
// Input: the packed projection qkv [B*S, 3C] (q | k | v, heads contiguous in
// each), float32 or bfloat16.  Per (sequence, head), with d = C / H:
//   forward   s = q.k^T * scale; lse = max + log(sum exp); P = softmax(s) cast
//             to qkv's type; ctx = P.v -> [B*S, C] in qkv's type; lse float32
//             [B, H, S] is the only saved statistic.
//   backward  P = exp(s - lse) (float32); dP = g.v^T; dS = P * (dP -
//             rowsum(dP * P)) * scale, cast to qkv's type; dq = dS.k,
//             dk = dS^T.q, dv = (P cast to qkv's type)^T.g -> dqkv [B*S, 3C].
// All sums are float32; that is the JAX kernel's dtype contract.  Under
// float32 every product runs as 3xTF32, under bf16 as bf16 MMAs (the
// operands are bf16 in the contract: qkv, g, the cast P and dS).
//
// The forward is attention_core.cuh's kernel (scale after the product, LSE
// out).  The backward is two deterministic passes with no float atomics and
// no S x S scratch, on the same tiling (64 rows a block, four warps of 16,
// a warp's 16 x S tiles in registers, one operand of the head in shared
// memory at a time):
//   pass 1, grid (sequence, head, query tile): dP = g.V^T with V staged, then
//           s = q.K^T with K staged in its place; P, the f32 row sums
//           rowsum(dP * P) (written out, [B, H, S]), dS, and dq = dS.K;
//   pass 2, grid (sequence, head, key tile): the transposed tiles P^T =
//           exp(k.Q^T * scale - lse) with Q staged and dP^T = v.G^T with G
//           staged, dS^T from pass 1's row sums, dv = P^T.G, then Q again
//           for dk = dS^T.Q.
// Bound: at the ViT train shape (b8, S = d = 160, 8 heads) the backward
// reads qkv, g and the LSE and writes dqkv, ~46 MB in f32 (14 us at
// 3.35 TB/s), for 5 products of 2*S*S*d per (sequence, head) = 2.1 GFLOP.

#include "attention_core.cuh"
#include "common.cuh"

using um::bf16;

namespace {

using um::ATT_THREADS;
using um::ATT_TILE;

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) { return um::round_bf16(v); }

// pass 1: per query row i, rowsum_i = sum_j dP_ij P_ij, dS, dq_i = dS_i . K
template <int NT, typename T>
__global__ void __launch_bounds__(ATT_THREADS, 2)
fa_bwd_query_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                    const T* __restrict__ gout, T* __restrict__ dqkv,
                    float* __restrict__ rowsum, int S, int C, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Bs = reinterpret_cast<T*>(smem_raw);
  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * ATT_TILE;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int d = C / H, dk = um::pad_d(d), Sp = 8 * NT;
  const int ld = um::smem_ld<T>(dk);
  const size_t row3 = 3 * (size_t)C, bh = (size_t)seq * H + h;
  const T* base = qkv + (size_t)seq * S * row3 + (size_t)h * d;
  const T* gb = gout + (size_t)seq * S * C + (size_t)h * d;
  const bool vec = um::stage_vec(base, row3, d);

  const int rw = q0 + warp * 16;
  const bool active = rw < S;
  const int r0 = rw + g, r1 = r0 + 8;
  float dp[NT][4], s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] = 0.f;

  um::stage(Bs, ld, base + 2 * C, row3, S, d, Sp, dk, vec);  // V
  um::cp_async_commit();
  um::RowStream<T> a;
  if (active)
    a.start(r0 < S ? gb + (size_t)r0 * C : nullptr, r1 < S ? gb + (size_t)r1 * C : nullptr, d);
  um::cp_async_wait();
  __syncthreads();
  if (active) a.template run<NT>(dp, 1.f, Bs, ld);  // dP = g . V^T
  __syncthreads();
  um::stage(Bs, ld, base + C, row3, S, d, Sp, dk, vec);  // K
  um::cp_async_commit();
  if (active)
    a.start(r0 < S ? base + r0 * row3 : nullptr, r1 < S ? base + r1 * row3 : nullptr, d);
  um::cp_async_wait();
  __syncthreads();
  if (!active) return;
  a.template run<NT>(s, 1.f, Bs, ld);  // s = q . K^T

  const float L0 = r0 < S ? lse[bh * S + r0] : 0.f, L1 = r1 < S ? lse[bh * S + r1] : 0.f;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = 8 * j + 2 * t + e < S;
      s[j][e] = ok ? expf(s[j][e] * scale - L0) : 0.f;
      s[j][2 + e] = ok ? expf(s[j][2 + e] * scale - L1) : 0.f;
      rs0 += dp[j][e] * s[j][e];
      rs1 += dp[j][2 + e] * s[j][2 + e];
    }
  }
  rs0 = um::quad_sum(rs0);
  rs1 = um::quad_sum(rs1);
  if (t == 0) {
    if (r0 < S) rowsum[bh * S + r0] = rs0;
    if (r1 < S) rowsum[bh * S + r1] = rs1;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[j][e] = rnd<T>(s[j][e] * (dp[j][e] - rs0) * scale);
      dp[j][2 + e] = rnd<T>(s[j][2 + e] * (dp[j][2 + e] - rs1) * scale);
    }
  }
  T* d0 = r0 < S ? dqkv + (size_t)seq * S * row3 + r0 * row3 + (size_t)h * d : nullptr;
  T* d1 = r1 < S ? dqkv + (size_t)seq * S * row3 + r1 * row3 + (size_t)h * d : nullptr;
  um::cols_product<NT, false>(dp, Bs, ld, d, d0, d1, d % 2 == 0);
}

// pass 2: per key row j, dv_j = cast(P)^T_j . G and dk_j = dS^T_j . Q, over
// all query rows i (the columns of the transposed tiles)
template <int NT, typename T>
__global__ void __launch_bounds__(ATT_THREADS, 2)
fa_bwd_key_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                  const T* __restrict__ gout, const float* __restrict__ rowsum,
                  T* __restrict__ dqkv, int S, int C, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Bs = reinterpret_cast<T*>(smem_raw);
  const int seq = blockIdx.x, h = blockIdx.y, k0 = blockIdx.z * ATT_TILE;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int d = C / H, dk = um::pad_d(d), Sp = 8 * NT;
  const int ld = um::smem_ld<T>(dk);
  const size_t row3 = 3 * (size_t)C, bh = (size_t)seq * H + h;
  const T* base = qkv + (size_t)seq * S * row3 + (size_t)h * d;
  const T* gb = gout + (size_t)seq * S * C + (size_t)h * d;
  const bool vec = um::stage_vec(base, row3, d), gvec = um::stage_vec(gb, (size_t)C, d);
  float* const Ls = reinterpret_cast<float*>(smem_raw + (size_t)Sp * ld * sizeof(T));
  float* const Rs = Ls + Sp;  // the row statistics of every query

  const int jw = k0 + warp * 16;
  const bool active = jw < S;
  const int j0 = jw + g, j1 = j0 + 8;
  float pt[NT][4], dpt[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[j][e] = dpt[j][e] = 0.f;

  um::stage(Bs, ld, base, row3, S, d, Sp, dk, vec);  // Q
  um::cp_async_commit();
  for (int i = threadIdx.x; i < Sp; i += ATT_THREADS) {
    Ls[i] = i < S ? lse[bh * S + i] : 0.f;
    Rs[i] = i < S ? rowsum[bh * S + i] : 0.f;
  }
  um::RowStream<T> a;
  if (active)
    a.start(j0 < S ? base + C + j0 * row3 : nullptr, j1 < S ? base + C + j1 * row3 : nullptr,
            d);
  um::cp_async_wait();
  __syncthreads();
  if (active) {
    a.template run<NT>(pt, 1.f, Bs, ld);  // k . Q^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * j + 2 * t + e;
        const bool ok = i < S;
        pt[j][e] = ok ? expf(pt[j][e] * scale - Ls[i]) : 0.f;
        pt[j][2 + e] = ok ? expf(pt[j][2 + e] * scale - Ls[i]) : 0.f;
      }
    }
  }
  __syncthreads();
  um::stage(Bs, ld, gb, (size_t)C, S, d, Sp, dk, gvec);  // G
  um::cp_async_commit();
  if (active)
    a.start(j0 < S ? base + 2 * C + j0 * row3 : nullptr,
            j1 < S ? base + 2 * C + j1 * row3 : nullptr, d);
  um::cp_async_wait();
  __syncthreads();
  T* dk0 = j0 < S ? dqkv + (size_t)seq * S * row3 + j0 * row3 + (size_t)h * d : nullptr;
  T* dk1 = j1 < S ? dqkv + (size_t)seq * S * row3 + j1 * row3 + (size_t)h * d : nullptr;
  const bool pair = d % 2 == 0;
  if (active) {
    a.template run<NT>(dpt, 1.f, Bs, ld);  // v . G^T
    // dv = cast(P)^T . G (a bf16 product rounds P as it packs it)
    um::cols_product<NT, false>(pt, Bs, ld, d, dk0 ? dk0 + 2 * C : nullptr,
                             dk1 ? dk1 + 2 * C : nullptr, pair);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * j + 2 * t + e;
        const float R = i < S ? Rs[i] : 0.f;  // P^T is 0 past S
        dpt[j][e] = rnd<T>(pt[j][e] * (dpt[j][e] - R) * scale);
        dpt[j][2 + e] = rnd<T>(pt[j][2 + e] * (dpt[j][2 + e] - R) * scale);
      }
    }
  }
  __syncthreads();
  um::stage(Bs, ld, base, row3, S, d, Sp, dk, vec);  // Q again
  um::cp_async_commit();
  um::cp_async_wait();
  __syncthreads();
  if (!active) return;
  um::cols_product<NT, false>(dpt, Bs, ld, d, dk0 ? dk0 + C : nullptr,
                           dk1 ? dk1 + C : nullptr, pair);
}

template <typename T>
int launch_forward(const void* qkv, void* out, float* lse, int B, int S, int C, int H,
                   float scale, cudaStream_t stream) {
  return um::launch_attention_fwd<T, std::is_same<T, bf16>::value, T>(
      (const T*)qkv, nullptr, (T*)out, lse, B, S, C, H, 1, scale, false, stream);
}

template <int NT, typename T>
int launch_backward_nt(const T* qkv, const float* lse, const T* g, T* dqkv, float* rowsum,
                       int B, int S, int C, int H, float scale, cudaStream_t stream) {
  const dim3 grid(B, H, (S + ATT_TILE - 1) / ATT_TILE);
  const size_t smem = um::att_smem<T>(S, C / H);
  int rc = um::att_launch(fa_bwd_query_kernel<NT, T>, grid, smem, stream, qkv, lse, g, dqkv,
                          rowsum, S, C, H, scale);
  if (rc) return rc;
  return um::att_launch(fa_bwd_key_kernel<NT, T>, grid,
                        um::att_smem<T>(S, C / H, 2 * 8 * NT * sizeof(float)),
                        stream, qkv, lse, g, (const float*)rowsum, dqkv, S, C, H, scale);
}

template <typename T>
int launch_backward(const void* qkv, const float* lse, const void* g, void* dqkv,
                    float* rowsum, int B, int S, int C, int H, float scale,
                    cudaStream_t stream) {
  const int nt = um::att_tiles(S);
#define UM_BWD(NT)                                                                         \
  launch_backward_nt<NT, T>((const T*)qkv, lse, (const T*)g, (T*)dqkv, rowsum, B, S, C, H, \
                            scale, stream)
  const int rc = nt == 4 ? UM_BWD(4) : nt == 10 ? UM_BWD(10) : UM_BWD(20);
#undef UM_BWD
  return rc;
}

}  // namespace

extern "C" {

// ctx [B*S, C] and lse [B, H, S] (float32) from qkv [B*S, 3C]; qkv and ctx
// bf16 if is_bf16, else float32.
int flash_attention_fwd(const void* qkv, int is_bf16, void* out, float* lse, int B, int S,
                        int C, int H, float scale, void* stream) {
  if (um::att_bad_shape(B, S, C, H)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_forward<bf16>(qkv, out, lse, B, S, C, H, scale, (cudaStream_t)stream);
  return launch_forward<float>(qkv, out, lse, B, S, C, H, scale, (cudaStream_t)stream);
}

// dqkv [B*S, 3C] from qkv, lse and the context gradient g [B*S, C] (qkv's
// type); rowsum is float32 [B, H, S], pass 1's row sums rowsum(dP * P)
// (written, then read by pass 2).
int flash_attention_bwd(const void* qkv, const float* lse, const void* g, int is_bf16,
                        void* dqkv, float* rowsum, int B, int S, int C, int H, float scale,
                        void* stream) {
  if (um::att_bad_shape(B, S, C, H)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_backward<bf16>(qkv, lse, g, dqkv, rowsum, B, S, C, H, scale,
                                 (cudaStream_t)stream);
  return launch_backward<float>(qkv, lse, g, dqkv, rowsum, B, S, C, H, scale,
                                (cudaStream_t)stream);
}

}  // extern "C"
