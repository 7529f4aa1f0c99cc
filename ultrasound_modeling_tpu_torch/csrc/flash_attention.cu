// K3: flash-style attention core of the train path, forward and backward.
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
// All sums are float32; that is the JAX kernel's dtype contract.
//
// Bound: on the flagship (S = 80, d = 128, 4 heads, B = 32) a (sequence, head)
// does 2*S*S*d = 1.6 MFLOP forward and three times that backward, on 80 KB of
// K/V: next to the qkv/out projections around it this is small, so the first
// version is simple and exact rather than fast (no tensor cores).  One CUDA
// block owns one (sequence, head); the TPU kernel's packing of several
// sequences into one MXU tile with a -1e9 off-diagonal mask (_flash_offdiag
// :568-573, _pick_seqs_per_step :470-485) is dropped.  Sequences up to 160
// fit one pass (no KV loop): each lane of a warp scores up to 5 keys.
//
// Staging: the head's operands sit in shared memory as float32 whatever
// qkv's type: bf16 values convert exactly, every FMA runs in float32 anyway,
// and converting once at staging saves a conversion per FMA.  Rows use the
// odd stride d|1, so lane j reading row j hits its own bank.  The forward
// stages K and V (2*S*(d|1) floats, 82.6 KB at the flagship shape).  Keeping
// q, k, v, g and P/dS resident at once would need 4 * 80*129*4 B + 2 *
// 80*81*4 B = 217 KB in float32 — at the edge of the 227 KB a block may use,
// and out of reach for the ViT's S = d = 160 — so the backward runs in two
// phases in one block: phase 1 stages K and V, walks the query rows (one warp
// per row), writes dq, and stores P and dS (already cast) transposed into a
// float32 scratch in device memory (2*B*H*S*S floats, 6.6 MB at the flagship
// batch, L2-resident); after a block barrier, phase 2 stages Q and G in the
// same shared memory and walks the key rows for dk and dv.

#include "common.cuh"

using um::bf16;

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_MAX_S = 160;  // the ViT's 160 tokens is the longest user
constexpr int FA_MAX_D = 160;  // the ViT's 1280 / 8 heads
constexpr int FA_T = FA_MAX_S / 32;

// rounds a float32 to the precision of T (the casts of the dtype contract)
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) { return um::round_bf16(v); }

// dst[j * ld + c] = src[j * row + c] for j < S, c < d (float32)
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t row, int S, int d,
                                      int ld, float* dst) {
  for (int e = threadIdx.x; e < S * d; e += blockDim.x) {
    const int j = e / d, c = e - j * d;
    dst[j * ld + c] = um::to_f32(src[j * row + c]);
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
fa_forward_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
                  int S, int C, int H, float scale) {
  extern __shared__ float smem[];
  const int seq = blockIdx.x, h = blockIdx.y;
  const int d = C / H, ld = d | 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ks = smem;
  float* Vs = Ks + S * ld;
  float* Qw = Vs + S * ld + warp * (d + S);  // this warp's query row
  float* Pw = Qw + d;                        // this warp's probabilities

  const size_t row3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * S * row3 + (size_t)h * d;
  stage(base + C, row3, S, d, ld, Ks);
  stage(base + 2 * C, row3, S, d, ld, Vs);
  __syncthreads();

  for (int i = warp; i < S; i += FA_WARPS) {
    for (int c = lane; c < d; c += 32) Qw[c] = um::to_f32(base[i * row3 + c]);
    __syncwarp();
    float sc[FA_T];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < FA_T; ++t) {
      const int j = lane + 32 * t;
      sc[t] = j < S ? dot(Qw, Ks + j * ld, d) * scale : -INFINITY;
      mx = fmaxf(mx, sc[t]);
    }
    mx = um::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < FA_T; ++t) {
      sc[t] = (lane + 32 * t < S) ? expf(sc[t] - mx) : 0.f;
      sum += sc[t];
    }
    sum = um::warp_sum(sum);
    if (lane == 0) lse[((size_t)seq * H + h) * S + i] = mx + logf(sum);
#pragma unroll
    for (int t = 0; t < FA_T; ++t) {
      const int j = lane + 32 * t;
      if (j < S) Pw[j] = rnd<T>(sc[t] / sum);
    }
    __syncwarp();
    T* orow = out + ((size_t)seq * S + i) * C + (size_t)h * d;
    for (int c = lane; c < d; c += 32) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(Pw[j], Vs[j * ld + c], a);
      orow[c] = um::from_f32<T>(a);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
fa_backward_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                   const T* __restrict__ g, T* __restrict__ dqkv,
                   float* __restrict__ scratch, int S, int C, int H, float scale) {
  extern __shared__ float smem[];
  const int seq = blockIdx.x, h = blockIdx.y;
  const int d = C / H, ld = d | 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* As = smem;        // phase 1: K, phase 2: Q
  float* Bs = As + S * ld; // phase 1: V, phase 2: G
  float* Qw = Bs + S * ld + warp * (2 * d + 2 * S);  // per warp: a q row,
  float* Gw = Qw + d;                                 // a g row,
  float* Dw = Gw + d;                                 // a dS row / column,
  float* Pw = Dw + S;                                 // a P column

  const size_t bh = (size_t)seq * H + h;
  float* PT = scratch + bh * S * S;                          // P^T  [j][i]
  float* DT = scratch + ((size_t)gridDim.x * H + bh) * S * S; // dS^T [j][i]
  const size_t row3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * S * row3 + (size_t)h * d;
  const T* gbase = g + (size_t)seq * S * C + (size_t)h * d;
  T* dbase = dqkv + (size_t)seq * S * row3 + (size_t)h * d;

  // phase 1: per query row i, P and dS; dq_i = dS_i . K
  stage(base + C, row3, S, d, ld, As);
  stage(base + 2 * C, row3, S, d, ld, Bs);
  __syncthreads();
  for (int i = warp; i < S; i += FA_WARPS) {
    for (int c = lane; c < d; c += 32) {
      Qw[c] = um::to_f32(base[i * row3 + c]);
      Gw[c] = um::to_f32(gbase[(size_t)i * C + c]);
    }
    __syncwarp();
    const float L = lse[bh * S + i];
    float p[FA_T], dp[FA_T];
    float rsum = 0.f;
#pragma unroll
    for (int t = 0; t < FA_T; ++t) {
      const int j = lane + 32 * t;
      p[t] = 0.f;
      dp[t] = 0.f;
      if (j < S) {
        p[t] = expf(dot(Qw, As + j * ld, d) * scale - L);
        dp[t] = dot(Gw, Bs + j * ld, d);
      }
      rsum += dp[t] * p[t];
    }
    rsum = um::warp_sum(rsum);
#pragma unroll
    for (int t = 0; t < FA_T; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        const float ds = rnd<T>(p[t] * (dp[t] - rsum) * scale);
        Dw[j] = ds;
        DT[(size_t)j * S + i] = ds;
        PT[(size_t)j * S + i] = rnd<T>(p[t]);
      }
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(Dw[j], As[j * ld + c], a);
      dbase[i * row3 + c] = um::from_f32<T>(a);
    }
    __syncwarp();
  }
  // every row's P^T and dS^T is written (the barrier orders device-memory
  // accesses within the block too) and K, V are no longer needed
  __syncthreads();

  // phase 2: per key row j, dk_j = dS^T_j . Q and dv_j = P^T_j . G
  stage(base, row3, S, d, ld, As);
  stage(gbase, (size_t)C, S, d, ld, Bs);
  __syncthreads();
  for (int j = warp; j < S; j += FA_WARPS) {
    for (int i = lane; i < S; i += 32) {
      Dw[i] = DT[(size_t)j * S + i];
      Pw[i] = PT[(size_t)j * S + i];
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < S; ++i) {
        dk = fmaf(Dw[i], As[i * ld + c], dk);
        dv = fmaf(Pw[i], Bs[i * ld + c], dv);
      }
      dbase[j * row3 + C + c] = um::from_f32<T>(dk);
      dbase[j * row3 + 2 * C + c] = um::from_f32<T>(dv);
    }
    __syncwarp();
  }
}

bool bad_shape(int B, int S, int C, int H) {
  return B <= 0 || H <= 0 || S <= 0 || C % H || S > FA_MAX_S || C / H > FA_MAX_D;
}

template <typename T>
int launch_forward(const void* qkv, void* out, float* lse, int B, int S, int C, int H,
                   float scale, cudaStream_t stream) {
  const int d = C / H, ld = d | 1;
  const size_t smem = (size_t)(2 * S * ld + FA_WARPS * (d + S)) * sizeof(float);
  auto kern = fa_forward_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, H), FA_THREADS, smem, stream>>>((const T*)qkv, (T*)out, lse, S, C, H,
                                                 scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* qkv, const float* lse, const void* g, void* dqkv,
                    float* scratch, int B, int S, int C, int H, float scale,
                    cudaStream_t stream) {
  const int d = C / H, ld = d | 1;
  const size_t smem = (size_t)(2 * S * ld + FA_WARPS * (2 * d + 2 * S)) * sizeof(float);
  auto kern = fa_backward_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, H), FA_THREADS, smem, stream>>>((const T*)qkv, lse, (const T*)g,
                                                 (T*)dqkv, scratch, S, C, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ctx [B*S, C] and lse [B, H, S] (float32) from qkv [B*S, 3C]; qkv and ctx
// bf16 if is_bf16, else float32.
int flash_attention_fwd(const void* qkv, int is_bf16, void* out, float* lse, int B, int S,
                        int C, int H, float scale, void* stream) {
  if (bad_shape(B, S, C, H)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_forward<bf16>(qkv, out, lse, B, S, C, H, scale, (cudaStream_t)stream);
  return launch_forward<float>(qkv, out, lse, B, S, C, H, scale, (cudaStream_t)stream);
}

// dqkv [B*S, 3C] from qkv, lse and the context gradient g [B*S, C] (qkv's
// type); scratch is float32 [2, B, H, S, S].
int flash_attention_bwd(const void* qkv, const float* lse, const void* g, int is_bf16,
                        void* dqkv, float* scratch, int B, int S, int C, int H,
                        float scale, void* stream) {
  if (bad_shape(B, S, C, H)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_backward<bf16>(qkv, lse, g, dqkv, scratch, B, S, C, H, scale,
                                 (cudaStream_t)stream);
  return launch_backward<float>(qkv, lse, g, dqkv, scratch, B, S, C, H, scale,
                                (cudaStream_t)stream);
}

}  // extern "C"
