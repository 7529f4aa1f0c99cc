// K4b: the attention part of K4's backward (the Swin's window-attention
// gradient), on the tensor cores.
//
// Replaces the attention half of _fused_attn_bwd
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:206-235; XLA in the JAX
// package, joined to the Pallas forward by the custom VJP at :238-246).
// ops/kernels.py window_attention_bwd runs, on the card: qkv = x.qkv_w^T +
// b and do = g.proj_w (wa_linear), this kernel, the two weight gradients
// (torch.matmul, as XLA dots in JAX), the bias sums and dx = dqkv.qkv_w
// (wa_linear).
//
// Per (window b, head h) on the packed f32 projection qkv [B*N, 3C] (q | k |
// v, heads contiguous in each) and do [B*N, C], d = C / H:
//   s  = scale*q.k^T + A[b % nW, h]      p = softmax(s) (exact row max/sum)
//   o  = p.v                              dP = do.v^T
//   dV = p^T.do                           dS = p * (dP - rowsum(dP * p))
//   dQ = scale*dS.k                       dK = scale*dS^T.q
// -> dqkv [B*N, 3C] (dQ | dK | dV), the context o [B*N, C] (for d_proj_w)
// and d_addmask [nW, H, N, N] = sum of dS over the windows b = r*nW + v.
// No [B, H, N, N] tensor goes to device memory.
//
// Limits: N <= 32 tokens a window (every Swin window of the repo: 4x5, and
// the padded 3x3 of stage 4), head dim d <= ATT_MAX_D (160).  The wrapper
// raises above them.
//
// Bound: at the Swin's stage 1, b64 (4,096 windows, N 20, C 96, 3 heads)
// the kernel reads qkv and do and writes dqkv and o, 252 MB in f32 (75 us at
// 3.35 TB/s), for 1.9 GFLOP of f32-contract products (11 us at 165 TFLOP/s):
// bytes bind.  The design:
// - one warp per (window, head): 20 tokens fill two 16-row MMA tiles, so a
//   64-row tile per window would be two-thirds padding; the warp's q, k, v
//   and do tiles (rows padded to 16*MT, columns to pad_d(d), zeros) are
//   staged in its own slice of shared memory with cp.async, and every
//   product reads them there: 18 KB a warp at d = 32, three blocks of four
//   warps on each SM;
// - all six products on mma.sync m16n8k8 as 3xTF32 (attention_core.cuh's
//   split_tf32 / mma_3xtf32, rows_step and cols_product), so they keep the
//   f32 contract; s, dP, P and dS stay in registers in the MMA's C-fragment
//   layout, and P^T, then dS^T, replace V in shared memory for dV and dK;
// - padded key columns take -inf before the row max; padded query rows have
//   P = 0 and are neither stored nor summed;
// - d_addmask without float atomics: a warp walks `per` consecutive windows
//   of one (variant, head), summing dS in registers, and writes one partial
//   [N, N] per (window slice, variant, head); a second launch adds the
//   slices in index order.  The plan (per) depends on the shape and the card
//   alone, so two calls give the same bits.

#include <algorithm>

#include "attention_core.cuh"
#include "common.cuh"

namespace {

constexpr int WB_MAX_N = 32;
constexpr int WB_MAX_WARPS = 4;
constexpr int WB_REDUCE_THREADS = 256;

// floats of one staged [16*MT, smem_ld(pad_d(d))] tile
inline size_t wb_tile_floats(int nt, int d) {
  return (size_t)16 * um::win_mtiles(nt) * um::smem_ld<float>(um::pad_d(d));
}

// Ts[key][query] = x[query][key] for the warp's C fragments x (queries
// 16mt + g (+8), keys 8j + 2t (+1))
template <int MT, int NT>
__device__ __forceinline__ void store_transposed(float* Ts, int ld, const float (&x)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* p = Ts + (8 * j + 2 * t) * ld + 16 * mt + g;
      p[0] = x[mt][j][0];
      p[ld] = x[mt][j][1];
      p[8] = x[mt][j][2];
      p[ld + 8] = x[mt][j][3];
    }
}

// the C-fragment layout of rows 16mt + g (+8) of Ts, over the NT k-tiles of
// 8 columns (the A operand of cols_product); rows at or past n read 0
template <int NT>
__device__ __forceinline__ void load_fragment(float (&f)[NT][4], const float* Ts, int ld, int mt,
                                              int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * mt + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    f[j][0] = r0 < n ? Ts[r0 * ld + c] : 0.f;
    f[j][1] = r0 < n ? Ts[r0 * ld + c + 1] : 0.f;
    f[j][2] = r1 < n ? Ts[r1 * ld + c] : 0.f;
    f[j][3] = r1 < n ? Ts[r1 * ld + c + 1] : 0.f;
  }
}

// NT key tiles of 8 (N <= 8 NT), MT = ceil(NT / 2) tiles of 16 query rows.
// Warp w of the grid takes (slice, variant v, head h) = w / (nW H), w / H %
// nW, w % H and the windows b = r*nW + v for r in [slice*per, (slice+1)*per)
// (below reps = B / nW).  partial (null without an addmask) [slices, nW, H,
// N, N].  Three blocks an SM cap a thread at 168 registers, which N <= 24
// fits; N > 24 (four key tiles, no Swin window) takes two.
template <int NT>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, NT == 4 ? 2 : 3)
wa_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
              const float* __restrict__ addmask, float* __restrict__ dqkv,
              float* __restrict__ ctx, float* __restrict__ partial, int N, int C, int H, int nW,
              int reps, int per, int work, float scale) {
  constexpr int MT = um::win_mtiles(NT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= work) return;  // no block barrier below: warps leave on their own
  const int h = w % H, v = (w / H) % nW, slice = w / (H * nW);
  const int d = C / H, dk = um::pad_d(d), ld = um::smem_ld<float>(dk), nks = dk / 8;
  const int rows_pad = 16 * MT, tile = rows_pad * ld;
  float* const Qs = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 4 * tile;
  float* const Ks = Qs + tile;
  float* const Vs = Ks + tile;
  float* const Gs = Vs + tile;  // do
  float* const Ts = Vs;         // P^T, then dS^T, once V is consumed
  const size_t row3 = 3 * (size_t)C;
  const bool pair = d % 2 == 0 && C % 2 == 0;
  const float* am = addmask ? addmask + ((size_t)v * H + h) * N * N : nullptr;
  float dsum[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) dsum[mt][j][0] = dsum[mt][j][1] = dsum[mt][j][2] = dsum[mt][j][3] = 0.f;

  const int r_end = min(reps, (slice + 1) * per);
#pragma unroll 1
  for (int r = slice * per; r < r_end; ++r) {
    const size_t b = (size_t)r * nW + v;
    const float* base = qkv + b * N * row3 + (size_t)h * d;
    const float* gb = dout + b * N * C + (size_t)h * d;
    const bool vec = um::stage_vec(base, row3, d) && um::stage_vec(gb, (size_t)C, d);
    um::warp_stage(Qs, ld, base, row3, N, d, rows_pad, dk, vec);
    um::warp_stage(Ks, ld, base + C, row3, N, d, rows_pad, dk, vec);
    um::warp_stage(Vs, ld, base + 2 * C, row3, N, d, rows_pad, dk, vec);
    um::warp_stage(Gs, ld, gb, (size_t)C, N, d, rows_pad, dk, vec);
    um::cp_async_commit();
    um::cp_async_wait();
    __syncwarp();

    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = dp[mt][j][e] = 0.f;
    um::rows_product<MT, NT>(s, Qs, Ks, ld, nks, scale);  // (q*scale).k^T, as the forward
    um::rows_product<MT, NT>(dp, Gs, Vs, ld, nks, 1.f);   // do.v^T

    // p = softmax(s + A) over each whole row; dS = p * (dP - rowsum(dP * p))
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float add[NT][4];
      um::load_addmask<NT>(add, am, mt, N);
      um::window_softmax<NT>(s[mt], add, mt, N);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          rs0 += dp[mt][j][e] * s[mt][j][e];
          rs1 += dp[mt][j][2 + e] * s[mt][j][2 + e];
        }
      rs0 = um::quad_sum(rs0);
      rs1 = um::quad_sum(rs1);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[mt][j][e] = s[mt][j][e] * (dp[mt][j][e] - rs0);
          dp[mt][j][2 + e] = s[mt][j][2 + e] * (dp[mt][j][2 + e] - rs1);
        }
    }

    float* const orow = ctx + b * N * C + (size_t)h * d;
    float* const drow = dqkv + b * N * row3 + (size_t)h * d;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {  // o = p.v
      const int q0 = 16 * mt + g, q1 = q0 + 8;
      um::cols_product<NT, false>(s[mt], Vs, ld, d, q0 < N ? orow + (size_t)q0 * C : nullptr,
                                  q1 < N ? orow + (size_t)q1 * C : nullptr, pair);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (partial) dsum[mt][j][e] += dp[mt][j][e];
          dp[mt][j][e] *= scale;
        }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {  // dQ = (scale dS).k
      const int q0 = 16 * mt + g, q1 = q0 + 8;
      um::cols_product<NT, false>(dp[mt], Ks, ld, d, q0 < N ? drow + q0 * row3 : nullptr,
                                  q1 < N ? drow + q1 * row3 : nullptr, pair);
    }
    __syncwarp();  // every lane is done with V
    store_transposed<MT, NT>(Ts, ld, s);
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {  // dV = p^T.do
      const int k0 = 16 * mt + g, k1 = k0 + 8;
      float f[NT][4];
      load_fragment<NT>(f, Ts, ld, mt, N);
      um::cols_product<NT, false>(f, Gs, ld, d, k0 < N ? drow + k0 * row3 + 2 * C : nullptr,
                                  k1 < N ? drow + k1 * row3 + 2 * C : nullptr, pair);
    }
    __syncwarp();
    store_transposed<MT, NT>(Ts, ld, dp);
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {  // dK = (scale dS)^T.q
      const int k0 = 16 * mt + g, k1 = k0 + 8;
      float f[NT][4];
      load_fragment<NT>(f, Ts, ld, mt, N);
      um::cols_product<NT, false>(f, Qs, ld, d, k0 < N ? drow + k0 * row3 + C : nullptr,
                                  k1 < N ? drow + k1 * row3 + C : nullptr, pair);
    }
    __syncwarp();  // before the next window's tiles replace these
  }

  if (!partial) return;
  float* const out = partial + (((size_t)slice * nW + v) * H + h) * N * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q0 = 16 * mt + g, q1 = q0 + 8, col = 8 * j + 2 * t + e;
        if (col < N) {
          if (q0 < N) out[q0 * N + col] = dsum[mt][j][e];
          if (q1 < N) out[q1 * N + col] = dsum[mt][j][2 + e];
        }
      }
}

// out[i] = sum over s < slices of partial[s * n + i], in index order
__global__ void __launch_bounds__(WB_REDUCE_THREADS)
wa_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int slices,
                     int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < slices; ++s) acc += partial[(size_t)s * n + i];
    out[i] = acc;
  }
}

template <int NT>
int launch_bwd(const float* qkv, const float* dout, const float* addmask, float* dqkv,
               float* ctx, float* partial, int N, int C, int H, int nW, int reps, int per,
               int work, float scale, cudaStream_t stream) {
  const size_t warp_bytes = 4 * wb_tile_floats(NT, C / H) * sizeof(float);
  const int warps = (int)std::min<size_t>(WB_MAX_WARPS, um::WIN_SMEM_MAX / warp_bytes);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * warp_bytes;
  auto kern = wa_bwd_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(work + warps - 1) / warps, 32 * warps, smem, stream>>>(
      qkv, dout, addmask, dqkv, ctx, partial, N, C, H, nW, reps, per, work, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dqkv [B*N, 3C], ctx [B*N, C] and, when addmask [nW, H, N, N] is given,
// d_addmask [nW, H, N, N] (all float32) from qkv [B*N, 3C] and do [B*N, C];
// window b adds addmask[b % nW].  A warp walks `per` windows of one
// (variant, head); partial [ceil(B / nW / per), nW, H, N, N] holds their dS
// sums until the second launch adds them.  addmask, partial and d_addmask
// are all null or all given.
int wa_attention_bwd(const float* qkv, const float* dout, const float* addmask, float* dqkv,
                     float* ctx, float* partial, float* d_addmask, int B, int N, int C, int H,
                     int nW, int per, float scale, void* stream) {
  if (B <= 0 || N <= 0 || N > WB_MAX_N || H <= 0 || C % H || C / H > um::ATT_MAX_D ||
      nW <= 0 || B % nW || per <= 0 || (addmask == nullptr) != (partial == nullptr) ||
      (addmask == nullptr) != (d_addmask == nullptr))
    return (int)cudaErrorInvalidValue;
  const int reps = B / nW, slices = (reps + per - 1) / per, work = slices * nW * H;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (N + 7) / 8;
#define UM_WB(NT) \
  launch_bwd<NT>(qkv, dout, addmask, dqkv, ctx, partial, N, C, H, nW, reps, per, work, scale, s)
  const int rc = nt == 1 ? UM_WB(1) : nt == 2 ? UM_WB(2) : nt == 3 ? UM_WB(3) : UM_WB(4);
#undef UM_WB
  if (rc || !addmask) return rc;
  const int n = nW * H * N * N;
  wa_bwd_reduce_kernel<<<std::min((n + WB_REDUCE_THREADS - 1) / WB_REDUCE_THREADS, 1024),
                         WB_REDUCE_THREADS, 0, s>>>(partial, d_addmask, slices, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
