// K4b: the attention part of K4's backward (the Swin's window-attention
// gradient), on the tensor cores.
//
// Replaces the attention half of _fused_attn_bwd
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:206-235; XLA in the JAX
// package, joined to the Pallas forward by the custom VJP at :238-246).
// ops/kernels.py window_attention_bwd runs, on the card: qkv = x.qkv_w^T +
// b and do = g.proj_w (wa_linear), this kernel, the weight and bias
// gradients (wa_wgrad, window_attention_wgrad.cu) and dx = dqkv.qkv_w
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
// bytes bind in this count, but the six products are 432 mma.sync a
// (window, head), 1.9x the useful work (32 x 24 tiles for 20 x 20), at
// mma.sync's TF32 rate, and variants timed on the card showed the loads
// alone well under half of the kernel's time: the products and the stores
// take the rest.  The kernel before this one (one window a warp at a time,
// staged and then waited for) took about as long at stages 1-3.  The
// design:
// - one warp per (variant v, head h, slice of windows): it walks the
//   windows b = r*nW + v of its slice (ops/kernels.window_bwd_plan: about
//   one wave of the card's resident warps), and the next window's q, k, v
//   and do tiles are in flight (cp.async into the warp's second buffer)
//   while it computes this one's;
// - a buffer holds 8*NT rows of each tile (the key tiles' rows; N = 20
//   fills 24), row stride pad_d(d) + 4 floats, so every fragment read hits
//   32 banks.  Rows past N are zeroed once and never written by a load;
//   the query side's 16-row MMA tiles read their rows past 8*NT from the
//   block's zero row.  At d = 32 a buffer is 13.8 KB at N 20 (eight warps,
//   one block an SM) and 9.2 KB at N 9 (twelve);
// - all six products on mma.sync m16n8k8 as 3xTF32 (attention_core.cuh's
//   split_tf32 and mma_tf32), so they keep the f32 contract, in three
//   fused pairs that share their loads: s and dP (the row operands q and do
//   against k and v), o and dQ (P and dS in registers against v and k),
//   dV and dK (P^T and dS^T, written over k's and v's tiles once those are
//   consumed, against do and q).  In s and dP each B element is split once
//   for both query tiles; at d = 32 the k-step and column loops unroll;
// - padded key columns take -inf before the row max; padded query rows have
//   P = 0 and are neither stored nor summed;
// - d_addmask without float atomics: a warp sums dS over its windows in
//   registers and writes one partial [N, N] per (window slice, variant,
//   head); a second launch adds the slices in index order.  The plan
//   depends on the shape and the card alone, so two calls give the same
//   bits.

#include <algorithm>

#include "attention_core.cuh"
#include "common.cuh"

namespace {

constexpr int WB_MAX_N = 32;
constexpr int WB_REDUCE_THREADS = 256;

// warps a block (one block an SM) by key tiles: as many as two window
// buffers each fit at d = 32 (ops/kernels.WINDOW_BWD_WARPS mirrors it)
__host__ __device__ constexpr int wb_warps(int nt) { return nt <= 2 ? 12 : nt == 3 ? 8 : 6; }

// c += a.b as 3xTF32 with b split beforehand (attention_core.cuh's
// mma_3xtf32 order: a_lo.b_hi + a_hi.b_lo, then a_hi.b_hi)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bl0,
                                     uint32_t bh1, uint32_t bl1) {
  um::mma_tf32(c, al, bh0, bh1);
  um::mma_tf32(c, ah, bl0, bl1);
  um::mma_tf32(c, ah, bh0, bh1);
}

// the scores layout's columns 8j + 2t (+1) of rows g (+8) as the A operand of
// a product over those columns (cols_f32's permuted k index), split
__device__ __forceinline__ void split_scores(const float (&x)[4], float scale, uint32_t (&h)[4],
                                             uint32_t (&l)[4]) {
  um::split_tf32(x[0] * scale, h[0], l[0]);
  um::split_tf32(x[2] * scale, h[1], l[1]);
  um::split_tf32(x[1] * scale, h[2], l[2]);
  um::split_tf32(x[3] * scale, h[3], l[3]);
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
// 8 columns (the A operand of a column product); rows at or past n read 0
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

// One warp loads rows [0, N) of its head's q, k, v (from the packed qkv rows
// at qkv_w, stride row3) and do (at do_w, stride C) into the buffer's four
// tiles (opf floats apart, row stride ld), dk columns with zeros past d:
// cp.async when vec (completed by the caller's commit and wait), else plain
// copies.  Rows past N are never written.
template <int DK>  // DK: the padded head dim at compile time, or 0
__device__ __forceinline__ void stage_window(float* buf, int opf, int ld, const float* qkv_w,
                                             const float* do_w, size_t row3, int C, int N,
                                             int d, int dk_rt, bool vec) {
  const int lane = threadIdx.x & 31, dk = DK ? DK : dk_rt;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const float* src = o < 3 ? qkv_w + (size_t)o * C : do_w;
    const size_t stride = o < 3 ? row3 : (size_t)C;
    float* dst = buf + o * opf;
    if (vec) {
      const int nch = dk / 4;
      for (int e = lane; e < N * nch; e += 32) {
        const int r = e / nch, c = (e - r * nch) * 4;
        const bool in = c < d;
        um::cp_async16(dst + r * ld + c, in ? (const void*)(src + r * stride + c) : (const void*)src,
                       in ? 16 : 0);
      }
    } else {
      for (int e = lane; e < N * dk; e += 32) {
        const int r = e / dk, c = e - r * dk;
        dst[r * ld + c] = c < d ? src[r * stride + c] : 0.f;
      }
    }
  }
}

// NT key tiles of 8 (N <= 8 NT), MT = ceil(NT / 2) tiles of 16 query rows;
// D32: d == 32 (every Swin stage), the k-step and column loops unrolled.
// Warp w of the grid takes (slice, variant v, head h) = w / (nW H), w / H %
// nW, w % H and the windows b = r*nW + v for r in [slice*per, (slice+1)*per)
// (below reps = B / nW).  partial (null without an addmask) [slices, nW, H,
// N, N].
template <int NT, bool D32>
__global__ void __launch_bounds__(32 * wb_warps(NT), 1)
wa_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
              const float* __restrict__ addmask, float* __restrict__ dqkv,
              float* __restrict__ ctx, float* __restrict__ partial, int N, int C, int H, int nW,
              int reps, int per, int work, float scale) {
  constexpr int MT = um::win_mtiles(NT), KR = 8 * NT, DK = D32 ? 32 : 0;
  extern __shared__ __align__(16) float sm[];  // the zero row, then each warp's two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = C / H, dk = D32 ? 32 : um::pad_d(d), ld = dk + 4, nks = dk / 8;
  const int opf = KR * ld, warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < ld + warps * 8 * opf; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  const int w = blockIdx.x * warps + warp;
  if (w >= work) return;  // no block barrier below: warps leave on their own
  const int h = w % H, v = (w / H) % nW, slice = w / (H * nW);
  float* const bufs = sm + ld + (size_t)warp * 8 * opf;
  const size_t row3 = 3 * (size_t)C;
  const bool pair = d % 2 == 0 && C % 2 == 0;
  const float* am = addmask ? addmask + ((size_t)v * H + h) * N * N : nullptr;
  float dsum[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[mt][j][e] = 0.f;

  const int r_begin = slice * per, r_end = min(reps, r_begin + per);
  auto qkv_of = [&](int r) { return qkv + ((size_t)r * nW + v) * N * row3 + (size_t)h * d; };
  auto do_of = [&](int r) { return dout + ((size_t)r * nW + v) * N * C + (size_t)h * d; };
  const bool vec = um::stage_vec(qkv, row3, d) && um::stage_vec(dout, (size_t)C, d);
  stage_window<DK>(bufs, opf, ld, qkv_of(r_begin), do_of(r_begin), row3, C, N, d, dk, vec);
  um::cp_async_commit();
#pragma unroll 1
  for (int r = r_begin; r < r_end; ++r) {
    float* const Qs = bufs + ((r - r_begin) & 1) * 4 * opf;
    float* const Ks = Qs + opf;
    float* const Vs = Ks + opf;
    float* const Gs = Vs + opf;  // do
    if (r + 1 < r_end)  // the next window into the other buffer, consumed two windows ago
      stage_window<DK>(bufs + (((r - r_begin) & 1) ^ 1) * 4 * opf, opf, ld, qkv_of(r + 1),
                       do_of(r + 1), row3, C, N, d, dk, vec);
    um::cp_async_commit();
    um::cp_async_wait_but<1>();  // this window's group has landed
    __syncwarp();

    // s = (q*scale).k^T (as the forward) and dP = do.v^T; the query side's
    // rows past 8*NT read the zero row
    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = dp[mt][j][e] = 0.f;
    const float* qa[MT][2];
    const float* ga[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = 16 * mt + 8 * u + g;
        qa[mt][u] = row < KR ? Qs + row * ld + t : sm + t;
        ga[mt][u] = row < KR ? Gs + row * ld + t : sm + t;
      }
#pragma unroll
    for (int ks = 0; ks < nks; ++ks) {
      const int c = 8 * ks;
      uint32_t qh[MT][4], ql[MT][4], gh[MT][4], gl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float aq[4] = {qa[mt][0][c], qa[mt][1][c], qa[mt][0][c + 4], qa[mt][1][c + 4]};
        const float ag[4] = {ga[mt][0][c], ga[mt][1][c], ga[mt][0][c + 4], ga[mt][1][c + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          um::split_tf32(aq[i] * scale, qh[mt][i], ql[mt][i]);
          um::split_tf32(ag[i], gh[mt][i], gl[mt][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = Ks + (8 * j + g) * ld + c + t;
        const float* vr = Vs + (8 * j + g) * ld + c + t;
        uint32_t kh0, kl0, kh1, kl1, vh0, vl0, vh1, vl1;
        um::split_tf32(kr[0], kh0, kl0);
        um::split_tf32(kr[4], kh1, kl1);
        um::split_tf32(vr[0], vh0, vl0);
        um::split_tf32(vr[4], vh1, vl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma3(s[mt][j], qh[mt], ql[mt], kh0, kl0, kh1, kl1);
          mma3(dp[mt][j], gh[mt], gl[mt], vh0, vl0, vh1, vl1);
        }
      }
    }

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
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (partial) dsum[mt][j][e] += dp[mt][j][e];
          dp[mt][j][e] *= scale;
        }

    // o = p.v and dQ = (scale dS).k, by 32-column passes over the head dim
    const size_t b = (size_t)r * nW + v;
    float* const orow = ctx + b * N * C + (size_t)h * d;
    float* const drow = dqkv + b * N * row3 + (size_t)h * d;
    const int nd = dk / 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int q0 = 16 * mt + g, q1 = q0 + 8;
#pragma unroll
      for (int n0 = 0; n0 < nd; n0 += um::ATT_NO) {
        float o[um::ATT_NO][4] = {}, dq[um::ATT_NO][4] = {};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ph[4], pl[4], sh[4], sl[4];
          split_scores(s[mt][j], 1.f, ph, pl);
          split_scores(dp[mt][j], 1.f, sh, sl);
          const float* vb = Vs + (8 * j + 2 * t) * ld + 8 * n0 + g;
          const float* kb = Ks + (8 * j + 2 * t) * ld + 8 * n0 + g;
#pragma unroll
          for (int cc = 0; cc < um::ATT_NO; ++cc) {
            uint32_t bh0, bl0, bh1, bl1;
            um::split_tf32(vb[8 * cc], bh0, bl0);
            um::split_tf32(vb[ld + 8 * cc], bh1, bl1);
            mma3(o[cc], ph, pl, bh0, bl0, bh1, bl1);
            um::split_tf32(kb[8 * cc], bh0, bl0);
            um::split_tf32(kb[ld + 8 * cc], bh1, bl1);
            mma3(dq[cc], sh, sl, bh0, bl0, bh1, bl1);
          }
        }
#pragma unroll
        for (int cc = 0; cc < um::ATT_NO; ++cc) {
          const int col = 8 * (n0 + cc) + 2 * t;
          if (q0 < N) {
            um::store2(orow + (size_t)q0 * C, col, d, pair, o[cc][0], o[cc][1]);
            um::store2(drow + q0 * row3, col, d, pair, dq[cc][0], dq[cc][1]);
          }
          if (q1 < N) {
            um::store2(orow + (size_t)q1 * C, col, d, pair, o[cc][2], o[cc][3]);
            um::store2(drow + q1 * row3, col, d, pair, dq[cc][2], dq[cc][3]);
          }
        }
      }
    }

    // dV = p^T.do and dK = (scale dS)^T.q: P^T over k's tile, dS^T over v's
    __syncwarp();  // every lane is done with k and v
    store_transposed<MT, NT>(Ks, ld, s);
    store_transposed<MT, NT>(Vs, ld, dp);
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int k0 = 16 * mt + g, k1 = k0 + 8;
      float fp[NT][4], fs[NT][4];
      load_fragment<NT>(fp, Ks, ld, mt, N);
      load_fragment<NT>(fs, Vs, ld, mt, N);
#pragma unroll
      for (int n0 = 0; n0 < nd; n0 += um::ATT_NO) {
        float dv[um::ATT_NO][4] = {}, dk_[um::ATT_NO][4] = {};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ph[4], pl[4], sh[4], sl[4];
          split_scores(fp[j], 1.f, ph, pl);
          split_scores(fs[j], 1.f, sh, sl);
          const float* gb = Gs + (8 * j + 2 * t) * ld + 8 * n0 + g;
          const float* qb = Qs + (8 * j + 2 * t) * ld + 8 * n0 + g;
#pragma unroll
          for (int cc = 0; cc < um::ATT_NO; ++cc) {
            uint32_t bh0, bl0, bh1, bl1;
            um::split_tf32(gb[8 * cc], bh0, bl0);
            um::split_tf32(gb[ld + 8 * cc], bh1, bl1);
            mma3(dv[cc], ph, pl, bh0, bl0, bh1, bl1);
            um::split_tf32(qb[8 * cc], bh0, bl0);
            um::split_tf32(qb[ld + 8 * cc], bh1, bl1);
            mma3(dk_[cc], sh, sl, bh0, bl0, bh1, bl1);
          }
        }
#pragma unroll
        for (int cc = 0; cc < um::ATT_NO; ++cc) {
          const int col = 8 * (n0 + cc) + 2 * t;
          if (k0 < N) {
            um::store2(drow + k0 * row3 + 2 * C, col, d, pair, dv[cc][0], dv[cc][1]);
            um::store2(drow + k0 * row3 + C, col, d, pair, dk_[cc][0], dk_[cc][1]);
          }
          if (k1 < N) {
            um::store2(drow + k1 * row3 + 2 * C, col, d, pair, dv[cc][2], dv[cc][3]);
            um::store2(drow + k1 * row3 + C, col, d, pair, dk_[cc][2], dk_[cc][3]);
          }
        }
      }
    }
    __syncwarp();  // before this buffer takes the window after next
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

template <int NT, bool D32>
int launch_bwd(const float* qkv, const float* dout, const float* addmask, float* dqkv,
               float* ctx, float* partial, int N, int C, int H, int nW, int reps, int per,
               int work, float scale, cudaStream_t stream) {
  const int ld = (D32 ? 32 : um::pad_d(C / H)) + 4;
  const size_t warp_floats = 8 * (size_t)(8 * NT) * ld;  // two buffers of four tiles
  const int warps = (int)std::min<size_t>(wb_warps(NT),
                                          (um::WIN_SMEM_MAX / sizeof(float) - ld) / warp_floats);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (ld + warps * warp_floats) * sizeof(float);
  auto kern = wa_bwd_kernel<NT, D32>;
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
  const bool d32 = C / H == 32;
#define UM_WB(NT)                                                                            \
  (d32 ? launch_bwd<NT, true>(qkv, dout, addmask, dqkv, ctx, partial, N, C, H, nW, reps, per, \
                              work, scale, s)                                                 \
       : launch_bwd<NT, false>(qkv, dout, addmask, dqkv, ctx, partial, N, C, H, nW, reps, per, \
                               work, scale, s))
  const int rc = nt == 1 ? UM_WB(1) : nt == 2 ? UM_WB(2) : nt == 3 ? UM_WB(3) : UM_WB(4);
#undef UM_WB
  if (rc || !addmask) return rc;
  const int n = nW * H * N * N;
  wa_bwd_reduce_kernel<<<std::min((n + WB_REDUCE_THREADS - 1) / WB_REDUCE_THREADS, 1024),
                         WB_REDUCE_THREADS, 0, s>>>(partial, d_addmask, slices, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
