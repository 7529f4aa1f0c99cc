// Attention core on the tensor cores, shared by K1 (transformer_block.cu),
// K4 (window_attention.cu), K5 (attention_train.cu) and K3's forward
// (flash_attention.cu), and the tile products that K3's backward builds on.
//
// Replaces the per-head score/softmax/PV part of the Pallas kernel bodies
// _tblock_kernel, _window_attn_kernel, _attn_train_kernel and
// _flash_core_fwd_kernel (ultrasound_modeling_tpu/ops/pallas_kernels.py).
// The TPU kernels packed several sequences into one [T*S, T*S] MXU matmul
// with a -1e9 off-block mask; here nothing is packed.
//
// Per (sequence, head, tile of 64 query rows) on the packed projection
// qkv [B*S, 3C] (q | k | v, heads contiguous in each), with d = C / H:
//   ctx = softmax(s) . v,  s = (q*scale) . k^T + A  or  s = (q . k^T) * scale
//
// Bound: at the ViT serving shape (b64, S = d = 160, 8 heads) a layer's core
// reads 157 MB of f32 qkv and writes the context (26 MB bf16, 52 MB f32) for
// 8.4 GFLOP of products: bytes bind, 55-62 us at 3.35 TB/s.  The design:
// - grid (sequence, head, query tile), four warps of 16 query rows each:
//   1,536 blocks at ViT b64, two blocks on each SM at S = d = 160;
// - both products on the tensor cores with mma.sync (m16n8k8 TF32 and
//   m16n8k16 bf16, f32 accumulators);
// - a warp's 16 x S score tile stays in registers (S <= 160: 80 f32 a lane),
//   so the row max and sum are exact over the whole row, as the TPU kernel's
//   softmax is, with no online rescaling;
// - K of the head is staged in shared memory with cp.async while the warps
//   fetch their first query fragments; V replaces K once the scores are in
//   registers, its copy in flight during the softmax (105 KB at S = d = 160
//   in f32).  Query rows stream from device memory four k-steps ahead.
// - Row strides in shared memory (d + 4 floats, d + 8 bf16) make every
//   fragment read below free of bank conflicts.
//
// Numeric contracts (all sums float32):
// - operands that are float32 in the contract (every score of K1, K4 and K5,
//   whose projection is f32; P.V in K4 and K5; everything in K3 f32) take a
//   three-term split on the tensor cores, a = a_hi + a_lo with a_hi and a_lo
//   TF32: a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (3xTF32), which keeps
//   near-f32 accuracy where plain TF32 would not;
// - operands that are bf16 in the contract use bf16 MMAs: K1's P.V (P and V
//   rounded to bf16, _tblock_kernel:749-752; V is staged in f32 and rounded
//   as its fragments are built), K3 bf16's q.k^T (bf16 inputs: exact
//   products) and its P.V with P rounded;
// - K5 also writes P [B, H, S, S] and, under bf16, a rounded qkv copy, in
//   the train dtype, from registers and shared memory; K3 writes the f32 row
//   LSE [B, H, S].
#pragma once

#include <type_traits>

#include "common.cuh"

namespace um {

constexpr int ATT_WARPS = 4;
constexpr int ATT_THREADS = 32 * ATT_WARPS;
constexpr int ATT_TILE = 16 * ATT_WARPS;  // query (or key) rows of a block
constexpr int ATT_MAX_S = 160;            // ViT's 160 tokens is the longest user
constexpr int ATT_MAX_D = 160;            // ViT's 1280 / 8 heads
constexpr int ATT_NO = 4;                 // output n-tiles (8 columns) per pass

// Head dims are padded to 32 columns (zeros in shared memory, zero rows of
// A), so that every loop over k-steps and n-tiles runs whole, unguarded.
__host__ __device__ constexpr int pad_d(int d) { return (d + 31) & ~31; }

// Key tiles (8 keys) a kernel is built for: S <= 32, 80 or 160.  Rows from S
// up to 8 * NT are staged as zeros, so the tile loops need no guards either
// (a guarded tile becomes a branch per MMA, which serializes them).
inline int att_tiles(int S) { return S <= 32 ? 4 : S <= 80 ? 10 : 20; }

// Row stride of a [rows][dk] operand in shared memory: dk + 4 floats
// (== 4 mod 32 words) or dk + 8 bf16 (an odd multiple of 16 bytes).  Reads
// of a row operand b[row g][k + t] and of a column operand b[k + 2t][n + g]
// (f32), and ldmatrix rows (bf16), then hit 32 banks.
template <typename T> __host__ __device__ constexpr int smem_ld(int dk) {
  return std::is_same<T, float>::value ? dk + 4 : dk + 8;
}

// ---- tensor-core and copy primitives ----

// x = hi + lo exactly, hi the top 11 significant bits (a TF32 value), lo
// the rest; the tensor core reads lo's top 11 bits (it ignores a TF32
// operand's low 13), so lo loses at most 2^-10 of itself, 2^-20 of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b at near-f32 accuracy: a_lo.b_hi + a_hi.b_lo, then a_hi.b_hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded (to nearest even) into one bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s)
               : "memory");
}

// 16 bytes device -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// waits until at most n of this thread's committed groups are in flight
template <int n> __device__ __forceinline__ void cp_async_wait_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// keeps the compiler from hoisting work on v out of a loop (a register
// barrier: v is "changed" here at no cost)
__device__ __forceinline__ void reg_fence(float& v) { asm volatile("" : "+f"(v)); }

// ---- staging a [rows, cols] slice of device memory into shared memory ----

// True when every 16-byte chunk of a slice with row stride `stride` and
// `cols` columns from `p` is aligned, so stage() may copy with cp.async.
template <typename T>
__device__ __forceinline__ bool stage_vec(const T* p, size_t stride, int cols) {
  constexpr int E = 16 / sizeof(T);
  return cols % E == 0 && stride % E == 0 && ((uintptr_t)p % 16) == 0;
}

// dst[r * ld + c] = src[r * stride + c] for r < rows, c < cols, and 0 up to
// rows_pad x cols_pad (cols_pad % 16 == 0).  vec (stage_vec): cp.async,
// completed by cp_async_commit(), cp_async_wait() and a block barrier;
// otherwise plain copies, completed by the barrier.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, size_t stride, int rows,
                                      int cols, int rows_pad, int cols_pad, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int nch = cols_pad / E;
    for (int e = threadIdx.x; e < rows_pad * nch; e += blockDim.x) {
      const int r = e / nch, c = (e - r * nch) * E;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld + c, in ? (const void*)(src + r * stride + c) : (const void*)src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols_pad; e += blockDim.x) {
      const int r = e / cols_pad, c = e - r * cols_pad;
      dst[r * ld + c] = (r < rows && c < cols) ? src[r * stride + c] : from_f32<T>(0.f);
    }
  }
}

// ---- a row operand's A fragments, fetched from device memory ----
//
// A warp multiplies 16 rows (g and g + 8 of each lane; g = lane / 4,
// t = lane % 4): r0 and r1 point at those rows (null reads as a zero row),
// d columns.  One k-step is 8 columns (f32, m16n8k8) or 16 (bf16,
// m16n8k16); a fragment is 4 registers.

template <typename T> struct KStep;
template <> struct KStep<float> { static constexpr int W = 8; };
template <> struct KStep<bf16> { static constexpr int W = 16; };

__device__ __forceinline__ void load_a(const float* r0, const float* r1, int d, int ks,
                                       uint32_t (&v)[4]) {
  const int c = 8 * ks + (threadIdx.x & 3);  // past d (or past the last k-step) reads 0
  v[0] = __float_as_uint((r0 && c < d) ? r0[c] : 0.f);
  v[1] = __float_as_uint((r1 && c < d) ? r1[c] : 0.f);
  v[2] = __float_as_uint((r0 && c + 4 < d) ? r0[c + 4] : 0.f);
  v[3] = __float_as_uint((r1 && c + 4 < d) ? r1[c + 4] : 0.f);
}

__device__ __forceinline__ void load_a(const bf16* r0, const bf16* r1, int d, int ks,
                                       uint32_t (&v)[4]) {
  const int c = 16 * ks + 2 * (threadIdx.x & 3);
  auto u = [&](const bf16* p, int i) -> uint32_t {
    return (p && i < d) ? (uint32_t)__bfloat16_as_ushort(p[i]) : 0u;
  };
  v[0] = u(r0, c) | (u(r0, c + 1) << 16);
  v[1] = u(r1, c) | (u(r1, c + 1) << 16);
  v[2] = u(r0, c + 8) | (u(r0, c + 9) << 16);
  v[3] = u(r1, c + 8) | (u(r1, c + 9) << 16);
}

// acc[j] += A(k-step ks) . B[8j .. 8j+8, k-step ks]^T for j < NT: B in
// shared memory [rows][ld] (the row operand).  f32: A times a_scale, then
// 3xTF32.
template <int NT>
__device__ __forceinline__ void rows_step(float (&acc)[NT][4], const uint32_t (&a)[4],
                                          float a_scale, const float* Bs, int ld, int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]) * a_scale, ah[i], al[i]);
  const float* b = Bs + g * ld + 8 * ks + t;
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_3xtf32(acc[j], ah, al, b[8 * j * ld], b[8 * j * ld + 4]);
}

// bf16 (exact products; a_scale must be 1)
template <int NT>
__device__ __forceinline__ void rows_step(float (&acc)[NT][4], const uint32_t (&a)[4], float,
                                          const bf16* Bs, int ld, int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* b = Bs + g * ld + 16 * ks + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(b + 8 * j * ld),
             *reinterpret_cast<const uint32_t*>(b + 8 * j * ld + 8));
}

// The A rows of a product, streamed from device memory 64 columns ahead:
// start() issues the first loads (before the caller waits on its staging),
// run() does the whole product acc = A . B^T over the padded head dim.  A
// half-ring is 32 columns, so whole half-rings cover the padded dim.
template <typename T>
struct RowStream {
  static constexpr int HALF = 32 / KStep<T>::W;  // k-steps in 32 columns
  const T* r0;
  const T* r1;
  int d, nks;
  uint32_t ring[2 * HALF][4];

  __device__ __forceinline__ void start(const T* p0, const T* p1, int d_) {
    r0 = p0;
    r1 = p1;
    d = d_;
    nks = pad_d(d_) / KStep<T>::W;
#pragma unroll
    for (int p = 0; p < 2 * HALF; ++p) load_a(r0, r1, p < nks ? d : 0, p, ring[p]);
  }

  template <int NT>
  __device__ __forceinline__ void run(float (&acc)[NT][4], float a_scale, const T* Bs,
                                      int ld) {
#pragma unroll 1
    for (int k0 = 0; k0 < nks; k0 += 2 * HALF) {
#pragma unroll
      for (int p = 0; p < 2 * HALF; ++p) {
        const int ks = k0 + p;
        if (p < HALF || ks < nks) {  // the second half-ring may be past the end
          const uint32_t a[4] = {ring[p][0], ring[p][1], ring[p][2], ring[p][3]};
          load_a(r0, r1, ks + 2 * HALF < nks ? d : 0, ks + 2 * HALF, ring[p]);
          rows_step<NT>(acc, a, a_scale, Bs, ld, ks);
        }
      }
    }
  }
};

// ---- per-window kernels (one warp per window and head: K4's forward core
// at N <= 32 in window_attention.cu, its backward in window_attention_bwd.cu) ----

// 16-row MMA tiles of N rows
__host__ __device__ constexpr int win_mtiles(int nt) { return (nt + 1) / 2; }

constexpr int WIN_SMEM_MAX = 232448;  // a block's dynamic shared memory on sm_90

// One warp stages src[r * stride + c] (r < rows, c < d) into dst[r * ld + c]
// and zeros up to rows_pad x dk: cp.async when vec (completed by the
// caller's commit, wait and __syncwarp), else plain copies.
__device__ __forceinline__ void warp_stage(float* dst, int ld, const float* src, size_t stride,
                                           int rows, int d, int rows_pad, int dk, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    const int nch = dk / 4;
    for (int e = lane; e < rows_pad * nch; e += 32) {
      const int r = e / nch, c = (e - r * nch) * 4;
      const bool in = r < rows && c < d;
      cp_async16(dst + r * ld + c, in ? (const void*)(src + r * stride + c) : (const void*)src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = lane; e < rows_pad * dk; e += 32) {
      const int r = e / dk, c = e - r * dk;
      dst[r * ld + c] = (r < rows && c < d) ? src[r * stride + c] : 0.f;
    }
  }
}

// acc[mt][j] += (a_scale * A[16mt .. 16mt+16, :]) . B[8j .. 8j+8, :]^T over
// nks k-steps of 8 columns: A and B row operands in shared memory [rows][ld]
template <int MT, int NT>
__device__ __forceinline__ void rows_product(float (&acc)[MT][NT][4], const float* As,
                                             const float* Bs, int ld, int nks, float a_scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = As + (16 * mt + g) * ld + 8 * ks + t;
      const uint32_t v[4] = {__float_as_uint(a[0]), __float_as_uint(a[8 * ld]),
                             __float_as_uint(a[4]), __float_as_uint(a[8 * ld + 4])};
      rows_step<NT>(acc[mt], v, a_scale, Bs, ld, ks);
    }
  }
}

// ---- products with A in registers (the scores layout) ----
//
// Scores layout (mma's C fragment): acc[j] holds rows g and g + 8 at columns
// 8j + 2t and 8j + 2t + 1: acc[j][0], acc[j][1] (row g), acc[j][2],
// acc[j][3] (row g + 8).
//
// o[c] += P[16, keys] . B[keys, 8(n0 + c) .. +8] for c < ATT_NO (n-tiles),
// over the keys of the tiles j < NT: B in shared memory [keys][ld] (the
// column operand).

// f32 B: 3xTF32 on m16n8k8, whose k index is permuted so that each lane's
// two score columns feed it as they are (A column t <-> key 8j + 2t, column
// t + 4 <-> key 8j + 2t + 1)
template <int NT>
__device__ __forceinline__ void cols_f32(float (&o)[ATT_NO][4], const float (&p)[NT][4],
                                         const float* Bs, int ld, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const float* b = Bs + (8 * j + 2 * t) * ld + 8 * n0 + g;
#pragma unroll
    for (int c = 0; c < ATT_NO; ++c) mma_3xtf32(o[c], ah, al, b[8 * c], b[ld + 8 * c]);
  }
}

// P rounded to bf16 times B rounded to bf16 on m16n8k16, B staged in f32
// (K1's P.V: V from the f32 projection, rounded as its fragments are built)
template <int NT>
__device__ __forceinline__ void cols_bf16_of_f32(float (&o)[ATT_NO][4], const float (&p)[NT][4],
                                                 const float* Bs, int ld, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const float* b = Bs + (16 * j + 2 * t) * ld + 8 * n0 + g;
#pragma unroll
    for (int c = 0; c < ATT_NO; ++c)
      mma_bf16(o[c], a, pack_bf16(b[8 * c], b[ld + 8 * c]),
               pack_bf16(b[8 * ld + 8 * c], b[9 * ld + 8 * c]));
  }
}

// bf16 B: P rounded to bf16, m16n8k16 with B's fragments by ldmatrix.trans
template <int NT>
__device__ __forceinline__ void cols_bf16(float (&o)[ATT_NO][4], const float (&p)[NT][4],
                                          const bf16* Bs, int ld, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const bf16* b = Bs + (16 * j + (lane & 15)) * ld + 8 * n0;
#pragma unroll
    for (int c = 0; c < ATT_NO; ++c) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, b + 8 * c);
      mma_bf16(o[c], a, b0, b1);
    }
  }
}

// The product by B's type: f32 B under 3xTF32 unless BF16_OPS (then P and
// B rounded to bf16), bf16 B always on bf16 MMAs (P rounded).
template <int NT, bool BF16_OPS>
__device__ __forceinline__ void cols_step(float (&o)[ATT_NO][4], const float (&p)[NT][4],
                                          const float* Bs, int ld, int n0) {
  if (BF16_OPS)
    cols_bf16_of_f32<NT>(o, p, Bs, ld, n0);
  else
    cols_f32<NT>(o, p, Bs, ld, n0);
}

template <int NT, bool BF16_OPS>
__device__ __forceinline__ void cols_step(float (&o)[ATT_NO][4], const float (&p)[NT][4],
                                          const bf16* Bs, int ld, int n0) {
  cols_bf16<NT>(o, p, Bs, ld, n0);
}

// stores two neighbouring values of a row (columns col, col + 1) where they
// are below lim; pair: both columns' addresses are 2-element aligned
template <typename T>
__device__ __forceinline__ void store2(T* row, int col, int lim, bool pair, float a, float b) {
  if (pair && col + 1 < lim) {
    if (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
    else
      *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(a, b);
    return;
  }
  if (col < lim) row[col] = from_f32<T>(a);
  if (col + 1 < lim) row[col + 1] = from_f32<T>(b);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// The whole column product P . B -> rows o0, o1 (null: not written), d
// columns, ATT_NO n-tiles a pass over the padded head dim.  The register
// fence keeps P's per-pass conversions inside the loop (hoisted, they would
// take 160 registers more).
template <int NT, bool BF16_OPS, typename TB, typename TOut>
__device__ __forceinline__ void cols_product(float (&p)[NT][4], const TB* Bs, int ld, int d,
                                             TOut* o0, TOut* o1, bool pair) {
  const int t = threadIdx.x & 3, nd = pad_d(d) / 8;
#pragma unroll 1
  for (int n0 = 0; n0 < nd; n0 += ATT_NO) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(p[j][e]);
    float o[ATT_NO][4] = {};
    cols_step<NT, BF16_OPS>(o, p, Bs, ld, n0);
#pragma unroll
    for (int c = 0; c < ATT_NO; ++c) {
      const int col = 8 * (n0 + c) + 2 * t;
      if (o0) store2(o0, col, d, pair, o[c][0], o[c][1]);
      if (o1) store2(o1, col, d, pair, o[c][2], o[c][3]);
    }
  }
}

// sum (or max) over the four lanes that share a row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The additive matrix's values for the warp's query tile mt in the scores
// layout (below): add[j][e] (row 16mt + g) and add[j][2 + e] (row 16mt + g +
// 8) at key column 8j + 2t + e of the window's [N, N] matrix am; 0 where am
// is null or the row or column is at or past N.  Loaded ahead of the
// product that needs them, so their latency hides under it.
template <int NT>
__device__ __forceinline__ void load_addmask(float (&add)[NT][4], const float* am, int mt,
                                             int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = 16 * mt + g, q1 = q0 + 8;
  const float* a0 = am && q0 < N ? am + (size_t)q0 * N : nullptr;
  const float* a1 = am && q1 < N ? am + (size_t)q1 * N : nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      add[j][e] = a0 && col < N ? a0[col] : 0.f;
      add[j][2 + e] = a1 && col < N ? a1[col] : 0.f;
    }
}

// p = softmax(s + add) over each whole row of the warp's query tile mt, in
// the scores layout (below): rows 16mt + g (+8), key columns 8j + 2t (+1);
// add from load_addmask.  Key columns at or past N take -inf before the row
// max, so their p is 0; query rows at or past N get p = 0 (they are neither
// stored nor summed).
template <int NT>
__device__ __forceinline__ void window_softmax(float (&s)[NT][4], const float (&add)[NT][4],
                                               int mt, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = 16 * mt + g, q1 = q0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (col < N) {
        v0 = s[j][e] + add[j][e];
        v1 = s[j][2 + e] + add[j][2 + e];
      }
      s[j][e] = v0;
      s[j][2 + e] = v1;
      m0 = fmaxf(m0, v0);
      m1 = fmaxf(m1, v1);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - m0);
      s[j][2 + e] = expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = q0 < N ? 1.f / l0 : 0.f, i1 = q1 < N ? 1.f / l1 : 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] *= i0;
      s[j][2 + e] *= i1;
    }
}

// dst = src in TSave at rows [r0, r0 + rows) and columns c, C + c, 2C + c
// for c < d (the q, k and v columns of a head), row stride row3; each
// thread has four 16-byte loads in flight before it stores
template <typename TSave, typename TIn>
__device__ __forceinline__ void save_rows(TSave* __restrict__ dst, const TIn* __restrict__ src,
                                          size_t row3, int C, int d, int r0, int rows) {
  constexpr int U = 4;
  const bool vec = d % 4 == 0 && C % 4 == 0 && std::is_same<TIn, float>::value &&
                   ((uintptr_t)src % 16) == 0 && ((uintptr_t)dst % (4 * sizeof(TSave))) == 0;
  const int per = vec ? d / 4 : d, w = vec ? 4 : 1, n = rows * 3 * per;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * blockDim.x) {
    float v[U][4];
    size_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / (3 * per), rest = e - r * 3 * per, part = rest / per;
      at[u] = (size_t)(r0 + r) * row3 + (size_t)part * C + (size_t)w * (rest - part * per);
      if (e < n) {
        if (vec) {
          const float4 x = *reinterpret_cast<const float4*>(src + at[u]);
          v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
        } else {
          v[u][0] = to_f32(src[at[u]]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u * blockDim.x < n) {
        if (vec)
          store4(dst + at[u], v[u]);
        else
          dst[at[u]] = from_f32<TSave>(v[u][0]);
      }
    }
  }
}

// ---- the forward core ----
//
// TIn: qkv's type (float, or bf16 for K3 bf16); K and V are staged in it.
// PV_BF16: P and V rounded to bf16 for P.V (K1; implied by a bf16 TIn).
// scale_q: s = (q*scale).k^T (K1, K4, K5) rather than (q.k^T)*scale (K3).
// addmask (may be null) [nW, H, S, S], sequence b adding addmask[b % nW].
// lse (may be null): the f32 row log-sum-exp [B, H, S].  p_save (may be
// null): P [B, H, S, S] in TSave.  qkv_save (may be null): qkv in TSave, the
// same [B*S, 3C] layout; each block writes the head's q, k and v columns of
// its query rows, so the grid covers the tensor once.
template <int NT, typename TIn, bool PV_BF16, typename TOut, typename TSave>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attention_fwd_kernel(const TIn* __restrict__ qkv, const float* __restrict__ addmask,
                     TOut* __restrict__ out, float* __restrict__ lse,
                     TSave* __restrict__ p_save, TSave* __restrict__ qkv_save, int S, int C,
                     int H, int nW, float scale, int scale_q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* const Bs = reinterpret_cast<TIn*>(smem_raw);
  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * ATT_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = C / H, dk = pad_d(d), Sp = 8 * NT;
  const int ld = smem_ld<TIn>(dk);
  const size_t row3 = 3 * (size_t)C, bh = (size_t)seq * H + h;
  const TIn* base = qkv + (size_t)seq * S * row3 + (size_t)h * d;
  const bool vec = stage_vec(base, row3, d);

  stage(Bs, ld, base + C, row3, S, d, Sp, dk, vec);  // K
  cp_async_commit();
  const int rw = q0 + warp * 16;  // this warp's first query row
  const bool active = rw < S;
  const int r0 = rw + g, r1 = r0 + 8;
  RowStream<TIn> q;
  if (active) q.start(r0 < S ? base + r0 * row3 : nullptr, r1 < S ? base + r1 * row3 : nullptr, d);
  if (qkv_save)  // this tile's rows of the head's q, k and v, during K's copy
    save_rows(qkv_save + (size_t)seq * S * row3 + (size_t)h * d, base, row3, C, d, q0,
              min(ATT_TILE, S - q0));
  cp_async_wait();
  __syncthreads();

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if (active) q.template run<NT>(s, scale_q ? scale : 1.f, Bs, ld);
  __syncthreads();  // every warp is done with K

  stage(Bs, ld, base + 2 * C, row3, S, d, Sp, dk, vec);  // V, in flight during the softmax
  cp_async_commit();

  // softmax over the whole row, in registers
  const float post = scale_q ? 1.f : scale;
  const float* am = addmask ? addmask + ((size_t)(seq % nW) * H + h) * S * S : nullptr;
  const float* am0 = am && r0 < S ? am + (size_t)r0 * S : nullptr;
  const float* am1 = am && r1 < S ? am + (size_t)r1 * S : nullptr;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (col < S) {
        v0 = s[j][e] * post;
        v1 = s[j][2 + e] * post;
        if (am0) v0 += am0[col];
        if (am1) v1 += am1[col];
      }
      s[j][e] = v0;
      s[j][2 + e] = v1;
      m0 = fmaxf(m0, v0);
      m1 = fmaxf(m1, v1);
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - m0);
      s[j][2 + e] = expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (lse && active && t == 0) {
    if (r0 < S) lse[bh * S + r0] = m0 + logf(l0);
    if (r1 < S) lse[bh * S + r1] = m1 + logf(l1);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  TSave* p0 = p_save && active && r0 < S ? p_save + (bh * S + r0) * S : nullptr;
  TSave* p1 = p_save && active && r1 < S ? p_save + (bh * S + r1) * S : nullptr;
  const bool p_pair = S % 2 == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= i0;
    s[j][1] *= i0;
    s[j][2] *= i1;
    s[j][3] *= i1;
    const int col = 8 * j + 2 * t;
    if (p0) store2(p0, col, S, p_pair, s[j][0], s[j][1]);
    if (p1) store2(p1, col, S, p_pair, s[j][2], s[j][3]);
  }
  cp_async_wait();
  __syncthreads();  // V is staged
  if (!active) return;
  TOut* o0 = r0 < S ? out + ((size_t)seq * S + r0) * C + (size_t)h * d : nullptr;
  TOut* o1 = r1 < S ? out + ((size_t)seq * S + r1) * C + (size_t)h * d : nullptr;
  cols_product<NT, PV_BF16>(s, Bs, ld, d, o0, o1, d % 2 == 0 && C % 2 == 0);
}

// dynamic shared memory of a block staging 8 * att_tiles(S) rows of
// pad_d(d) in T, plus extra bytes
template <typename T>
inline size_t att_smem(int S, int d, size_t extra = 0) {
  return (size_t)8 * att_tiles(S) * smem_ld<T>(pad_d(d)) * sizeof(T) + extra;
}

inline bool att_bad_shape(int B, int S, int C, int H) {
  return B <= 0 || S <= 0 || H <= 0 || C % H || S > ATT_MAX_S || C / H > ATT_MAX_D;
}

template <typename Kern, typename... Args>
inline int att_launch(Kern kern, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, ATT_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// B sequences of S tokens; the arguments as for attention_fwd_kernel
template <typename TIn, bool PV_BF16, typename TOut, typename TSave = float>
inline int launch_attention_fwd(const TIn* qkv, const float* addmask, TOut* out, float* lse,
                                int B, int S, int C, int H, int nW, float scale, bool scale_q,
                                cudaStream_t stream, TSave* p_save = nullptr,
                                TSave* qkv_save = nullptr) {
  if (att_bad_shape(B, S, C, H) || nW <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = att_smem<TIn>(S, C / H);
  const dim3 grid(B, H, (S + ATT_TILE - 1) / ATT_TILE);
  const int sq = scale_q ? 1 : 0;
#define UM_FWD(NT)                                                                            \
  att_launch(attention_fwd_kernel<NT, TIn, PV_BF16, TOut, TSave>, grid, smem, stream, qkv,  \
             addmask, out, lse, p_save, qkv_save, S, C, H, nW, scale, sq)
  const int nt = att_tiles(S);
  const int rc = nt == 4 ? UM_FWD(4) : nt == 10 ? UM_FWD(10) : UM_FWD(20);
#undef UM_FWD
  return rc;
}

}  // namespace um
