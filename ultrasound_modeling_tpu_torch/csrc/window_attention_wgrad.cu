// K4b's weight and bias gradients (the Swin's window-attention backward),
// one hand-written kernel on the tensor cores, split over the rows.
//
// Replaces the four products of _fused_attn_bwd that reduce over every row
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:206-235: d_proj_w,
// d_proj_b, d_qkv_w, d_qkv_b; XLA dots and sums in the JAX package).  With
// M rows (windows x tokens), C channels, and the attention kernel's dqkv
// [M, 3C] and context o [M, C] (window_attention_bwd.cu):
//   d_qkv_w [3C, C] = dqkv^T . x2      d_qkv_b [3C] = column sums of dqkv
//   d_proj_w [C, C] = g2^T . o         d_proj_b [C] = column sums of g2
// all float32, the products held to the f32 contract.
//
// Bound: at the Swin's stage 1 at b64 (M = 81,920, C = 96) the kernel reads
// 189 MB (56 us at 3.35 TB/s) for 6.0 GFLOP (36 us at 165 TFLOP/s, 3xTF32):
// bytes bind; at stages 3-4 (C 384, 768; M 5,120 and 1,728) the products
// do.  The outputs are a few tiles and the reduction runs over all the
// rows, so the rows are split.  A first version on mma.sync was held to
// that instruction's TF32 rate, a fraction of wgmma's; this one is not.
// The design:
// - the two products stacked as one [4C, C] output (the rows of dqkv^T.x2,
//   then those of g2^T.o, each part in whole 64-row tiles) in 64 x 96
//   tiles; a block takes one tile and one run of the rows
//   (ops/kernels.wgrad_plan: about one block an SM, whole 32-row k-blocks
//   a run; the plan depends on the shape and the card alone), tiles
//   fastest, so the blocks of a run read the same rows while they are in L2;
// - the products on wgmma m64n96k8 (TF32), A = the dqkv / g2 slice from
//   registers, B = the x2 / o slice from shared memory.  Both operands are
//   row-major [rows, .], so the reduction runs along their strided
//   dimension, and TF32 wgmma reads only K-major tiles: A's fragments are
//   loaded by hand from its [32 rows, 64] k-block (row stride 72 floats,
//   == 8 mod 32 words, so the reads hit 32 banks), and the consumer
//   warpgroup writes each B k-block transposed, [96, 32] in the 128-byte
//   swizzle, as its hi tile (the raw values, whose TF32 bits the tensor
//   core reads) and lo tile, every load of a thread's share issued before
//   its first store; the next k-block's transpose and A loads run while
//   this one's products do (two transposed buffers, A's fragments twice in
//   registers);
// - four producer warps keep a 7-stage ring of k-blocks in flight (a stage
//   is freed once its B is transposed and its A in registers) with 16-byte
//   cp.async copies, eight lanes a row, completed on the stage's mbarrier
//   (cp.async.mbarrier.arrive), zero-filling rows past a run's end and
//   columns past the operand's: no tensor map is encoded on the host.  One
//   producer warp could not keep the ring full (timed in the kernel with
//   clock64); four can;
// - every shared-memory access indexes the __shared__ array itself: with
//   the 1024-byte alignment taken through an integer cast, the compiler
//   lost the address space, could not order the transpose's loads ahead of
//   its stores, and the transposes took most of a k-block's time;
// - the f32 contract: x = hi + lo, lo rounded to TF32 (tf32_lo), three
//   passes (A_lo.B_hi, A_hi.B_lo, A_hi.B_hi).  The tensor core's own
//   accumulation truncates, and these reductions are 10^4-10^5 rows long,
//   so each k-block's twelve products start from zero and are added into
//   f32 registers (gemm_sm90.cuh's rule).  Where one operand is exactly
//   TF32 (x2 upcast from a bf16 x, g2 from a bf16 g), its lo pass adds
//   exact zeros: it comes first, and is dropped, with the same bits;
// - the bias sums: the blocks of the first column tile add their raw A
//   fragments in f32 as they load them;
// - one run writes the outputs; more write partial [runs, 4C*C + 4C] rows,
//   and wa_wgrad_reduce_kernel adds them in run order.  No float atomics:
//   two calls give the same bits.

#include <algorithm>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int WG_TP = 64;        // output tile: rows (A's columns, one warpgroup's M)
constexpr int WG_TQ = 96;        // and columns (B's columns, wgmma's N)
constexpr int WG_KB = 32;        // rows of a k-block (a ring stage): 128 bytes of K
constexpr int WG_LDA = 72;       // ring row strides, floats (== 8 mod 32)
constexpr int WG_LDB = 104;
constexpr int WG_STAGES = 7;
constexpr int WG_PRODUCERS = 4;  // producer warps, after the consumer warpgroup
constexpr int WG_THREADS = 128 + 32 * WG_PRODUCERS;
constexpr int WG_REDUCE_THREADS = 256;
constexpr int WG_A_FLOATS = WG_KB * WG_LDA, WG_B_FLOATS = WG_KB * WG_LDB;
constexpr int WG_BT_BYTES = WG_TQ * 128;  // a transposed B tile, [96][32] floats
// the transposed hi and lo tiles, twice (1024-aligned), the ring, the barriers
constexpr size_t WG_RING_OFF = 4 * (size_t)WG_BT_BYTES;
constexpr size_t WG_BAR_OFF = WG_RING_OFF + WG_STAGES * (WG_A_FLOATS + WG_B_FLOATS) * sizeof(float);
constexpr size_t WG_SMEM = 1024 + WG_BAR_OFF + 2 * WG_STAGES * sizeof(uint64_t);

// 16 bytes device -> shared, asynchronous (zeros when !in)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(um::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// B k-block [32 rows][96] (row stride WG_LDB) into its transposed tiles
// [96][32] in the 128-byte swizzle (16-byte chunk c of row q at chunk c ^ (q
// % 8)): hi = the raw values, lo = tf32_lo (not written under NO_LO).  A
// warp moves 8 columns x 4 rows a step: reads and writes hit 32 banks.
template <bool NO_LO>
__device__ __forceinline__ void transpose_b(unsigned char* bt, const float* Bs) {
  constexpr int STEPS = (WG_TQ / 8) * (WG_KB / 4) / 4;  // a warp's 8 x 4 moves
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qq = lane >> 2, kk = lane & 3;
  float x[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {  // every load first: they may not wait on a store
    const int i = warp + 4 * j, q = 8 * (i % (WG_TQ / 8)) + qq, k = 4 * (i / (WG_TQ / 8)) + kk;
    x[j] = Bs[k * WG_LDB + q];
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int i = warp + 4 * j, q = 8 * (i % (WG_TQ / 8)) + qq, k = 4 * (i / (WG_TQ / 8)) + kk;
    float* hi = reinterpret_cast<float*>(bt + q * 128 + ((((k >> 2) ^ (q & 7)) << 4) | (kk << 2)));
    hi[0] = x[j];
    if (!NO_LO) hi[WG_BT_BYTES / 4] = um::tf32_lo(x[j]);
  }
}

struct WgradArgs {
  const float* dqkv;  // [M, 3C]
  const float* x2;    // [M, C]
  const float* g2;    // [M, C]
  const float* o;     // [M, C]
  float* d_qkv_w;     // [3C, C]
  float* d_qkv_b;     // [3C]
  float* d_proj_w;    // [C, C]
  float* d_proj_b;    // [C]
  float* partial;     // [splits, 4C*C + 4C], or null with one split
  int M, C, per, x_exact, g_exact;
};

// where element i of the stacked result [4C*C weights | 4C biases] goes
__device__ __forceinline__ float* wg_dest(const WgradArgs& p, size_t i) {
  const size_t C = p.C, w3 = 3 * C * C, w4 = 4 * C * C;
  if (i < w3) return p.d_qkv_w + i;
  if (i < w4) return p.d_proj_w + (i - w3);
  if (i < w4 + 3 * C) return p.d_qkv_b + (i - w4);
  return p.d_proj_b + (i - w4 - 3 * C);
}

// A k-block's twelve (eight under EXACT) products into part, from zero.
// QKV_ROWS: A_hi.B_lo first, else A_lo.B_hi first; EXACT drops that pass.
template <bool QKV_ROWS, bool EXACT>
__device__ __forceinline__ void kblock_products(float (&part)[48], const uint32_t (&ah)[4][4],
                                                const uint32_t (&al)[4][4], uint32_t bt) {
  const uint32_t hi = bt, lo = bt + WG_BT_BYTES;
  auto pass = [&](const uint32_t (&a)[4][4], uint32_t b, bool first) {
#pragma unroll
    for (int ks = 0; ks < WG_KB / 8; ++ks)
      um::wgmma_step(part, a[ks], um::wgmma_desc(b + 32 * ks), first && ks == 0 ? 0 : 1);
  };
  if (QKV_ROWS) {
    if (!EXACT) pass(ah, lo, true);
    pass(al, hi, EXACT);
  } else {
    if (!EXACT) pass(al, hi, true);
    pass(ah, lo, EXACT);
  }
  pass(ah, hi, false);
}

// This thread's A fragments of a k-block's four k-steps (rows p 16 warp + g
// (+8), k t (+4)): raw bits as hi, tf32_lo as lo (none under A_EXACT); the
// raw columns added into bsum under bias.
template <bool A_EXACT>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                       float (&bsum)[2], const float* As, bool bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* ar = As + t * WG_LDA + 16 * warp + g;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float x[4] = {ar[8 * ks * WG_LDA], ar[8 * ks * WG_LDA + 8], ar[(8 * ks + 4) * WG_LDA],
                        ar[(8 * ks + 4) * WG_LDA + 8]};
    if (bias) {
      bsum[0] += x[0] + x[2];
      bsum[1] += x[1] + x[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[ks][i] = __float_as_uint(x[i]);
      al[ks][i] = A_EXACT ? 0u : __float_as_uint(um::tf32_lo(x[i]));
    }
  }
}

// The consumer warpgroup's k-blocks: the products of each added into sum
// (the tile's 64 x 96 accumulators), A's raw columns into bsum under bias.
// While k-block kb's products run, kb + 1's B is transposed and its A
// fragments loaded; a ring stage goes back to the producer as soon as both
// are out of it.
template <bool QKV_ROWS, bool EXACT>
__device__ __forceinline__ void consume(unsigned char* smem, int nkb, float (&sum)[48],
                                        float (&bsum)[2], bool bias) {
  constexpr bool NO_LO = QKV_ROWS && EXACT;    // B exact: its lo tile is 0
  constexpr bool A_EXACT = !QKV_ROWS && EXACT;  // A exact: its lo is 0
  const uint32_t bars = um::smem_u32(smem + WG_BAR_OFF);
  const float* ring = reinterpret_cast<const float*>(smem + WG_RING_OFF);
  const uint32_t bt0 = um::smem_u32(smem);
  auto stage = [&](int kb) { return ring + (size_t)(kb % WG_STAGES) * (WG_A_FLOATS + WG_B_FLOATS); };
  auto take = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    um::mbar_wait(bars + 8 * (kb % WG_STAGES), (kb / WG_STAGES) & 1);
    transpose_b<NO_LO>(smem + (kb & 1) * 2 * WG_BT_BYTES, stage(kb) + WG_A_FLOATS);
    um::fence_proxy_async();  // generic-proxy writes, read next by wgmma
    load_a<A_EXACT>(ah, al, bsum, stage(kb), bias);
    um::mbar_arrive(bars + 8 * (WG_STAGES + kb % WG_STAGES));  // the stage is free
  };
  uint32_t ah[4][4], al[4][4];
  take(0, ah, al);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    float part[48];
    um::wgmma_fence();  // after every write of the registers the products read
    kblock_products<QKV_ROWS, EXACT>(part, ah, al, bt0 + (kb & 1) * 2 * WG_BT_BYTES);
    um::wgmma_commit();
    uint32_t nh[4][4], nl[4][4];
    if (kb + 1 < nkb) take(kb + 1, nh, nl);
    um::wgmma_wait<0>();
    um::acc_fence(part);
    // the tensor core reads A's registers until the group is done
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("" : "+r"(ah[ks][i]), "+r"(al[ks][i])::"memory");
        ah[ks][i] = nh[ks][i];
        al[ks][i] = nl[ks][i];
      }
#pragma unroll
    for (int r = 0; r < 48; ++r) sum[r] += part[r];
    // the next transposed tile is whole, and this one's readers are done
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }
}

// Block (run s, tile): tile = pt * QT + qt, pt < PTq the qkv rows' tiles,
// then the proj rows'.
__global__ void __launch_bounds__(WG_THREADS, 1) wa_wgrad_kernel(const WgradArgs p) {
  // 1024-aligned for the swizzled tiles; indexed off the __shared__ array,
  // so that every access compiles to a shared-memory one
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (um::smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C, QT = (C + WG_TQ - 1) / WG_TQ, PTq = (3 * C + WG_TP - 1) / WG_TP;
  const int PT = PTq + (C + WG_TP - 1) / WG_TP, tiles = PT * QT;
  const int split = blockIdx.x / tiles, tile = blockIdx.x - split * tiles;
  const int pt = tile / QT, qt = tile - pt * QT;
  const bool qkv_rows = pt < PTq;
  const int P = qkv_rows ? 3 * C : C, p0 = (qkv_rows ? pt : pt - PTq) * WG_TP;
  const int q0 = qt * WG_TQ, wa = min(WG_TP, P - p0), wb = min(WG_TQ, C - q0);
  const int m0 = split * p.per, m1 = min(p.M, m0 + p.per);
  const int nkb = (m1 - m0 + WG_KB - 1) / WG_KB;
  const uint32_t bars = um::smem_u32(smem + WG_BAR_OFF);  // full[s], then empty[s]
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      um::mbar_init(bars + 8 * s, 32 * WG_PRODUCERS);
      um::mbar_init(bars + 8 * (WG_STAGES + s), 128);
    }
    um::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producers: 16-byte copies of a k-block's rows
    const float* A = qkv_rows ? p.dqkv : p.g2;
    const float* B = qkv_rows ? p.x2 : p.o;
    float* const ring = reinterpret_cast<float*>(smem + WG_RING_OFF);
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % WG_STAGES, r0 = m0 + kb * WG_KB, nr = min(WG_KB, m1 - r0);
      if (kb >= WG_STAGES) um::mbar_wait(bars + 8 * (WG_STAGES + s), (kb / WG_STAGES - 1) & 1);
      float* As = ring + (size_t)s * (WG_A_FLOATS + WG_B_FLOATS);
      float* Bs = As + WG_A_FLOATS;
      // eight lanes a row (128 bytes a step), four rows a step, the
      // producers' steps interleaved; rows past the run's end and columns
      // past the operand's zero-fill
#pragma unroll
      for (int j = 0; j < WG_KB / (4 * WG_PRODUCERS); ++j) {
        const int r = (lane >> 3) + 4 * (WG_PRODUCERS * j + warp - 4), c0 = 4 * (lane & 7);
        const bool row = r < nr;
        const float* a = A + (size_t)(r0 + (row ? r : 0)) * P + p0;
        const float* b = B + (size_t)(r0 + (row ? r : 0)) * C + q0;
#pragma unroll
        for (int m = 0; m < WG_TP / 32; ++m) {
          const int c = c0 + 32 * m;
          const bool in = row && c < wa;
          cp16(As + r * WG_LDA + c, in ? a + c : A, in);
        }
#pragma unroll
        for (int m = 0; m < WG_TQ / 32; ++m) {
          const int c = c0 + 32 * m;
          const bool in = row && c < wb;
          cp16(Bs + r * WG_LDB + c, in ? b + c : B, in);
        }
      }
      cp_async_arrive(bars + 8 * s);  // this lane's copies, once they land
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const bool bias = qt == 0;
  const bool exact = qkv_rows ? p.x_exact : p.g_exact;
  float sum[48], bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 48; ++r) sum[r] = 0.f;
  if (qkv_rows) {
    if (exact) consume<true, true>(smem, nkb, sum, bsum, bias);
    else consume<true, false>(smem, nkb, sum, bsum, bias);
  } else {
    if (exact) consume<false, true>(smem, nkb, sum, bsum, bias);
    else consume<false, false>(smem, nkb, sum, bsum, bias);
  }

  // sum[4j + 2h + e] is row p0 + 16 warp + g + 8h, column q0 + 8j + 2t + e;
  // the proj rows at row offset 3C of the stacked result, into the outputs
  // (one run) or this run's partial row
  const size_t stride = 4 * (size_t)C * C + 4 * (size_t)C;
  float* const part = p.partial ? p.partial + (size_t)split * stride : nullptr;
  const int prow0 = (qkv_rows ? 0 : 3 * C) + p0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pl = 16 * warp + g + 8 * h;
    if (pl >= wa) continue;
    const size_t row = (size_t)(prow0 + pl) * C;
#pragma unroll
    for (int j = 0; j < WG_TQ / 8; ++j) {
      const int ql = 8 * j + 2 * t;
      if (ql >= wb) continue;
      const size_t i = row + q0 + ql;
      float* d0 = part ? part + i : wg_dest(p, i);
      const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
      if (ql + 1 < wb) {
        *reinterpret_cast<float2*>(d0) = make_float2(v0, v1);  // i even: C and q even
      } else {
        *d0 = v0;
      }
    }
  }
  if (!bias) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = bsum[h];  // summed over the four lanes of the row
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int pl = 16 * warp + g + 8 * h;
    if (t == 0 && pl < wa) {
      const size_t i = 4 * (size_t)C * C + prow0 + pl;
      *(part ? part + i : wg_dest(p, i)) = v;
    }
  }
}

// out element i = sum over s < splits of partial[s][i], in split order
__global__ void __launch_bounds__(WG_REDUCE_THREADS)
wa_wgrad_reduce_kernel(const WgradArgs p, int splits) {
  const size_t n = 4 * (size_t)p.C * p.C + 4 * (size_t)p.C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += p.partial[(size_t)s * n + i];
    *wg_dest(p, i) = acc;
  }
}

}  // namespace

extern "C" {

// d_qkv_w [3C, C], d_qkv_b [3C], d_proj_w [C, C], d_proj_b [C] (float32)
// from dqkv [M, 3C], x2, g2 and o [M, C] (float32, 16-byte aligned, C % 4
// == 0); the rows split in `splits` runs of `per` (a multiple of 32, the
// last one short), partial [splits, 4C*C + 4C] for splits > 1 (else null).
// x_exact / g_exact: every value of x2 / g2 is exactly TF32 (their lo pass
// is dropped).
int wa_wgrad(const float* dqkv, const float* x2, const float* g2, const float* o,
             float* d_qkv_w, float* d_qkv_b, float* d_proj_w, float* d_proj_b, float* partial,
             int M, int C, int splits, int per, int x_exact, int g_exact, void* stream) {
  if (M <= 0 || C <= 0 || C % 4 || splits <= 0 || per <= 0 || per % WG_KB ||
      (long long)splits * per < M || (long long)(splits - 1) * per >= M ||
      (splits > 1) != (partial != nullptr))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wa_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const WgradArgs p{dqkv, x2, g2, o, d_qkv_w, d_qkv_b, d_proj_w, d_proj_b, partial,
                    M, C, per, x_exact, g_exact};
  const int QT = (C + WG_TQ - 1) / WG_TQ;
  const int PT = (3 * C + WG_TP - 1) / WG_TP + (C + WG_TP - 1) / WG_TP;
  cudaStream_t s = (cudaStream_t)stream;
  wa_wgrad_kernel<<<splits * PT * QT, WG_THREADS, WG_SMEM, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = 4 * (size_t)C * C + 4 * (size_t)C;
  const int blocks = (int)std::min<size_t>((n + WG_REDUCE_THREADS - 1) / WG_REDUCE_THREADS, 1024);
  wa_wgrad_reduce_kernel<<<blocks, WG_REDUCE_THREADS, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
