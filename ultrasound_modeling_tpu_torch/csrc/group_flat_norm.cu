// K2: per-group channel LayerNorm over a flat channel axis, with the
// split-attention stage's LeakyReLU folded in; forward and backward.
//
// Replaces group_flat_norm (ultrasound_modeling_tpu/ops/pallas_kernels.py:1113):
// the forward _gfn_fwd_pallas (:1031, kernel _gfn_fwd_kernel :954-968) and the
// backward _gfn_bwd_pallas (:1057, kernel _gfn_bwd_kernel :971-1010).  The JAX
// package runs it on the train path of every split-attention stage, twice per
// stage (models/resnest.py:260-276: branch1_norm, branch2_norm).
//
// Input y [rows, F] (float32 or bfloat16, contiguous, 16-byte aligned),
// F = G * gsize: each contiguous group of gsize channels of a row is
// normalized with its own mean and biased variance (two-pass, float32), then
// * scale[f] + bias[f] and, optionally, LeakyReLU(alpha).  On the flagship at
// batch 32, F runs from 27 to 765 and gsize from 3 to 85 (G = 9 in every
// stage), rows from 2,560 to 163,840.
//
// Bound: bytes.  A few FLOPs a value against one read of y (and g) and one
// write of the output: at 163,840 x 90 in f32, 118 MB (forward) and 177 MB
// (backward), 35 and 53 us at 3.35 TB/s.
//
// Design (one persistent grid per call, 256 threads a block):
// - Row tiles.  A tile is R whole rows, one contiguous span; R is a multiple
//   of the rows that make 16 bytes, so every tile but a ragged last one
//   starts and ends 16-byte aligned.  The caller picks R (about 16 KB of y a
//   forward tile, 8 KB each of y and g a backward one) and a grid of at most
//   two blocks an SM so that every block walks the same number of tiles,
//   give or take one (ops/kernels.gfn_plan).  Both are fixed by the shape
//   and the card, so the reduction order below is too.
// - Overlapped loads.  Thread 0 keeps a 2-stage ring of tiles in flight
//   with 1-D bulk copies (cp.async.bulk, completion on an mbarrier; no tensor
//   map to encode); a tile's statistics and stores run while the next one
//   lands.  (A ring of up to 4 tiles, and 3 or 4 blocks an SM, were timed
//   against this and none was faster.)  A ragged last tile's bytes past the
//   last 16-byte multiple are copied by the threads.
// - Statistics: one thread per (row, group), serial over the group in the
//   same order and expressions as before (two-pass mean and 1/std, the
//   backward's two gradient sums), so a row's numbers are the same bits as
//   the kernel this one replaced.  The group's values are gsize apart between
//   neighbouring threads: an even gsize still costs 2-way (g 10, 14, 42) or
//   4-way (g 28) bank conflicts in these two or three passes, the only
//   conflicted accesses left.
// - Elementwise pass with no division: a warp takes rows, its lanes columns
//   (f = lane + 32k), so a lane knows its column, reads its group from a
//   per-block table built once per launch and its scale and bias from shared
//   memory once per column; shared-memory reads are conflict-free and global
//   stores coalesced.  Where a tile has fewer than 8 rows (F 765), the warps
//   split the columns too.
// - Backward column sums, deterministic: each warp accumulates its columns'
//   sum(g' * xhat) and sum(g') in registers over its rows of a tile and adds
//   them to its row stride's slot in shared memory, across all the block's
//   tiles; the block writes one partial row [2F] (its row strides summed in
//   order), and gfn_reduce_kernel sums the partial rows in block order, the
//   lanes on consecutive columns (coalesced).  dscale and dbias are the same
//   bits on every run of a shape on a given card.
// - Host: the dynamic shared-memory limit is set once per instantiation
//   (a static in each launcher).
//
// What the TPU version needed and this one drops: the 0/1 block-diagonal
// selection matrix (_gfn_matrices :1013-1017) that took group sums on the
// MXU, with its HIGHEST-precision switch for float32 (:939-951) and the bf16
// rounding of the squared and gradient terms before those sums; here every
// sum is a float32 register sum.  The tail-tile row masking (:977-981) is a
// bounds check.

#include "common.cuh"

using um::bf16;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// The warps' split of a tile's rows: WR row strides (and WARPS / WR column
// strides), so that a tile of fewer than 8 rows keeps every warp busy.
__host__ __device__ inline int row_warps(int R) {
  return R >= 8 ? 8 : R >= 4 ? 4 : R >= 2 ? 2 : 1;
}

// Dynamic shared memory of a block: the mbarriers, STAGES x INPUTS tiles,
// the per-(row, group) statistics (float2 forward, float4 backward), the
// column table (group, scale, bias) and, backward, the column sums of each
// row stride [WR, 2F].
struct Layout {
  size_t tile, stats, cols, acc, total;
  __host__ __device__ Layout(int R, int F, int G, int elem, bool bwd) {
    tile = align128((size_t)R * F * elem);
    stats = 128 + (size_t)STAGES * (bwd ? 2 : 1) * tile;
    cols = align128(stats + (size_t)R * G * (bwd ? 16 : 8));
    acc = align128(cols + (size_t)F * 12);
    total = acc + (bwd ? (size_t)row_warps(R) * 2 * F * sizeof(float) : 0);
  }
};

// Two-pass mean and 1/std of `gsize` values.
template <typename T>
__device__ __forceinline__ void group_stats(const T* v, int gsize, float eps, float& mean,
                                            float& rstd) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < gsize; ++c) s += um::to_f32(v[c]);
  mean = s / gsize;
  float q = 0.f;
#pragma unroll 4
  for (int c = 0; c < gsize; ++c) {
    const float z = um::to_f32(v[c]) - mean;
    q += z * z;
  }
  rstd = rsqrtf(q / gsize + eps);
}

// The block's ring of row tiles of INPUTS tensors [rows, F] (y, and g for the
// backward): tile t of every input lands in stage s by one bulk copy each.
template <typename T, int INPUTS>
struct TileRing {
  const T* src[INPUTS];
  unsigned char* smem;
  size_t tile_bytes;
  int rows, F, R;

  __device__ uint32_t bar(int s) const { return um::smem_u32(smem + 8 * s); }
  __device__ T* buf(int s, int in) const {
    return reinterpret_cast<T*>(smem + 128 + (size_t)(s * INPUTS + in) * tile_bytes);
  }
  __device__ int tile_rows(int t) const { return min(R, rows - t * R); }
  // elements of tile t that its bulk copies bring (a whole multiple of 16 bytes)
  __device__ int bulk_elems(int t) const {
    return (int)(((size_t)tile_rows(t) * F * sizeof(T)) & ~(size_t)15) / (int)sizeof(T);
  }

  // thread 0: the barriers, then the block's first STAGES tiles
  __device__ void start(int tiles) const {
    for (int s = 0; s < STAGES; ++s) um::mbar_init(bar(s), 1);
    um::fence_mbar_init();
    for (int s = 0; s < STAGES && blockIdx.x + s * gridDim.x < tiles; ++s)
      issue(blockIdx.x + s * gridDim.x, s);
  }
  __device__ void issue(int t, int s) const {  // thread 0
    const uint32_t bytes = (uint32_t)bulk_elems(t) * sizeof(T);
    um::fence_proxy_async();  // the threads' tail copies into this buffer came first
    um::mbar_expect_tx(bar(s), INPUTS * bytes);
    if (bytes)
      for (int in = 0; in < INPUTS; ++in)
        um::bulk_load(um::smem_u32(buf(s, in)), src[in] + (size_t)t * R * F, bytes, bar(s));
  }
  // All threads: waits for tile t in stage s (the barrier's phase with this
  // parity), then copies what the bulk copies left of a ragged last tile.
  __device__ void wait(int s, int parity, int t) const {
    um::mbar_wait(bar(s), parity);
    const int n = tile_rows(t) * F, done = bulk_elems(t);
    if (done < n) {
      for (int in = 0; in < INPUTS; ++in)
        for (int e = done + (int)threadIdx.x; e < n; e += THREADS)
          buf(s, in)[e] = src[in][(size_t)t * R * F + e];
      __syncthreads();
    }
  }
};

// Per block, once: the column table (each column's group, scale, bias) and
// this warp's place in the split of a tile: row stride wr of WR, column
// stride wk of WARPS / WR.
struct Columns {
  int* group;
  float* scale;
  float* bias;
  int WR, wr, wk;

  __device__ Columns(unsigned char* smem, const Layout& L, int F, int gsize, int R,
                     const float* __restrict__ sc, const float* __restrict__ bi) {
    group = reinterpret_cast<int*>(smem + L.cols);
    scale = reinterpret_cast<float*>(group + F);
    bias = scale + F;
    for (int f = threadIdx.x; f < F; f += THREADS) {
      group[f] = f / gsize;
      scale[f] = sc[f];
      bias[f] = bi[f];
    }
    WR = row_warps(R);
    const int warp = threadIdx.x >> 5;
    wr = warp & (WR - 1);
    wk = warp / WR;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gfn_forward_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int rows, int F,
                   int gsize, int R, float eps, int act, float alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = F / gsize, tid = threadIdx.x, lane = tid & 31;
  const Layout L(R, F, G, sizeof(T), false);
  const TileRing<T, 1> ring{{y}, smem, L.tile, rows, F, R};
  float2* stats = reinterpret_cast<float2*>(smem + L.stats);
  const Columns col(smem, L, F, gsize, R, scale, bias);
  const int WK = WARPS / col.WR, tiles = (rows + R - 1) / R;
  if (tid == 0) ring.start(tiles);
  __syncthreads();
  for (int s = 0, parity = 0, t = blockIdx.x; t < tiles; t += gridDim.x) {
    ring.wait(s, parity, t);
    const T* yb = ring.buf(s, 0);
    const int r0 = t * R, nr = ring.tile_rows(t);
    for (int it = tid; it < nr * G; it += THREADS) {
      float m, r;
      group_stats(yb + (size_t)it * gsize, gsize, eps, m, r);
      stats[it] = make_float2(m, r);
    }
    __syncthreads();
    for (int f = lane + 32 * col.wk; f < F; f += 32 * WK) {
      const int gi = col.group[f];
      const float a = col.scale[f], b = col.bias[f];
      for (int r = col.wr; r < nr; r += col.WR) {
        const float2 st = stats[r * G + gi];
        float o = (um::to_f32(yb[r * F + f]) - st.x) * st.y * a + b;
        if (act && !(o >= 0.f)) o *= alpha;
        out[(size_t)(r0 + r) * F + f] = um::from_f32<T>(o);
      }
    }
    __syncthreads();  // the tile and the statistics are read
    const int next = t + STAGES * gridDim.x;
    if (tid == 0 && next < tiles) ring.issue(next, s);
    if (++s == STAGES) s = 0, parity ^= 1;
  }
}

// dy = (s*g' - mean_grp(s*g') - xhat * mean_grp(s*g'*xhat)) * rstd, with
// g' = g * LeakyReLU'(pre) when the activation is folded in; the block writes
// its column sums of g' * xhat and g' to partial[block] ([2F]).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gfn_backward_kernel(const T* __restrict__ y, const T* __restrict__ g,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ dy, float* __restrict__ partial, int rows, int F,
                    int gsize, int R, float eps, int act, float alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = F / gsize, tid = threadIdx.x, lane = tid & 31;
  const Layout L(R, F, G, sizeof(T), true);
  const TileRing<T, 2> ring{{y, g}, smem, L.tile, rows, F, R};
  float4* stats = reinterpret_cast<float4*>(smem + L.stats);
  const Columns col(smem, L, F, gsize, R, scale, bias);
  // the column sums of each row stride [WR, 2F]: a (row stride, column)
  // belongs to one lane of one warp
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  for (int j = tid; j < col.WR * 2 * F; j += THREADS) acc[j] = 0.f;
  float* wacc = acc + (size_t)col.wr * 2 * F;
  const int WK = WARPS / col.WR, tiles = (rows + R - 1) / R;
  // the group of this thread's first item of a tile, and its step
  const int grp0 = tid % G, gstep = THREADS % G;
  if (tid == 0) ring.start(tiles);
  __syncthreads();
  for (int s = 0, parity = 0, t = blockIdx.x; t < tiles; t += gridDim.x) {
    ring.wait(s, parity, t);
    const T* yb = ring.buf(s, 0);
    const T* gb = ring.buf(s, 1);
    const int r0 = t * R, nr = ring.tile_rows(t);
    int grp = grp0;
    for (int it = tid; it < nr * G; it += THREADS) {
      const T* v = yb + (size_t)it * gsize;
      const T* gv = gb + (size_t)it * gsize;
      const float* sc = col.scale + grp * gsize;
      const float* bi = col.bias + grp * gsize;
      float m, r;
      group_stats(v, gsize, eps, m, r);
      float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
      for (int c = 0; c < gsize; ++c) {
        const float xhat = (um::to_f32(v[c]) - m) * r;
        float gg = um::to_f32(gv[c]);
        if (act && !(fmaf(xhat, sc[c], bi[c]) >= 0.f)) gg *= alpha;
        const float sg = gg * sc[c];
        a1 += sg;
        a2 += sg * xhat;
      }
      stats[it] = make_float4(m, r, a1 / gsize, a2 / gsize);
      grp += gstep;
      if (grp >= G) grp -= G;
    }
    __syncthreads();
    for (int f = lane + 32 * col.wk; f < F; f += 32 * WK) {
      const int gi = col.group[f];
      const float a = col.scale[f], b = col.bias[f];
      float ds = 0.f, db = 0.f;
      for (int r = col.wr; r < nr; r += col.WR) {
        const float4 st = stats[r * G + gi];
        const float xhat = (um::to_f32(yb[r * F + f]) - st.x) * st.y;
        float gg = um::to_f32(gb[r * F + f]);
        if (act && !(fmaf(xhat, a, b) >= 0.f)) gg *= alpha;
        const float sg = gg * a;
        dy[(size_t)(r0 + r) * F + f] = um::from_f32<T>((sg - st.z - xhat * st.w) * st.y);
        ds += gg * xhat;
        db += gg;
      }
      wacc[f] += ds;
      wacc[F + f] += db;
    }
    __syncthreads();  // the tiles and the statistics are read
    const int next = t + STAGES * gridDim.x;
    if (tid == 0 && next < tiles) ring.issue(next, s);
    if (++s == STAGES) s = 0, parity ^= 1;
  }
  __syncthreads();
  for (int j = tid; j < 2 * F; j += THREADS) {
    float sum = 0.f;
    for (int w = 0; w < col.WR; ++w) sum += acc[(size_t)w * 2 * F + j];
    partial[(size_t)blockIdx.x * 2 * F + j] = sum;
  }
}

// out[j] = sum over blocks b, in order, of partial[b][j] for the 2F columns
// (dscale then dbias): a block takes 32 consecutive columns, one a lane; its
// warps take every 8th block, then warp 0 adds the 8 warp sums in order.
__global__ void __launch_bounds__(THREADS)
gfn_reduce_kernel(const float* __restrict__ partial, int blocks, int F,
                  float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 2 * F, j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < n)
    for (int b = warp; b < blocks; b += WARPS) s += partial[(size_t)b * n + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < n) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    if (j < F)
      dscale[j] = t;
    else
      dbias[j - F] = t;
  }
}

// R rows a tile (whole 16-byte multiples), grid blocks, each with a tile
bool bad_shape(int rows, int F, int gsize, int R, int grid, int elem) {
  return rows <= 0 || F <= 0 || gsize <= 0 || F % gsize || R <= 0 ||
         ((size_t)R * F * elem) % 16 || grid <= 0 || grid > (rows + R - 1) / R;
}

template <typename T>
int launch_forward(const void* y, const float* scale, const float* bias, void* out, int rows,
                   int F, int gsize, int R, int grid, float eps, int act, float alpha,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gfn_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = Layout(R, F, F / gsize, sizeof(T), false).total;
  if (bad_shape(rows, F, gsize, R, grid, sizeof(T)) || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  gfn_forward_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)y, scale, bias, (T*)out,
                                                        rows, F, gsize, R, eps, act, alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* y, const void* g, const float* scale, const float* bias,
                    void* dy, float* partial, float* dscale, float* dbias, int rows, int F,
                    int gsize, int R, int grid, float eps, int act, float alpha,
                    cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gfn_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = Layout(R, F, F / gsize, sizeof(T), true).total;
  if (bad_shape(rows, F, gsize, R, grid, sizeof(T)) || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  gfn_backward_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)y, (const T*)g, scale,
                                                         bias, (T*)dy, partial, rows, F,
                                                         gsize, R, eps, act, alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gfn_reduce_kernel<<<(2 * F + 31) / 32, THREADS, 0, stream>>>(partial, grid, F, dscale,
                                                              dbias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[rows, F] = act(norm_grp(y) * scale + bias); y and out bf16 if is_bf16,
// else float32, both 16-byte aligned; tiles of R rows (R * F * elem a
// multiple of 16 bytes) over `grid` blocks.
int group_flat_norm_fwd(const void* y, int is_bf16, const float* scale, const float* bias,
                        void* out, int rows, int F, int gsize, int R, int grid, float eps,
                        int act, float alpha, void* stream) {
  if (is_bf16)
    return launch_forward<bf16>(y, scale, bias, out, rows, F, gsize, R, grid, eps, act, alpha,
                                (cudaStream_t)stream);
  return launch_forward<float>(y, scale, bias, out, rows, F, gsize, R, grid, eps, act, alpha,
                               (cudaStream_t)stream);
}

// dy [rows, F] (y's type), dscale [F], dbias [F] (float32) from y and the output
// gradient g (both 16-byte aligned), tiles as for the forward; partial is
// float32 scratch [grid, 2, F].  Two launches: the tile pass, then the
// column reduce.
int group_flat_norm_bwd(const void* y, const void* g, int is_bf16, const float* scale,
                        const float* bias, void* dy, float* partial, float* dscale,
                        float* dbias, int rows, int F, int gsize, int R, int grid, float eps,
                        int act, float alpha, void* stream) {
  if (is_bf16)
    return launch_backward<bf16>(y, g, scale, bias, dy, partial, dscale, dbias, rows, F,
                                 gsize, R, grid, eps, act, alpha, (cudaStream_t)stream);
  return launch_backward<float>(y, g, scale, bias, dy, partial, dscale, dbias, rows, F,
                                gsize, R, grid, eps, act, alpha, (cudaStream_t)stream);
}

}  // extern "C"
