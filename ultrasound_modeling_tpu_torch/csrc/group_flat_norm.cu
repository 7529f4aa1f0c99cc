// K2: per-group channel LayerNorm over a flat channel axis, with the
// split-attention stage's LeakyReLU folded in; forward and backward.
//
// Replaces group_flat_norm (ultrasound_modeling_tpu/ops/pallas_kernels.py:1113):
// the forward _gfn_fwd_pallas (:1031, kernel _gfn_fwd_kernel :954-968) and the
// backward _gfn_bwd_pallas (:1057, kernel _gfn_bwd_kernel :971-1010).  The JAX
// package runs it on the train path of every split-attention stage, twice per
// stage (models/resnest.py:260-276: branch1_norm, branch2_norm).
//
// Input y [rows, F] (float32 or bfloat16, contiguous), F = G * gsize: each
// contiguous group of gsize channels of a row is normalized with its own mean
// and biased variance (two-pass, float32), then * scale[f] + bias[f] and,
// optionally, LeakyReLU(alpha).  On the flagship F runs from 27 to 765, gsize
// from 3 to 85 (odd sizes included), rows from 2,560 to 163,840 at batch 32.
//
// Bound: a few FLOPs per value against 2 (forward) or 3 (backward) passes
// over the tensor in device memory, so both are memory-bound.  The design
// reads and writes each value once with coalesced accesses: a block takes
// `rpb` whole rows, which are one contiguous span of memory, into a float32
// tile in shared memory; the per-(row, group) statistics come from the tile
// (one thread per group, sums in float32 registers); the result streams back
// to device memory in the same coalesced order.
//
// What the TPU version needed and this one drops: the 0/1 block-diagonal
// selection matrix (_gfn_matrices :1013-1017) that took group sums on the
// MXU, with its HIGHEST-precision switch for float32 (:939-951) and the bf16
// rounding of the squared and gradient terms before those sums; here every
// sum is a float32 register sum.  The tail-tile row masking (:977-981) is a
// bounds check.  dscale and dbias, sums over up to 163,840 rows, are taken
// deterministically: each block writes its column partials, and a second
// kernel reduces them in a fixed order (no float atomics), so gradients are
// the same bits on every run.

#include "common.cuh"

using um::bf16;

namespace {

constexpr int GFN_THREADS = 256;

// Two-pass mean and 1/std of `gsize` float32 values.
__device__ __forceinline__ void group_stats(const float* v, int gsize, float eps,
                                            float& mean, float& rstd) {
  float s = 0.f;
  for (int c = 0; c < gsize; ++c) s += v[c];
  mean = s / gsize;
  float q = 0.f;
  for (int c = 0; c < gsize; ++c) {
    const float z = v[c] - mean;
    q += z * z;
  }
  rstd = rsqrtf(q / gsize + eps);
}

// Loads rows [r0, r0 + nr) of x into a float32 tile (one contiguous span).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, size_t base, int n,
                                          float* tile) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) tile[e] = um::to_f32(x[base + e]);
}

template <typename T>
__global__ void __launch_bounds__(GFN_THREADS)
gfn_forward_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int rows, int F,
                   int gsize, int rpb, float eps, int act, float alpha) {
  extern __shared__ float smem[];
  const int G = F / gsize;
  const int r0 = blockIdx.x * rpb, nr = min(rpb, rows - r0);
  float* tile = smem;             // [nr, F]
  float* mu = tile + rpb * F;     // [nr * G]
  float* rs = mu + rpb * G;       // [nr * G]
  const size_t base = (size_t)r0 * F;
  const int n = nr * F;
  load_tile(y, base, n, tile);
  __syncthreads();
  // item it = row * G + group; its values start at tile[it * gsize]
  for (int it = threadIdx.x; it < nr * G; it += blockDim.x)
    group_stats(tile + it * gsize, gsize, eps, mu[it], rs[it]);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int f = e % F, it = e / gsize;
    float o = (tile[e] - mu[it]) * rs[it] * scale[f] + bias[f];
    if (act && !(o >= 0.f)) o *= alpha;
    out[base + e] = um::from_f32<T>(o);
  }
}

// dy = (s*g' - mean_grp(s*g') - xhat * mean_grp(s*g'*xhat)) * rstd, with
// g' = g * LeakyReLU'(pre) when the activation is folded in; each block also
// writes its column partials of sum(g' * xhat) and sum(g') to partial[block].
template <typename T>
__global__ void __launch_bounds__(GFN_THREADS)
gfn_backward_kernel(const T* __restrict__ y, const T* __restrict__ g,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ dy, float* __restrict__ partial, int rows, int F,
                    int gsize, int rpb, float eps, int act, float alpha) {
  extern __shared__ float smem[];
  const int G = F / gsize;
  const int r0 = blockIdx.x * rpb, nr = min(rpb, rows - r0);
  float* ty = smem;               // [nr, F] input
  float* tg = ty + rpb * F;       // [nr, F] gradient, then g'
  float* mu = tg + rpb * F;
  float* rs = mu + rpb * G;
  float* t1 = rs + rpb * G;
  float* t2 = t1 + rpb * G;
  const size_t base = (size_t)r0 * F;
  const int n = nr * F;
  load_tile(y, base, n, ty);
  load_tile(g, base, n, tg);
  __syncthreads();
  for (int it = threadIdx.x; it < nr * G; it += blockDim.x) {
    const float* v = ty + it * gsize;
    float* gv = tg + it * gsize;
    const int f0 = (it % G) * gsize;
    float m, r;
    group_stats(v, gsize, eps, m, r);
    float a1 = 0.f, a2 = 0.f;
    for (int c = 0; c < gsize; ++c) {
      const float xhat = (v[c] - m) * r;
      float gg = gv[c];
      if (act && !(xhat * scale[f0 + c] + bias[f0 + c] >= 0.f)) {
        gg *= alpha;
        gv[c] = gg;
      }
      const float sg = gg * scale[f0 + c];
      a1 += sg;
      a2 += sg * xhat;
    }
    mu[it] = m;
    rs[it] = r;
    t1[it] = a1 / gsize;
    t2[it] = a2 / gsize;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int f = e % F, it = e / gsize;
    const float xhat = (ty[e] - mu[it]) * rs[it];
    const float sg = tg[e] * scale[f];
    dy[base + e] = um::from_f32<T>((sg - t1[it] - xhat * t2[it]) * rs[it]);
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < nr; ++r) {
      const int e = r * F + f, it = e / gsize;
      const float gg = tg[e];
      ds += gg * (ty[e] - mu[it]) * rs[it];
      db += gg;
    }
    partial[((size_t)blockIdx.x * 2 + 0) * F + f] = ds;
    partial[((size_t)blockIdx.x * 2 + 1) * F + f] = db;
  }
}

// One block per (column, which): out[f] = sum over blocks of partial[b][which][f],
// strided per thread, then a fixed-shape tree in shared memory.
__global__ void __launch_bounds__(GFN_THREADS)
gfn_reduce_kernel(const float* __restrict__ partial, int blocks, int F,
                  float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[GFN_THREADS];
  const int f = blockIdx.x, which = blockIdx.y;
  float s = 0.f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x)
    s += partial[((size_t)b * 2 + which) * F + f];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int o = GFN_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) (which ? dbias : dscale)[f] = red[0];
}

bool bad_shape(int rows, int F, int gsize, int rpb) {
  return rows <= 0 || F <= 0 || gsize <= 0 || F % gsize || rpb <= 0;
}

template <typename T>
int launch_forward(const void* y, const float* scale, const float* bias, void* out,
                   int rows, int F, int gsize, int rpb, float eps, int act, float alpha,
                   cudaStream_t stream) {
  const size_t smem = (size_t)rpb * (F + 2 * (F / gsize)) * sizeof(float);
  auto kern = gfn_forward_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(rows + rpb - 1) / rpb, GFN_THREADS, smem, stream>>>(
      (const T*)y, scale, bias, (T*)out, rows, F, gsize, rpb, eps, act, alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* y, const void* g, const float* scale, const float* bias,
                    void* dy, float* partial, float* dscale, float* dbias, int rows, int F,
                    int gsize, int rpb, float eps, int act, float alpha,
                    cudaStream_t stream) {
  const int blocks = (rows + rpb - 1) / rpb;
  const size_t smem = (size_t)rpb * (2 * F + 4 * (F / gsize)) * sizeof(float);
  auto kern = gfn_backward_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, GFN_THREADS, smem, stream>>>((const T*)y, (const T*)g, scale, bias,
                                              (T*)dy, partial, rows, F, gsize, rpb, eps,
                                              act, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gfn_reduce_kernel<<<dim3(F, 2), GFN_THREADS, 0, stream>>>(partial, blocks, F, dscale,
                                                            dbias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[rows, F] = act(norm_grp(y) * scale + bias); y and out bf16 if is_bf16,
// else float32; rpb rows per block.
int group_flat_norm_fwd(const void* y, int is_bf16, const float* scale, const float* bias,
                        void* out, int rows, int F, int gsize, int rpb, float eps, int act,
                        float alpha, void* stream) {
  if (bad_shape(rows, F, gsize, rpb)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_forward<bf16>(y, scale, bias, out, rows, F, gsize, rpb, eps, act, alpha,
                                (cudaStream_t)stream);
  return launch_forward<float>(y, scale, bias, out, rows, F, gsize, rpb, eps, act, alpha,
                               (cudaStream_t)stream);
}

// dy [rows, F] (y's type), dscale [F], dbias [F] (float32) from y and the output
// gradient g; partial is float32 scratch [ceil(rows / rpb), 2, F].
int group_flat_norm_bwd(const void* y, const void* g, int is_bf16, const float* scale,
                        const float* bias, void* dy, float* partial, float* dscale,
                        float* dbias, int rows, int F, int gsize, int rpb, float eps,
                        int act, float alpha, void* stream) {
  if (bad_shape(rows, F, gsize, rpb)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_backward<bf16>(y, g, scale, bias, dy, partial, dscale, dbias, rows, F,
                                 gsize, rpb, eps, act, alpha, (cudaStream_t)stream);
  return launch_backward<float>(y, g, scale, bias, dy, partial, dscale, dbias, rows, F,
                                gsize, rpb, eps, act, alpha, (cudaStream_t)stream);
}

}  // extern "C"
