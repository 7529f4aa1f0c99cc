// K6: soft label -> smoothed 3-class vector, one elementwise pass.
//
// Replaces fused_label2vec_smooth / _label_kernel
// (ultrasound_modeling_tpu/ops/pallas_kernels.py:1157, body :1146-1154).
// The JAX package has no caller for it (the train step uses
// data/labels.label2vec); the port keeps it standalone, as a function.
//
//   c2 = min(where(l >= 1.05, l - 1, 0), 1)
//   c1 = where(l > 0.95, 1 - c2, 0)
//   c0 = where(l <= 0.95, 1, 0)
//   y  = [c0, c1, c2] * keep + add     (keep = 1 - s, add = s / 3 when smoothing)
//
// Bound: memory, 4 bytes read and 12 written per pixel; one thread per
// pixel in a grid-stride loop.  The TPU kernel's one-image-per-program grid
// exists only so that a batch need not fit VMEM and is dropped.

#include "common.cuh"

namespace {

constexpr int L2V_THREADS = 256;

__global__ void __launch_bounds__(L2V_THREADS)
label2vec_kernel(const float* __restrict__ label, float* __restrict__ out, int n,
                 int smooth, float keep, float add) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float l = label[i];
    const float c2 = fminf(l >= 1.05f ? l - 1.0f : 0.0f, 1.0f);
    const float c1 = l > 0.95f ? 1.0f - c2 : 0.0f;
    const float c0 = l <= 0.95f ? 1.0f : 0.0f;
    float* o = out + 3 * (size_t)i;
    if (smooth) {  // rounded multiply, then add (no FMA), as the plain version
      o[0] = __fadd_rn(__fmul_rn(c0, keep), add);
      o[1] = __fadd_rn(__fmul_rn(c1, keep), add);
      o[2] = __fadd_rn(__fmul_rn(c2, keep), add);
    } else {
      o[0] = c0;
      o[1] = c1;
      o[2] = c2;
    }
  }
}

}  // namespace

extern "C" {

// out[n, 3] from label[n] (both float32).
int label2vec_smooth(const float* label, float* out, int n, int smooth, float keep,
                     float add, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + L2V_THREADS - 1) / L2V_THREADS;
  label2vec_kernel<<<blocks < 4096 ? blocks : 4096, L2V_THREADS, 0,
                     (cudaStream_t)stream>>>(label, out, n, smooth, keep, add);
  return (int)cudaGetLastError();
}

}  // extern "C"
