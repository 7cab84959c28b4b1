// The Adam update over the texture field's flat f32 parameters, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel of intrinsic_neural_fields_tpu/ops/fused_mlp.py:
// make_fused_adam_apply (and the in-kernel Adam tail of
// make_fused_train_adam, which computes the same expressions). optax's
// numerics under inject_hyperparams(optax.adam), in its expression order:
//   m = (1-b1) g + b1 m,  v = (1-b2) g^2 + b2 v,
//   p = p - (lr (m c1)) / (sqrt(v c2 + eps_root) + eps),
// with (1-b1), (1-b2) computed in f32 from the hyper row and
// c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) precomputed per step by adam_hyper_rows.
// Built with -fmad=false and without fast math, so every product and sum
// rounds separately and sqrtf and the division round correctly: the result
// equals the plain torch twin's to the bit.
//
// With `wb` it also writes the bf16 copy of the new parameters (round to
// nearest even) that the train kernels read their weights from, so the
// copy is made once per step, not once per block.
//
// Bound on this card: 4 f32 reads and 3 f32 writes per parameter (and 2
// bytes with the copy) and ~10 flops, far below the ridge, so bytes bound
// it (~5.5 MB at k=512, ~1.7 us at 3.35 TB/s). One pass, coalesced, in
// place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
fused_adam_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ hyper, long long n,
                  __nv_bfloat16* __restrict__ wb) {
  const float lr = hyper[0], c1 = hyper[1], c2 = hyper[2];
  const float b1 = hyper[3], b2 = hyper[4], eps = hyper[5], eps_root = hyper[6];
  const float omb1 = 1.0f - b1, omb2 = 1.0f - b2;
  const long long stride = (long long)gridDim.x * NTHREADS;
  for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n; i += stride) {
    const float gi = g[i];
    const float mn = omb1 * gi + b1 * m[i];
    const float vn = omb2 * (gi * gi) + b2 * v[i];
    const float upd = (lr * (mn * c1)) / (sqrtf(vn * c2 + eps_root) + eps);
    const float pn = p[i] - upd;
    p[i] = pn;
    if (wb != nullptr) wb[i] = __float2bfloat16_rn(pn);
    m[i] = mn;
    v[i] = vn;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): params, m, v updated in place
// from grads and one [128] f32 hyper row (lr, c1, c2, b1, b2, eps,
// eps_root); wb: n bf16, the new params rounded to bf16 (nullptr: no copy).
// Launches on `stream`, returns cudaGetLastError().
extern "C" int fused_adam(float* params, float* m, float* v, const float* grads,
                          const float* hyper, long long n, void* wb, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  long long blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_adam_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      params, m, v, grads, hyper, n, (__nv_bfloat16*)wb);
  return (int)cudaGetLastError();
}
