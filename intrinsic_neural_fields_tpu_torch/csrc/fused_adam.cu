// The Adam update over the texture field's flat f32 parameters, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel of intrinsic_neural_fields_tpu/ops/fused_mlp.py:
// make_fused_adam_apply. The expressions are csrc/adam.cuh's (optax's, in
// its order, every operation explicitly rounded), the same the train step's
// wgrad applies in its epilogue (make_fused_train_adam's in-kernel Adam), so
// the two give the same bits; built with -fmad=false besides.
//
// With `wb` it also writes the bf16 copy of the new parameters (round to
// nearest even) that the train kernels read their weights from.
//
// This kernel runs where the step's gradients leave the kernel: the eager
// step, the gathered (full shuffle) path and fused_adam=False.
//
// Bound on this card: 4 f32 reads and 3 f32 writes per parameter (and 2
// bytes with the copy) and ~12 flops, far below the ridge, so bytes bound
// it (~5.5 MB at k=512, ~1.7 us at 3.35 TB/s). One pass, one group of four
// parameters per thread: 16-byte loads and stores of p, m, v and g and an
// 8-byte store of the copy (the entry point takes buffers so aligned); the
// n % 4 tail by the first threads of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adam.cuh"

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
fused_adam_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ hyper, long long n,
                  __nv_bfloat16* __restrict__ wb) {
  const AdamHyper a = adam_hyper(hyper);
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * NTHREADS;
  const long long t0 = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  for (long long q = t0; q < n4; q += stride) {
    const float4 gq = reinterpret_cast<const float4*>(g)[q];
    float4 pq = reinterpret_cast<const float4*>(p)[q];
    float4 mq = reinterpret_cast<const float4*>(m)[q];
    float4 vq = reinterpret_cast<const float4*>(v)[q];
    adam_update(a, gq.x, pq.x, mq.x, vq.x);
    adam_update(a, gq.y, pq.y, mq.y, vq.y);
    adam_update(a, gq.z, pq.z, mq.z, vq.z);
    adam_update(a, gq.w, pq.w, mq.w, vq.w);
    reinterpret_cast<float4*>(p)[q] = pq;
    reinterpret_cast<float4*>(m)[q] = mq;
    reinterpret_cast<float4*>(v)[q] = vq;
    if (wb != nullptr) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(pq.x, pq.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pq.z, pq.w);
      reinterpret_cast<uint2*>(wb)[q] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                   *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
  const long long i = 4 * n4 + t0;  // the tail: at most 3 entries
  if (i < n) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_update(a, g[i], pi, mi, vi);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
    if (wb != nullptr) wb[i] = __float2bfloat16_rn(pi);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): params, m, v updated in place
// from grads and one [128] f32 hyper row (lr, c1, c2, b1, b2, eps,
// eps_root); wb: n bf16, the new params rounded to bf16 (nullptr: no copy).
// params, m, v and grads 16-byte aligned, wb 8-byte aligned. Launches on
// `stream`, returns cudaGetLastError().
extern "C" int fused_adam(float* params, float* m, float* v, const float* grads,
                          const float* hyper, long long n, void* wb, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (((uintptr_t)params | (uintptr_t)m | (uintptr_t)v | (uintptr_t)grads) % 16 != 0 ||
      (uintptr_t)wb % 8 != 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = ((n >> 2) + NTHREADS - 1) / NTHREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_adam_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      params, m, v, grads, hyper, n, (__nv_bfloat16*)wb);
  return (int)cudaGetLastError();
}
