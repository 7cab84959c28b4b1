// The Adam update of one parameter, shared by every kernel that applies it:
// csrc/fused_adam.cu (the standalone pass over the flat buffer) and the
// epilogue of csrc/fused_mlp_train.cu's wgrad (the train step's update, made
// by the owner of each gradient entry).
//
// optax's numerics under inject_hyperparams(optax.adam), in its expression
// order:
//   m = (1-b1) g + b1 m,  v = (1-b2) g^2 + b2 v,
//   p = p - (lr (m c1)) / (sqrt(v c2 + eps_root) + eps),
// (1-b1), (1-b2) in f32 from the hyper row, c1 = 1/(1-b1^t), c2 =
// 1/(1-b2^t) precomputed per step by ops/fused_mlp.py:adam_hyper_rows.
// Every operation is an explicitly rounded intrinsic, so no product is
// contracted into a multiply-add whatever -fmad a file is built with, and
// the square root and the division round correctly: both kernels give the
// plain torch twin's bits.

#pragma once

#include <cuda_runtime.h>

namespace {

struct AdamHyper {
  float lr, c1, c2, b1, b2, eps, eps_root, omb1, omb2;
};

// One [128] f32 hyper row (lr, c1, c2, b1, b2, eps, eps_root in lanes 0..6).
__device__ __forceinline__ AdamHyper adam_hyper(const float* __restrict__ h) {
  AdamHyper a;
  a.lr = h[0]; a.c1 = h[1]; a.c2 = h[2]; a.b1 = h[3]; a.b2 = h[4]; a.eps = h[5];
  a.eps_root = h[6];
  a.omb1 = __fsub_rn(1.0f, a.b1);
  a.omb2 = __fsub_rn(1.0f, a.b2);
  return a;
}

// p, m, v updated in place from the gradient g.
__device__ __forceinline__ void adam_update(const AdamHyper& a, float g, float& p, float& m,
                                            float& v) {
  m = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, m));
  v = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)), __fmul_rn(a.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(v, a.c2), a.eps_root)), a.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a.lr, __fmul_rn(m, a.c1)), den));
}

}  // namespace
