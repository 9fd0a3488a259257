// Shared device helpers of the training-path kernels.
//
// grad_rows() is the in-register gradient replica of the fused objective
// front (lightgbm_tpu/ops/pallas_hist.py _grad_rows). Every multiply, add and
// divide is spelled with the round-to-nearest intrinsics and in the
// reference's association order, so nvcc cannot contract a pair into an FMA
// (the library is also built with -fmad=false) and each f32 result is the
// value the JAX objective computes. expf is the precise CUDA libm exp; no
// fast-math anywhere.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

// kind 0: ("l2",)  grad = score - aux, hess = 1
// kind 1: ("logloss", sigmoid, lw_pos, lw_neg)
// sig2 is sigmoid * sigmoid rounded once to f32, as the reference folds the
// two Python floats before they meet the f32 row.
struct GradSpec {
  int kind;
  float sigmoid;
  float sig2;
  float lw_pos;
  float lw_neg;
};

__device__ __forceinline__ void grad_rows(const GradSpec& sp, float score,
                                          float aux, float& grad,
                                          float& hess) {
  if (sp.kind == 0) {
    grad = __fsub_rn(score, aux);
    hess = 1.0f;
    return;
  }
  const float t = __fsub_rn(__fmul_rn(2.0f, aux), 1.0f);
  const float lw = aux > 0.0f ? sp.lw_pos : sp.lw_neg;
  const float e = expf(__fmul_rn(__fmul_rn(t, sp.sigmoid), score));
  const float resp = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
  grad = __fmul_rn(__fmul_rn(__fmul_rn(-t, resp), sp.sigmoid), lw);
  hess = __fmul_rn(__fmul_rn(__fmul_rn(sp.sig2, resp), __fsub_rn(1.0f, resp)),
                   lw);
}

// Counter-hash dither of the stochastic-rounding quantizer
// (lightgbm_tpu/ops/histogram.py quantize_sr), in native uint32.
__device__ __forceinline__ float sr_dither(uint32_t idx, uint32_t seed,
                                           uint32_t salt) {
  const uint32_t i = idx + salt * 0x632BE59Bu;
  uint32_t z = (i ^ (seed * 0x9E3779B9u)) * 2654435761u;
  z = (z ^ (z >> 15)) * 2246822519u;
  z = z ^ (z >> 13);
  return __fmul_rn(static_cast<float>(z >> 8), 1.0f / 16777216.0f);
}

}  // namespace lgbt
