// Fused objective gradient + int8 stochastic-rounding quantization + root
// histogram.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// grad_quant_hist0_pallas (:918), kernel body _grad_quant_kernel (:807).
//
// Bound on the H100: bytes. One pass reads bins_T [F, N] u8 and
// score/aux/bag [N] f32 and writes gq/hq/cq [N] i8: about (F + 15) bytes a
// row, against a few dozen f32 operations a row.
//
// Design: the TPU ran a two-phase sequential grid whose first phase left the
// global max|g| / max h in scratch for the second. Hopper blocks run in no
// order, so this is two launches on one stream. Launch 1 recomputes g/h and
// folds the maxima into two device words with atomicMax on the float bits
// (exact and order-free for non-negative floats). Launch 2 recomputes g/h,
// derives the scales exactly as the reference does (scale_g floored at 1e-20;
// under const-hessian scale_h = 127 * max h, unfloored), quantizes with the
// counter-hash dither, writes the int8 rows and accumulates the root
// histogram [nch, F, B] int32 in shared memory (at most 3 * 2048 * 4 bytes),
// flushed once per block with global atomicAdd. Integer sums make every
// order exact. The one-hot MXU contraction of the TPU kernel is not needed.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
max_kernel(const float* __restrict__ score, const float* __restrict__ aux,
           const float* __restrict__ bag, int n, lgbt::GradSpec sp,
           int const_hess, unsigned int* __restrict__ mx) {
  __shared__ float red[32];
  float mg = 0.0f, mh = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float grad, hess;
    lgbt::grad_rows(sp, score[i], aux[i], grad, hess);
    const float b = bag[i];
    const float g = __fmul_rn(grad, b), h = __fmul_rn(hess, b);
    mg = fmaxf(mg, fabsf(g));
    mh = fmaxf(mh, const_hess ? h : fabsf(h));
  }
  mg = block_max(mg, red);
  mh = block_max(mh, red);
  if (threadIdx.x == 0) {
    // canonical +0 for an all-zero block, so the uint compare stays monotone
    if (!(mg > 0.0f)) mg = 0.0f;
    if (!(mh > 0.0f)) mh = 0.0f;
    atomicMax(mx, __float_as_uint(mg));
    atomicMax(mx + 1, __float_as_uint(mh));
  }
}

__device__ __forceinline__ int quantize(float x, float mul, float u) {
  const float q = floorf(__fadd_rn(__fmul_rn(x, mul), u));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(kThreads)
quant_hist_kernel(const uint8_t* __restrict__ bins_T,
                  const float* __restrict__ score,
                  const float* __restrict__ aux, const float* __restrict__ bag,
                  int n, int f, int b, lgbt::GradSpec sp, int const_hess,
                  unsigned int seed, const unsigned int* __restrict__ mx,
                  int8_t* __restrict__ gq, int8_t* __restrict__ hq,
                  int8_t* __restrict__ cq, float* __restrict__ scales,
                  int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int nch = const_hess ? 2 : 3;
  const int fb = f * b;
  for (int k = threadIdx.x; k < nch * fb; k += blockDim.x) sh[k] = 0;
  __syncthreads();

  const float mg = __uint_as_float(mx[0]), mh = __uint_as_float(mx[1]);
  const float scale_g = fmaxf(mg, 1e-20f);
  const float scale_h = const_hess ? __fmul_rn(127.0f, mh) : fmaxf(mh, 1e-20f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scales[0] = scale_g;
    scales[1] = scale_h;
  }
  const float mul_g = __fdiv_rn(127.0f, scale_g);
  const float mul_h = __fdiv_rn(127.0f, scale_h);

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float grad, hess;
    lgbt::grad_rows(sp, score[i], aux[i], grad, hess);
    const float bg = bag[i];
    const float g = __fmul_rn(grad, bg), h = __fmul_rn(hess, bg);
    const int gi = quantize(g, mul_g, lgbt::sr_dither(i, seed, 1u));
    const int ci = bg > 0.0f ? 1 : 0;
    gq[i] = static_cast<int8_t>(gi);
    cq[i] = static_cast<int8_t>(ci);
    int hi = 0;
    if (!const_hess) {
      hi = quantize(h, mul_h, lgbt::sr_dither(i, seed, 2u));
      hq[i] = static_cast<int8_t>(hi);
    }
    for (int j = 0; j < f; ++j) {
      const int bin = bins_T[static_cast<size_t>(j) * n + i];
      if (bin >= b) continue;
      int* cell = sh + j * b + bin;
      if (gi) atomicAdd(cell, gi);
      if (hi) atomicAdd(cell + fb, hi);
      if (ci) atomicAdd(cell + (nch - 1) * fb, ci);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nch * fb; k += blockDim.x) {
    const int v = sh[k];
    if (v) atomicAdd(hist + k, v);
  }
}

}  // namespace

// mx [2] u32 and hist [nch * F * B] i32 must be zero on entry; hq may be null
// when const_hess is set. Returns cudaGetLastError() after the two launches.
extern "C" int lgbt_grad_quant_hist0(
    const uint8_t* bins_T, const float* score, const float* aux,
    const float* bag, int n, int f, int b, int kind, float sigmoid,
    float sig2, float lw_pos, float lw_neg, int const_hess, unsigned int seed,
    unsigned int* mx, int8_t* gq, int8_t* hq, int8_t* cq, float* scales,
    int* hist, int grid, cudaStream_t stream) {
  const lgbt::GradSpec sp{kind, sigmoid, sig2, lw_pos, lw_neg};
  max_kernel<<<grid, kThreads, 0, stream>>>(score, aux, bag, n, sp, const_hess,
                                            mx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = const_hess ? 2 : 3;
  const size_t smem = static_cast<size_t>(nch) * f * b * sizeof(int);
  quant_hist_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, score, aux, bag, n, f, b, sp, const_hess, seed, mx, gq, hq, cq,
      scales, hist);
  return static_cast<int>(cudaGetLastError());
}
