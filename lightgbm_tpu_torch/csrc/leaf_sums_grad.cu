// Exact per-leaf (grad, hess, count) sums with the gradients recomputed from
// (score, aux, bag): the leaf renewal of the quantized depthwise grower.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// leaf_sums_grad_pallas (:1036), kernel body _leaf_sums_grad_kernel (:1005).
//
// Bound on the H100: bytes. It reads score/aux/bag [N] f32 and lid [N] i32
// (16 bytes a row) and writes a [3, L] table.
//
// Design: the TPU split g/h into bf16 hi/lo halves and contracted them with
// a one-hot [L, C] leaf mask on the MXU, which keeps about 16 mantissa bits
// per row. Here each row adds its f32 g, h and count, widened to f64, into a
// block-private [3, L] f64 table in shared memory (L = 255: 6 KB), flushed
// once per block with global f64 atomicAdd; the caller rounds the f64 table
// to f32 once. The sums are therefore at least as accurate as the
// reference's; their atomic order varies from run to run only below f64
// resolution. Tables too large for shared memory accumulate in global memory.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
leaf_sums_kernel(const float* __restrict__ score,
                 const float* __restrict__ aux, const float* __restrict__ bag,
                 const int* __restrict__ lid, int n, int l, lgbt::GradSpec sp,
                 int use_smem, double* __restrict__ out) {
  extern __shared__ double shd[];
  double* acc = use_smem ? shd : out;
  if (use_smem) {
    for (int k = threadIdx.x; k < 3 * l; k += blockDim.x) shd[k] = 0.0;
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int lf = lid[i];
    if (lf < 0 || lf >= l) continue;
    float grad, hess;
    lgbt::grad_rows(sp, score[i], aux[i], grad, hess);
    const float b = bag[i];
    lgbt::leaf_add(acc, l, lf, __fmul_rn(grad, b), __fmul_rn(hess, b),
                   b > 0.0f ? 1.0f : 0.0f);
  }
  if (!use_smem) return;
  __syncthreads();
  lgbt::leaf_flush(shd, l, out);
}

}  // namespace

// out [3, L] f64 zero on entry. Returns cudaGetLastError() after the launch.
extern "C" int lgbt_leaf_sums_grad(const float* score, const float* aux,
                                   const float* bag, const int* lid, int n,
                                   int l, int kind, float sigmoid, float sig2,
                                   float lw_pos, float lw_neg, double* out,
                                   int grid, cudaStream_t stream) {
  const lgbt::GradSpec sp{kind, sigmoid, sig2, lw_pos, lw_neg};
  const size_t need = static_cast<size_t>(3) * l * sizeof(double);
  const int use_smem = need <= lgbt::kSmemBudget ? 1 : 0;
  const size_t smem = use_smem ? need : 0;
  const cudaError_t err = lgbt::allow_smem(leaf_sums_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf_sums_kernel<<<grid, kThreads, smem, stream>>>(score, aux, bag, lid, n,
                                                     l, sp, use_smem, out);
  return static_cast<int>(cudaGetLastError());
}
