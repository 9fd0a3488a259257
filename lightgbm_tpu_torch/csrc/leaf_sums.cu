// Exact per-leaf (grad, hess, count) sums of materialized rows: the leaf
// renewal of the quantized depthwise grower when the gradients are not
// recomputed in the kernel (the unfused front, F * B > 2048).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py leaf_sums_pallas
// (:718), kernel body _leaf_sums_kernel (:693).
//
// Bound on the H100: bytes. It reads g/h/c [N] f32 and lid [N] i32 (16
// bytes a row: 168 MB at N = 10.5M, 0.050 ms at 3.35 TB/s) and writes a
// [3, L] table.
//
// Design: the TPU split g/h into bf16 hi/lo halves and contracted them with
// a one-hot [L, C] leaf mask on the MXU, which keeps about 16 mantissa bits
// per row. Here each row adds its f32 g, h and c, widened to f64, into a
// block-private [3, L] f64 table in shared memory (L = 255: 6 KB), flushed
// once per block with global f64 atomicAdd (lgbt::leaf_add / leaf_flush,
// shared with leaf_sums_grad.cu); the caller rounds the f64 table to f32
// once. The sums are at least as accurate as the reference's; their atomic
// order varies from run to run only below f64 resolution. Leaf ids outside
// [0, L) are dropped. Tables too large for shared memory accumulate in
// global memory.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
leaf_sums_rows_kernel(const float* __restrict__ g,
                      const float* __restrict__ h,
                      const float* __restrict__ c,
                      const int* __restrict__ lid, int n, int l, int use_smem,
                      double* __restrict__ out) {
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
    lgbt::leaf_add(acc, l, lf, g[i], h[i], c[i]);
  }
  if (!use_smem) return;
  __syncthreads();
  lgbt::leaf_flush(shd, l, out);
}

}  // namespace

// out [3, L] f64 zero on entry. Returns cudaGetLastError() after the launch.
extern "C" int lgbt_leaf_sums(const float* g, const float* h, const float* c,
                              const int* lid, int n, int l, double* out,
                              int grid, cudaStream_t stream) {
  const size_t need = static_cast<size_t>(3) * l * sizeof(double);
  const int use_smem = need <= lgbt::kSmemBudget ? 1 : 0;
  const size_t smem = use_smem ? need : 0;
  const cudaError_t err = lgbt::allow_smem(leaf_sums_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf_sums_rows_kernel<<<grid, kThreads, smem, stream>>>(g, h, c, lid, n, l,
                                                          use_smem, out);
  return static_cast<int>(cudaGetLastError());
}
