// Exact per-leaf (grad, hess, count) sums with the gradients recomputed from
// (score, aux, bag): the leaf renewal of the quantized depthwise grower on
// the fused front.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// leaf_sums_grad_pallas (:1036), kernel body _leaf_sums_grad_kernel (:1005).
//
// Bound on the H100: bytes. It reads score/aux/bag [N] f32 and lid [N] i32
// (16 bytes a row: 168 MB at N = 10.5M, 0.050 ms at 3.35 TB/s) and writes
// a [3, L] table; the logloss gradient's few dozen f32 operations a row
// stay far below the card's rate.
//
// Design: the TPU split g/h into bf16 hi/lo halves and contracted them with
// a one-hot [L, C] leaf mask on the MXU, which keeps about 16 mantissa bits
// per row. Here g = grad * bag, h = hess * bag and c = (bag > 0) are
// recomputed in registers (lgbt::grad_rows, the reference's f32 operations
// in its order), summed in f64 and rounded once. The first design added
// each row with three shared f64 atomicAdds into one block-shared [3, L]
// table (on sm_90a a compare-and-swap loop each, which contends as a leaf's
// share of the rows grows), read one row a thread, flushed every block's
// table with global f64 atomics, and left the zeroed f64 output and its f32
// cast to two launches of the wrapper; its sums changed from run to run in
// their f64 rounding. Now (leaf_sums.cuh, shared with leaf_sums.cu):
// warp-private tables written without atomics, four rows a thread with
// 16-byte loads, each block's sums written to its own scratch row, and a
// second launch that sums the rows in a fixed order and writes the f32
// output: deterministic at a fixed grid, and the wrapper allocates with
// torch.empty only. Leaf ids outside [0, L) are dropped.
#include "leaf_sums.cuh"

namespace {

using lgbt::GradRows;

__global__ void __launch_bounds__(lgbt::kLeafThreads, 2)
leaf_sums_grad_rows_kernel(GradRows src, const int* __restrict__ lid, int n,
                           int l, double* __restrict__ part) {
  lgbt::leaf_rows(src, lid, n, l, part);
}

__global__ void __launch_bounds__(lgbt::kLeafThreads)
leaf_sums_grad_global_kernel(GradRows src, const int* __restrict__ lid,
                             int n, int l, double* __restrict__ acc) {
  lgbt::leaf_rows_global(src, lid, n, l, acc);
}

__global__ void __launch_bounds__(lgbt::kFinalGroups * lgbt::kFinalCells)
leaf_sums_grad_final_kernel(const double* __restrict__ part, int rows,
                            int cells, float* __restrict__ out) {
  lgbt::leaf_final(part, rows, cells, out);
}

}  // namespace

// part [grid, 3, L] f64 scratch ([3, L] when warps = 0), out [3, L] f32;
// warps and grid from ops/hist_kernels.py leaf_sums_plan. Returns a
// cudaError_t (0 when both launches were accepted).
extern "C" int lgbt_leaf_sums_grad(const float* score, const float* aux,
                                   const float* bag, const int* lid, int n,
                                   int l, int kind, float sigmoid, float sig2,
                                   float lw_pos, float lw_neg, int warps,
                                   int grid, double* part, float* out,
                                   cudaStream_t stream) {
  const lgbt::LeafSumsKernels<GradRows> k{leaf_sums_grad_rows_kernel,
                                          leaf_sums_grad_global_kernel,
                                          leaf_sums_grad_final_kernel};
  const GradRows src{{score, aux, bag},
                     lgbt::GradSpec{kind, sigmoid, sig2, lw_pos, lw_neg}};
  return lgbt::leaf_sums_launch(k, src, lid, n, l, warps, grid, part, out,
                                stream);
}
