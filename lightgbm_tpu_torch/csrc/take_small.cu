// Small-table gather: out[i] = table[idx[i]], 0 where idx is out of range.
// It is the per-tree score update (leaf value of each row's leaf).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py take_small_pallas
// (:1213), kernel body _take_kernel (:1199).
//
// Bound on the H100: bytes (4 in + 4 out a row; the table is at most 16 KB).
//
// Design: the TPU had no hardware gather and expressed the lookup as a
// HIGHEST-precision one-hot [L, C] contraction. Here the table is a cached
// global read and each thread moves its rows directly; the loaded f32 value
// is the table entry itself, so the result is bit-exact.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
take_kernel(const float* __restrict__ table, const int* __restrict__ idx,
            int n, int l, float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k = idx[i];
    out[i] = (k >= 0 && k < l) ? __ldg(table + k) : 0.0f;
  }
}

}  // namespace

extern "C" int lgbt_take_small(const float* table, const int* idx, int n,
                               int l, float* out, int grid,
                               cudaStream_t stream) {
  take_kernel<<<grid, kThreads, 0, stream>>>(table, idx, n, l, out);
  return static_cast<int>(cudaGetLastError());
}
