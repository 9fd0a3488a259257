// Fused level pass: route every row through its leaf's split and build the
// level's slot histogram from the int8 quantized channels.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// hist_routed_fused_q8 (:676) -> hist_routed_fused_multi_q8 (:574), kernel
// body _kernel_q8_fused (:454), for the live single-level pass (D = 1).
//
// Bound on the H100: bytes for the data (bins_T [F, N] u8, gq/hq/cq [N] i8,
// lid [N] i32 in, lid2 [N] i32 out), but in practice the shared-memory
// atomics: every routed row adds nch channels into F cells.
//
// Design: the TPU decoded each row's split with a one-hot [L, C] x [8, L]
// HIGHEST-precision MXU product and contracted a [F*B, C] one-hot against a
// [S*nch, C] weight block. Here each thread reads its row's split straight
// from the [6, L] int32 route tables (feat, thr, dleft, new_leaf, slot_left,
// slot_right) and adds its int8 channels to the matching cells. The
// [S, nch, F, B] int32 accumulator does not fit shared memory whole (2.7 MB at
// S = 127, F * B = 1792), so the grid is (row chunk, feature group): a block
// privatizes the histogram of fg features, fg sized by the caller so that
// S * nch * fg * B * 4 bytes fit in shared memory, and flushes it once with
// global atomicAdd. Every block of a chunk routes the same rows; only feature
// group 0 writes lid2. When not even one feature fits (use_smem = 0) the
// block adds straight into the global histogram. Integer sums make every
// order exact. Categorical membership is outside this kernel.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
routed_hist_kernel(const uint8_t* __restrict__ bins_T,
                   const int8_t* __restrict__ gq,
                   const int8_t* __restrict__ hq,
                   const int8_t* __restrict__ cq,
                   const int* __restrict__ lid, const int* __restrict__ tab,
                   const int* __restrict__ na_bin, int n, int f, int b, int l,
                   int s, int nch, int fg, int rows_per_block, int use_smem,
                   int* __restrict__ hist, int* __restrict__ lid2) {
  extern __shared__ int sh[];
  const int f0 = blockIdx.y * fg;
  const int fcnt = min(fg, f - f0);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long row1 = min(static_cast<long long>(n), row0 + rows_per_block);
  // accumulator layout [S][nch][width][B]: width fg in shared memory, F in
  // the global histogram
  const int width = use_smem ? fg : f;
  const int ch_stride = width * b;
  int* acc = use_smem ? sh : hist;
  const int fofs = use_smem ? 0 : f0;
  if (use_smem) {
    const int total = s * nch * fg * b;
    for (int k = threadIdx.x; k < total; k += blockDim.x) sh[k] = 0;
    __syncthreads();
  }

  for (long long rr = row0 + threadIdx.x; rr < row1; rr += blockDim.x) {
    const int r = static_cast<int>(rr);
    int slot, nl;
    lgbt::route_row(bins_T, tab, na_bin, n, f, l, s, r, lid[r], slot, nl);
    if (blockIdx.y == 0) lid2[r] = nl;
    if (slot < 0 || slot >= s) continue;
    int* base = acc + static_cast<size_t>(slot) * nch * ch_stride + fofs * b;
    lgbt::add_row<int>(base, ch_stride, nch,
                       bins_T + static_cast<size_t>(f0) * n + r, n, fcnt, b,
                       gq[r], nch == 3 ? hq[r] : 0, cq[r]);
  }
  if (!use_smem) return;
  __syncthreads();
  lgbt::flush_hist(sh, s, nch, fg, fcnt, b, 0, f0, f, hist);
}

}  // namespace

// tab [6, L] i32; hist [S, nch, F, B] i32 zero on entry; hq may be null when
// nch == 2. Returns cudaGetLastError() after the launch.
extern "C" int lgbt_hist_routed_fused(
    const uint8_t* bins_T, const int8_t* gq, const int8_t* hq,
    const int8_t* cq, const int* lid, const int* tab, const int* na_bin, int n,
    int f, int b, int l, int s, int nch, int fg, int use_smem, int n_chunks,
    int* hist, int* lid2, cudaStream_t stream) {
  const int rows_per_block = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(n_chunks, (f + fg - 1) / fg);
  const size_t smem =
      use_smem ? static_cast<size_t>(s) * nch * fg * b * sizeof(int) : 0;
  const cudaError_t err = lgbt::allow_smem(routed_hist_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_hist_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, gq, hq, cq, lid, tab, na_bin, n, f, b, l, s, nch, fg,
      rows_per_block, use_smem, hist, lid2);
  return static_cast<int>(cudaGetLastError());
}
