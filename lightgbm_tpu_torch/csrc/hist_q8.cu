// Slot histogram from int8 quantized channels over a precomputed slot
// vector: the root pass (one slot, no slot vector) and the second pass of
// every level on data too wide for the fused level pass (F * B > 2048).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py hist_pallas_q8
// (:372), kernel body _kernel_q8 (:266); the caller dequantizes the int32
// sums as _dequant_stack (:349) does.
//
// Bound on the H100: bytes. It reads bins_T [F, N] u8, gq/hq/cq [N] i8 and
// slot [N] i32 once (at N = 10.5M, F = 28: 378 MB, 0.113 ms at 3.35 TB/s)
// and writes the [S, nch, F, B] int32 histogram once. In practice the
// shared-memory atomics (nch per kept row and feature) and the re-reads of
// the row channels per tile bound it.
//
// Design: the TPU contracted a [F*B, C] one-hot against a [S*nch, C] weight
// block on the MXU. Here each thread takes a row and adds its int8 channels
// to the cells of its (slot, feature, bin). At B = 256 one slot of one
// feature is nch * 1 KB, so the level pass at S = 127 (390 KB a feature at
// nch = 3) does not fit one block's shared memory: the grid is (feature
// group, slot tile, row chunk). A block privatizes the histogram of fg
// features x ss slots (sized by the caller to fit shared memory), walks its
// row chunk, skips rows whose slot lies outside its tile (and the rows of
// the dropped slots >= S), and flushes once with global atomicAdd. The
// feature group and slot tile vary fastest in the grid, so the blocks that
// re-read one row chunk run together and find it in L2. A null slot vector
// puts every row in slot 0. Integer sums make every order exact.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
hist_q8_kernel(const uint8_t* __restrict__ bins_T,
               const int8_t* __restrict__ gq, const int8_t* __restrict__ hq,
               const int8_t* __restrict__ cq, const int* __restrict__ slot,
               int n, int f, int b, int s, int nch, int fg, int ss,
               int rows_per_block, int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int f0 = blockIdx.x * fg;
  const int fcnt = min(fg, f - f0);
  const int s0 = blockIdx.y * ss;
  const int s1 = min(s, s0 + ss);
  const long long row0 = static_cast<long long>(blockIdx.z) * rows_per_block;
  const long long row1 = min(static_cast<long long>(n), row0 + rows_per_block);
  // block-private accumulator [ss][nch][fg][B]
  const int ch_stride = fg * b;
  const int total = ss * nch * fg * b;
  for (int k = threadIdx.x; k < total; k += blockDim.x) sh[k] = 0;
  __syncthreads();

  const uint8_t* col0 = bins_T + static_cast<size_t>(f0) * n;
  for (long long rr = row0 + threadIdx.x; rr < row1; rr += blockDim.x) {
    const int r = static_cast<int>(rr);
    const int sl = slot ? slot[r] : 0;
    if (sl < s0 || sl >= s1) continue;
    int* base = sh + static_cast<size_t>(sl - s0) * nch * ch_stride;
    lgbt::add_row<int>(base, ch_stride, nch, col0 + r, n, fcnt, b, gq[r],
                       nch == 3 ? hq[r] : 0, cq[r]);
  }
  __syncthreads();
  lgbt::flush_hist(sh, ss, nch, fg, fcnt, b, s0, f0, f, hist);
}

}  // namespace

// slot may be null (every row in slot 0); hq may be null when nch == 2.
// hist [S, nch, F, B] i32 zero on entry. fg features and ss slots a block,
// n_chunks row chunks. Returns cudaGetLastError() after the launch.
extern "C" int lgbt_hist_q8(const uint8_t* bins_T, const int8_t* gq,
                            const int8_t* hq, const int8_t* cq,
                            const int* slot, int n, int f, int b, int s,
                            int nch, int fg, int ss, int n_chunks, int* hist,
                            cudaStream_t stream) {
  const int rows_per_block = (n + n_chunks - 1) / n_chunks;
  const dim3 grid((f + fg - 1) / fg, (s + ss - 1) / ss, n_chunks);
  const size_t smem = static_cast<size_t>(ss) * nch * fg * b * sizeof(int);
  if (smem > lgbt::kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lgbt::allow_smem(hist_q8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_q8_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, gq, hq, cq, slot, n, f, b, s, nch, fg, ss, rows_per_block,
      hist);
  return static_cast<int>(cudaGetLastError());
}
