// Slot histogram of f32 row channels (g, h, count) over a precomputed slot
// vector: the unquantized root pass (one slot, no slot vector), the second
// pass of every unquantized depthwise level, and the smaller child's pass of
// every leaf-wise (lossguide) split.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py hist_pallas
// (:114), kernel body _kernel (:59), and hist_leaf_pallas (:175), which calls
// it with one slot.
//
// Bound on the H100: bytes. It reads bins_T [F, N] u8, g/h/c [N] f32 and
// slot [N] i32 once and writes the [S, 3, F, B] f32 histogram once: at
// N = 10.5M, F = 28 the root reads 294 + 126 MB (0.125 ms at 3.35 TB/s), a
// level pass at S = 127 reads 294 + 126 + 42 MB and writes 10.9 MB
// (0.141 ms). In practice the shared-memory atomics (three per kept row and
// feature) and the re-reads of the row channels per tile bound it.
//
// Design: the TPU built a [Fg*B, C] one-hot, contracted it on the MXU and
// split g and h into bf16 hi and lo halves to get f32 sums out of a bf16
// unit. None of that is needed here: each thread takes a row and adds its
// f32 channels straight into the cells of its (slot, feature, bin). The
// layout is hist_q8.cu's, with a float cell in place of an int one, so the
// same tiling fits shared memory: the grid is (feature group, slot tile,
// row chunk); a block privatizes fg features x ss slots, walks
// its row chunk, skips rows whose slot lies outside its tile (and the rows
// of the dropped slots >= S and < 0), and flushes once with global
// atomicAdd. Atomics make the f32 summation order vary from run to run: a
// cell is summed first in its block's shared copy, over that block's row
// chunk, and then across the chunks, so each row's value enters an f32 sum
// unrounded and the error stays far below the 2^-15 of the cell's absolute
// mass that the hi/lo split allows. Sums of integers and of values on a
// coarse grid (counts, or gradients on a 1/8 grid) are exact in any order.
// A null slot vector puts every row in slot 0.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
hist_f32_kernel(const uint8_t* __restrict__ bins_T,
                const float* __restrict__ g, const float* __restrict__ h,
                const float* __restrict__ c, const int* __restrict__ slot,
                int n, int f, int b, int s, int fg, int ss,
                int rows_per_block, float* __restrict__ hist) {
  extern __shared__ float shf[];
  const int f0 = blockIdx.x * fg;
  const int fcnt = min(fg, f - f0);
  const int s0 = blockIdx.y * ss;
  const int s1 = min(s, s0 + ss);
  const long long row0 = static_cast<long long>(blockIdx.z) * rows_per_block;
  const long long row1 = min(static_cast<long long>(n), row0 + rows_per_block);
  // block-private accumulator [ss][3][fg][B]
  const int ch_stride = fg * b;
  const int total = ss * 3 * fg * b;
  for (int k = threadIdx.x; k < total; k += blockDim.x) shf[k] = 0.0f;
  __syncthreads();

  const uint8_t* col0 = bins_T + static_cast<size_t>(f0) * n;
  for (long long rr = row0 + threadIdx.x; rr < row1; rr += blockDim.x) {
    const int r = static_cast<int>(rr);
    const int sl = slot ? slot[r] : 0;
    if (sl < s0 || sl >= s1) continue;
    float* base = shf + static_cast<size_t>(sl - s0) * 3 * ch_stride;
    lgbt::add_row<float>(base, ch_stride, 3, col0 + r, n, fcnt, b, g[r], h[r],
                         c[r]);
  }
  __syncthreads();
  lgbt::flush_hist(shf, ss, 3, fg, fcnt, b, s0, f0, f, hist);
}

}  // namespace

// slot may be null (every row in slot 0). hist [S, 3, F, B] f32 zero on
// entry. fg features and ss slots a block, n_chunks row chunks. Returns
// cudaGetLastError() after the launch.
extern "C" int lgbt_hist_f32(const uint8_t* bins_T, const float* g,
                             const float* h, const float* c, const int* slot,
                             int n, int f, int b, int s, int fg, int ss,
                             int n_chunks, float* hist, cudaStream_t stream) {
  const int rows_per_block = (n + n_chunks - 1) / n_chunks;
  const dim3 grid((f + fg - 1) / fg, (s + ss - 1) / ss, n_chunks);
  const size_t smem = static_cast<size_t>(ss) * 3 * fg * b * sizeof(float);
  if (smem > lgbt::kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lgbt::allow_smem(hist_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_f32_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, g, h, c, slot, n, f, b, s, fg, ss, rows_per_block, hist);
  return static_cast<int>(cudaGetLastError());
}
