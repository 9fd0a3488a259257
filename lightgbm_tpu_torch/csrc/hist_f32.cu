// Slot histogram of f32 row channels (g, h, count) over a precomputed slot
// vector: the unquantized root pass (one slot, no slot vector), the second
// pass of every unquantized depthwise level, and the smaller child's pass of
// every leaf-wise (lossguide) split.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py hist_pallas
// (:114), kernel body _kernel (:59), and hist_leaf_pallas (:175), which calls
// it with one slot.
//
// Bound on the H100: bytes. It must read the slot vector [N] i32 once and,
// for the kept rows only, their F bins and three f32 channels, and write the
// [S, 3, F, B] f32 histogram: at N = 10.5M, F = 28 the root reads 294 + 126
// MB (0.125 ms at 3.35 TB/s). In practice the shared-memory atomics (three
// per kept row and feature) bound it.
//
// Design: slot_hist.cuh, the design of hist_q8.cu (B5) with float cells:
// kept rows are grouped by slot into packed records (the bins and the three
// channel words), and each block adds its range of records into one slot's
// whole shared table. The TPU built a [Fg*B, C] one-hot, contracted it on
// the MXU and split g and h into bf16 hi and lo halves to get f32 sums out
// of a bf16 unit; none of that is needed here. Atomics make the f32
// summation order vary from run to run: a cell is summed first in its
// block's shared copy, over the block's range, and then across blocks, so
// each row's value enters an f32 sum unrounded and the error stays far below
// the 2^-15 of the cell's absolute mass that the hi/lo split allows. Sums of
// integers and of values on a coarse grid (counts, or gradients on a 1/8
// grid) are exact in any order.
#include "slot_hist.cuh"

namespace {

using lgbt::kSlotThreads;

__global__ void __launch_bounds__(kSlotThreads)
hist_f32_count_kernel(const int* __restrict__ slot, int n, int s,
                      int* __restrict__ counts) {
  extern __shared__ int sh[];   // [S] counts
  lgbt::slot_count(slot, n, s, counts, sh);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_f32_scan_kernel(const int* __restrict__ counts, int s, int n,
                     int* __restrict__ off, int* __restrict__ cursor) {
  lgbt::slot_scan(counts, s, n, off, cursor);
}

// eight blocks an SM (at most 32 registers), so that some blocks' tiles
// wait at their barriers while the others' run
__global__ void __launch_bounds__(lgbt::kScatterThreads, 8)
hist_f32_scatter_kernel(const uint8_t* __restrict__ bins,
                        const float* __restrict__ g,
                        const float* __restrict__ h,
                        const float* __restrict__ c,
                        const int* __restrict__ slot, int n, int f, int ld,
                        int col0, int s,
                        int* __restrict__ cursor,
                        const int* __restrict__ end,
                        uint32_t* __restrict__ rec) {
  lgbt::slot_scatter<float>(bins, g, h, c, slot, n, f, ld, col0, s, cursor,
                            end, rec);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_f32_kernel(const uint8_t* __restrict__ bins_T,
                const float* __restrict__ g, const float* __restrict__ h,
                const float* __restrict__ c, const int* __restrict__ off,
                const uint32_t* __restrict__ rec, int n, int f, int b, int s,
                int nch, int fg, int min_rows, float* __restrict__ hist) {
  // nch is 3 (checked at the launch); the literal lets the compiler fold
  // the count channel's offset
  lgbt::slot_hist<float>(bins_T, g, h, c, off, rec, n, f, b, s, 3, fg,
                         min_rows, hist);
}

}  // namespace

// slot may be null (every row in slot 0); bins, a row-major matrix of ld
// bytes a row whose columns [col0, col0 + F) are bins_T [F, N] (the whole
// [N, F] matrix at col0 0 and ld F, or a feature tile read in place), is
// read with a slot vector only. nch must be 3. counts [S]
// i32, when not null (with a slot vector), are the kept rows of each slot
// (route_level.cu's), and the count pass does not run. hist [S, 3, F, B]
// f32 zero on entry; idx [3S + 1] i32 zero on entry unless counts are given
// over S > 1 slots; rec [n, rec_words] u32 scratch (unused without a slot
// vector). Grid and range sizes from ops/hist_kernels.py slot_hist_plan.
// Returns the first launch error, or cudaErrorInvalidValue for arguments it
// refuses.
extern "C" int lgbt_hist_f32(const uint8_t* bins_T, const uint8_t* bins,
                             const float* g, const float* h, const float* c,
                             const int* slot, const int* counts, int n, int f,
                             int ld, int col0, int b, int s, int nch, int fg,
                             int blocks,
                             int min_rows, int pass_blocks, int* idx,
                             uint32_t* rec, int rec_words, float* hist,
                             cudaStream_t stream) {
  if (nch != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = lgbt::slot_hist_check<float>(
      slot != nullptr, bins, n, f, ld, col0, b, nch, fg, blocks, min_rows,
      pass_blocks, rec_words);
  if (rc != cudaSuccess) return rc;
  const lgbt::SlotHistKernels<float> k{
      hist_f32_count_kernel, hist_f32_scan_kernel, hist_f32_scatter_kernel,
      hist_f32_kernel};
  return lgbt::slot_hist_launch<float>(k, bins_T, bins, g, h, c, slot,
                                       counts, n, f, ld, col0, b, s, nch, fg,
                                       blocks, min_rows, pass_blocks, idx,
                                       rec, rec_words, hist, stream);
}
