// Slot histogram from int8 quantized channels over a precomputed slot
// vector: the root pass (one slot, no slot vector) and the second pass of
// every level on data too wide for the fused level pass (F * B > 2048).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py hist_pallas_q8
// (:372), kernel body _kernel_q8 (:266); the caller dequantizes the int32
// sums as _dequant_stack (:349) does.
//
// Bound on the H100: bytes. It must read the slot vector [N] i32 once and,
// for the kept rows only, their F bins and nch int8 channels, and write the
// [S, nch, F, B] int32 histogram (at N = 10.5M, F = 28 the root reads 326
// MB, 0.097 ms at 3.35 TB/s). In practice the shared-memory atomics (nch per
// kept row and feature) bound it.
//
// Design: slot_hist.cuh, shared with hist_f32.cu (B8) with int cells: kept
// rows are grouped by slot into packed records (the bins and one word of
// int8 g, h, count), and each block adds its range of records into one
// slot's whole shared table. The TPU contracted a [F*B, C] one-hot against a
// [S*nch, C] weight block on the MXU; atomics do that job here. Integer sums
// make every order exact.
#include "slot_hist.cuh"

namespace {

using lgbt::kSlotThreads;

__global__ void __launch_bounds__(kSlotThreads)
hist_q8_count_kernel(const int* __restrict__ slot, int n, int s,
                     int* __restrict__ counts) {
  lgbt::slot_count(slot, n, s, counts);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_q8_scan_kernel(const int* __restrict__ counts, int s,
                    int* __restrict__ off, int* __restrict__ cursor) {
  lgbt::slot_scan(counts, s, off, cursor);
}

// eight blocks an SM (at most 32 registers), so that some blocks' tiles
// wait at their barriers while the others' run
__global__ void __launch_bounds__(lgbt::kScatterThreads, 8)
hist_q8_scatter_kernel(const uint8_t* __restrict__ bins,
                       const int8_t* __restrict__ gq,
                       const int8_t* __restrict__ hq,
                       const int8_t* __restrict__ cq,
                       const int* __restrict__ slot, int n, int f, int s,
                       int* __restrict__ cursor, uint32_t* __restrict__ rec) {
  lgbt::slot_scatter<int8_t>(bins, gq, hq, cq, slot, n, f, s, cursor, rec);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_q8_kernel(const uint8_t* __restrict__ bins_T,
               const int8_t* __restrict__ gq, const int8_t* __restrict__ hq,
               const int8_t* __restrict__ cq, const int* __restrict__ off,
               const uint32_t* __restrict__ rec, int n, int f, int b, int s,
               int nch, int fg, int min_rows, int* __restrict__ hist) {
  lgbt::slot_hist<int8_t>(bins_T, gq, hq, cq, off, rec, n, f, b, s, nch, fg,
                          min_rows, hist);
}

}  // namespace

// slot may be null (every row in slot 0); bins, the row-major [N, F] matrix
// of bins_T, is read with a slot vector only; hq is null when nch == 2. hist
// [S, nch, F, B] i32 and idx [3S + 1] i32 zero on entry; rec [n, rec_words]
// u32 scratch (unused without a slot vector). Grid and range sizes from
// ops/hist_kernels.py slot_hist_plan. Returns the first launch error.
extern "C" int lgbt_hist_q8(const uint8_t* bins_T, const uint8_t* bins,
                            const int8_t* gq, const int8_t* hq,
                            const int8_t* cq, const int* slot, int n,
                            int f, int b, int s, int nch, int fg, int blocks,
                            int min_rows, int pass_blocks, int* idx,
                            uint32_t* rec, int rec_words, int* hist,
                            cudaStream_t stream) {
  if (nch != 2 && nch != 3) return static_cast<int>(cudaErrorInvalidValue);
  const lgbt::SlotHistKernels<int8_t> k{
      hist_q8_count_kernel, hist_q8_scan_kernel, hist_q8_scatter_kernel,
      hist_q8_kernel};
  return lgbt::slot_hist_launch<int8_t>(
      k, bins_T, bins, gq, nch == 3 ? hq : nullptr, cq, slot, n, f, b, s, nch,
      fg, blocks, min_rows, pass_blocks, idx, rec, rec_words, hist, stream);
}
