// Fused level pass: route every row through its leaf's split and build the
// level's slot histogram from the int8 quantized channels.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// hist_routed_fused_multi_q8 (:574), kernel body _kernel_q8_fused (:454),
// in two entries: this one, the live single-level pass (D = 1,
// hist_routed_fused_q8 :676), and hist_routed_fused_multi.cu, the replay of
// D > 1 known levels in one call; numerical and categorical splits (the
// has_cat branch, :533-543).
//
// Bound on the H100: bytes. Every row reads its leaf id (4 B) and, when its
// leaf splits, the bin of the split feature (1 B), and writes its new leaf
// id (4 B); the kept rows (the smaller children) read their F bins and nch
// int8 channels; the [S, nch, F, B] int32 histogram is written once. In
// practice the shared-memory atomics (nch per kept row and feature) and the
// gather of each row's split bin (a 32-byte sector of bins_T a row where
// neighbouring rows split on different features) bound it.
//
// Design: route_level.cu's routing fused in front of hist_q8.cu's design
// (slot_hist.cuh). The TPU decoded each row's split with a one-hot
// [L, C] x [8, L] HIGHEST-precision MXU product and contracted a [F*B, C]
// one-hot against a [S*nch, C] weight block; here:
// 1. route + count (hist_routed_count_kernel), slot_hist.cuh route_count,
//    the launch of route_level.cu: one row a thread in 256-thread blocks,
//    the int32 route tables in shared memory (six [L] rows, 6 KB at
//    L = 255; on a level with a categorical split also the is_cat row and
//    the [L, W] membership bitset, 15.3 KB in all at B = 256; larger
//    tables are read from global memory); each row is routed with
//    lgbt::route_row (a categorical leaf sends a row left iff its bin's
//    bit is set), its new leaf id and its slot (the [N] scratch slot
//    vector) written, and the kept rows counted per slot (block-local
//    counts, warp-aggregated with __match_any_sync, one global atomic per
//    slot and block) into the first S words of idx. Every row's split bin
//    is read once a call. One slot (a first level) is routed but not
//    counted: its range starts at 0.
// 2. slot_hist_launch given those counts: scan (skipped at one slot,
//    a first level), scatter of each kept row into its slot's range of
//    packed records (its F bins from the row-major [N, F] bins, then one
//    word of int8 g, h, count: 32 B at F = 28), and histogram blocks that
//    add equal ranges of the slot-ordered records into one slot's whole
//    shared [nch, F, B] table (21,504 B at F = 28, B = 64, nch 3; two
//    1024-thread blocks an SM, the fastest of the sweep in slot_hist.cuh).
// The kernels carry this source's names, so that a profile attributes every
// launch to this kernel. Integer sums make every order exact: hist and lid2
// equal the plain version bit for bit.
#include "slot_hist.cuh"

namespace {

using lgbt::kSlotThreads;

__global__ void __launch_bounds__(lgbt::kRouteThreads)
hist_routed_count_kernel(const uint8_t* __restrict__ bins_T,
                         const int* __restrict__ lid,
                         const int* __restrict__ tab_g,
                         const uint32_t* __restrict__ bits_g, int w,
                         const int* __restrict__ na_bin, int n, int f, int l,
                         int s, int tab_smem, bool counting,
                         int* __restrict__ slot, int* __restrict__ lid2,
                         int* __restrict__ counts) {
  lgbt::route_count(bins_T, lid, tab_g, bits_g, w, na_bin, n, f, l, s,
                    tab_smem, counting, slot, lid2, counts);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_routed_scan_kernel(const int* __restrict__ counts, int s, int n,
                        int* __restrict__ off, int* __restrict__ cursor) {
  lgbt::slot_scan(counts, s, n, off, cursor);
}

// eight blocks an SM (at most 32 registers), as hist_q8.cu's scatter
__global__ void __launch_bounds__(lgbt::kScatterThreads, 8)
hist_routed_scatter_kernel(const uint8_t* __restrict__ bins,
                           const int8_t* __restrict__ gq,
                           const int8_t* __restrict__ hq,
                           const int8_t* __restrict__ cq,
                           const int* __restrict__ slot, int n, int f,
                           int ld, int col0, int s,
                           int* __restrict__ cursor,
                           const int* __restrict__ end,
                           uint32_t* __restrict__ rec) {
  lgbt::slot_scatter<int8_t>(bins, gq, hq, cq, slot, n, f, ld, col0, s,
                             cursor, end, rec);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_routed_kernel(const uint8_t* __restrict__ bins_T,
                   const int8_t* __restrict__ gq,
                   const int8_t* __restrict__ hq,
                   const int8_t* __restrict__ cq, const int* __restrict__ off,
                   const uint32_t* __restrict__ rec, int n, int f, int b,
                   int s, int nch, int fg, int min_rows,
                   int* __restrict__ hist) {
  lgbt::slot_hist<int8_t>(bins_T, gq, hq, cq, off, rec, n, f, b, s, nch, fg,
                          min_rows, hist);
}

}  // namespace

// tab [6, L] i32, or [7, L] with the is_cat row when bits is not null;
// bits [L, w] u32 membership words of the categorical leaves, or null on a
// level without a categorical split; bins the row-major [N, F] matrix of
// bins_T; hq is null when nch == 2. hist [S, nch, F, B] i32 and idx
// [3S + 1] i32 zero on entry; slot [N] i32 and rec [n, rec_words] u32
// scratch; lid2 [N] i32 out. Grid and range sizes from
// ops/hist_kernels.py slot_hist_plan. Returns the first launch error, or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int lgbt_hist_routed_fused(
    const uint8_t* bins_T, const uint8_t* bins, const int8_t* gq,
    const int8_t* hq, const int8_t* cq, const int* lid, const int* tab,
    const uint32_t* bits, int w, const int* na_bin, int n, int f, int b,
    int l, int s, int nch, int fg, int blocks, int min_rows, int pass_blocks,
    int* slot, int* idx, uint32_t* rec, int rec_words, int* hist, int* lid2,
    cudaStream_t stream) {
  if ((nch != 2 && nch != 3) || s < 1 || l < 0 || (bits && w < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = lgbt::slot_hist_check<int8_t>(true, bins, n, f, f, 0, b, nch,
                                               fg, blocks, min_rows,
                                               pass_blocks, rec_words);
  if (rc != cudaSuccess) return rc;
  const int err = lgbt::route_count_launch(
      hist_routed_count_kernel, bins_T, lid, tab, bits, w, na_bin, n, f, l,
      s, s > 1, slot, lid2, idx, pass_blocks, stream);
  if (err != cudaSuccess) return err;
  const lgbt::SlotHistKernels<int8_t> k{
      nullptr, hist_routed_scan_kernel, hist_routed_scatter_kernel,
      hist_routed_kernel};
  return lgbt::slot_hist_launch<int8_t>(
      k, bins_T, bins, gq, nch == 3 ? hq : nullptr, cq, slot, idx, n, f, f, 0,
      b, s, nch, fg, blocks, min_rows, pass_blocks, idx, rec, rec_words, hist,
      stream);
}
