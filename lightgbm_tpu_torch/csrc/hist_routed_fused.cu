// Fused level pass: route every row through its leaf's split and build the
// level's slot histogram from the int8 quantized channels.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// hist_routed_fused_q8 (:676) -> hist_routed_fused_multi_q8 (:574), kernel
// body _kernel_q8_fused (:454), for the live single-level pass (D = 1).
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
// 1. route + count (hist_routed_count_kernel), one thread a row, four rows
//    in flight: each block copies the [6, L] int32 tables (feat, thr, dleft,
//    new_leaf, slot_left, slot_right) into shared memory (6 KB at L = 255;
//    larger tables are read from global memory), routes each row with
//    lgbt::route_row, writes its new leaf id and its slot (the [N] scratch
//    slot vector) and counts the kept rows per slot: slot_count with this
//    routing as its source (block-local counts, warp-aggregated with
//    __match_any_sync, one global atomic per slot and block). This is
//    route_level's launch and hist_q8's count pass in one, and every row's
//    split bin is read once a call. One slot (a first level) is routed but
//    not counted: its range starts at 0.
// 2. slot_hist_launch with a null count kernel: scan (skipped at one slot,
//    a first level), scatter of each kept row into its slot's range of
//    packed records (its F bins from the row-major [N, F] bins, then one
//    word of int8 g, h, count: 32 B at F = 28), and histogram blocks that
//    add equal ranges of the slot-ordered records into one slot's whole
//    shared [nch, F, B] table (21,504 B at F = 28, B = 64, nch 3; two
//    1024-thread blocks an SM, the fastest of the sweep in slot_hist.cuh).
// The kernels carry this source's names, so that a profile attributes every
// launch to this kernel. Integer sums make every order exact: hist and lid2
// equal the plain version bit for bit. Categorical membership is outside
// this kernel.
#include "slot_hist.cuh"

namespace {

using lgbt::kSlotThreads;

// The level routing as slot_count's source: at() routes row r and keeps its
// new leaf id in aux; done() writes the row's slot and new leaf id.
struct RouteSource {
  const uint8_t* __restrict__ bins_T;
  const int* tab;   // [6, L], in shared or global memory
  const int* __restrict__ na_bin;
  const int* __restrict__ lid;
  int n, f, l, s;
  int* __restrict__ slot;
  int* __restrict__ lid2;
  __device__ __forceinline__ int at(int r, int& new_leaf) const {
    int sl;
    lgbt::route_row(bins_T, tab, na_bin, n, f, l, s, r, lid[r], sl, new_leaf);
    return sl;
  }
  __device__ __forceinline__ void done(int r, int sl, int new_leaf) const {
    slot[r] = sl;
    lid2[r] = new_leaf;
  }
};

__global__ void __launch_bounds__(kSlotThreads)
hist_routed_count_kernel(const uint8_t* __restrict__ bins_T,
                         const int* __restrict__ lid,
                         const int* __restrict__ tab_g,
                         const int* __restrict__ na_bin, int n, int f, int l,
                         int s, int tab_smem, int* __restrict__ slot,
                         int* __restrict__ lid2, int* __restrict__ counts) {
  // [S] counts when S <= kCountSlots, then the tables when tab_smem
  extern __shared__ int sh[];
  const int* tab = tab_g;
  if (tab_smem) {
    int* tsh = sh + (s <= lgbt::kCountSlots ? s : 0);
    for (int k = threadIdx.x; k < 6 * l; k += blockDim.x) tsh[k] = tab_g[k];
    __syncthreads();
    tab = tsh;
  }
  const RouteSource src{bins_T, tab, na_bin, lid, n, f, l, s, slot, lid2};
  lgbt::slot_count(src, n, s, counts, sh);
}

__global__ void __launch_bounds__(kSlotThreads)
hist_routed_scan_kernel(const int* __restrict__ counts, int s,
                        int* __restrict__ off, int* __restrict__ cursor) {
  lgbt::slot_scan(counts, s, off, cursor);
}

// eight blocks an SM (at most 32 registers), as hist_q8.cu's scatter
__global__ void __launch_bounds__(lgbt::kScatterThreads, 8)
hist_routed_scatter_kernel(const uint8_t* __restrict__ bins,
                           const int8_t* __restrict__ gq,
                           const int8_t* __restrict__ hq,
                           const int8_t* __restrict__ cq,
                           const int* __restrict__ slot, int n, int f, int s,
                           int* __restrict__ cursor,
                           uint32_t* __restrict__ rec) {
  lgbt::slot_scatter<int8_t>(bins, gq, hq, cq, slot, n, f, s, cursor, rec);
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

// tab [6, L] i32; bins the row-major [N, F] matrix of bins_T; hq is null
// when nch == 2. hist [S, nch, F, B] i32 and idx [3S + 1] i32 zero on entry;
// slot [N] i32 and rec [n, rec_words] u32 scratch; lid2 [N] i32 out. Grid
// and range sizes from ops/hist_kernels.py slot_hist_plan. Returns the first
// launch error, or cudaErrorInvalidValue for arguments it refuses.
extern "C" int lgbt_hist_routed_fused(
    const uint8_t* bins_T, const uint8_t* bins, const int8_t* gq,
    const int8_t* hq, const int8_t* cq, const int* lid, const int* tab,
    const int* na_bin, int n, int f, int b, int l, int s, int nch, int fg,
    int blocks, int min_rows, int pass_blocks, int* slot, int* idx,
    uint32_t* rec, int rec_words, int* hist, int* lid2, cudaStream_t stream) {
  if ((nch != 2 && nch != 3) || s < 1 || l < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = lgbt::slot_hist_check<int8_t>(true, bins, n, f, b, nch, fg,
                                               blocks, min_rows, pass_blocks,
                                               rec_words);
  if (rc != cudaSuccess) return rc;
  const size_t count_smem = s <= lgbt::kCountSlots ? s * sizeof(int) : 0;
  const size_t tab_bytes = static_cast<size_t>(6) * l * sizeof(int);
  const int tab_smem = count_smem + tab_bytes <= lgbt::kSmemBudget ? 1 : 0;
  const size_t smem = count_smem + (tab_smem ? tab_bytes : 0);
  cudaError_t err = lgbt::allow_smem(hist_routed_count_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_routed_count_kernel<<<pass_blocks, kSlotThreads, smem, stream>>>(
      bins_T, lid, tab, na_bin, n, f, l, s, tab_smem, slot, lid2, idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const lgbt::SlotHistKernels<int8_t> k{
      nullptr, hist_routed_scan_kernel, hist_routed_scatter_kernel,
      hist_routed_kernel};
  return lgbt::slot_hist_launch<int8_t>(
      k, bins_T, bins, gq, nch == 3 ? hq : nullptr, cq, slot, n, f, b, s, nch,
      fg, blocks, min_rows, pass_blocks, idx, rec, rec_words, hist, stream);
}
