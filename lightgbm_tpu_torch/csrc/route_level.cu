// Level routing (DataPartition::Split): every row's histogram slot and new
// leaf id from its leaf's split, and the kept rows of each slot, the first
// pass of a level on data too wide for the fused level pass (F * B > 2048)
// and of every unquantized depthwise level.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py route_level_pallas
// (:1138), kernel body _route_kernel (:1078), numerical and categorical
// splits (the has_cat branch, :1119-1130).
//
// Bound on the H100: bytes. A row reads its leaf id (4 bytes) and, when its
// leaf splits, one bin byte of its split feature, and writes slot and new
// leaf id (8 bytes); the [S] counts are written once: at N = 10.5M, about
// 130 MB, 0.039 ms at 3.35 TB/s. The bin byte is a gather across feature
// rows of bins_T, so in practice each routed row costs a 32-byte sector of
// it where neighbouring rows split on different features (at N = 10.5M, all
// rows routed, 0.14 ms).
//
// Design: the TPU decoded each row's split with a one-hot [L, C] x [8, L]
// MXU product at HIGHEST precision (f32-encoded tables) and selected the
// row's bin with an [F, C] mask sum. Here the launch is the route + count of
// the fused level pass (slot_hist.cuh route_count, shared with
// hist_routed_fused.cu): one row a thread in 256-thread blocks over the
// count pass's grid (at N = 10.5M on an H100, 1056 blocks: one wave), the
// int32 route tables (feat, thr, dleft, new_leaf, slot_left, slot_right;
// 6 KB at L = 255) in each block's shared memory, and on a level with a
// categorical split also the is_cat row and each leaf's membership bitset
// ([L, W] words, W = ceil(B / 32); 15.3 KB in all at L = 255, B = 256),
// where the TPU kernel decoded an [L, B] f32 membership table with one more
// one-hot MXU product (tables too large for shared memory are read from
// global memory). It also counts the kept rows of each slot
// (block-local, warp-aggregated), which hist_q8.cu and hist_f32.cu take in
// place of their own count pass. Four rows in flight in 1024-thread blocks
// were up to 9 us a call slower at narrow levels (H100 80GB HBM3, 700 W;
// scripts/torch_profile_slot_hist.py --only b6). The routing itself is
// lgbt::route_row: a categorical leaf sends a row left iff its bin's bit is
// set.
#include "slot_hist.cuh"

namespace {

__global__ void __launch_bounds__(lgbt::kRouteThreads)
route_level_kernel(const uint8_t* __restrict__ bins_T,
                   const int* __restrict__ lid, const int* __restrict__ tab_g,
                   const uint32_t* __restrict__ bits_g, int w,
                   const int* __restrict__ na_bin, int n, int f, int l, int s,
                   int tab_smem, bool counting, int* __restrict__ slot,
                   int* __restrict__ lid2, int* __restrict__ counts) {
  lgbt::route_count(bins_T, lid, tab_g, bits_g, w, na_bin, n, f, l, s,
                    tab_smem, counting, slot, lid2, counts);
}

}  // namespace

// tab [6, L] i32, or [7, L] with the is_cat row when bits is not null;
// bits [L, w] u32 membership words of the categorical leaves, or null on a
// level without a categorical split; slot_out / lid2_out [N] i32; counts
// [S] i32 zero on entry (the kept rows of each slot, slot in [0, S)); grid
// from ops/hist_kernels.py pass_blocks. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments it refuses.
extern "C" int lgbt_route_level(const uint8_t* bins_T, const int* lid,
                                const int* tab, const uint32_t* bits, int w,
                                const int* na_bin, int n, int f, int l, int s,
                                int* slot_out, int* lid2_out, int* counts,
                                int grid, cudaStream_t stream) {
  if (s < 1 || l < 0 || grid < 1 || (bits && w < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return lgbt::route_count_launch(route_level_kernel, bins_T, lid, tab, bits,
                                  w, na_bin, n, f, l, s, true, slot_out,
                                  lid2_out, counts, grid, stream);
}
