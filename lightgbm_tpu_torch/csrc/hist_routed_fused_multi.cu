// Multi-level replay: route every row through D consecutive levels' split
// tables and build each level's slot histogram from the int8 quantized
// channels, in one call.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// hist_routed_fused_multi_q8 (:574) at D > 1, kernel body _kernel_q8_fused
// (:454) with its d loop: the shallow megapass, which replays D levels
// whose split tables are all known up front (profiling and parity
// harnesses; the live grower runs D = 1, hist_routed_fused.cu), numerical
// and categorical splits (the has_cat branch, :533-543, each level its own
// membership rows).
//
// Bound on the H100: bytes. Every row reads its leaf id (4 B) once and
// writes its final leaf id (4 B) once, and reads the bin of each level's
// split feature (1 B a level where its leaf splits); a row kept at any
// level reads its F bins and nch int8 channels; the D [S, nch, F, B] int32
// bands are written once. In practice the shared-memory atomics of each
// level's histogram bound it, as in the D = 1 pass.
//
// Design: hist_routed_fused.cu's three steps, with the routing of all D
// levels in one launch:
// 1. route + count (hist_routed_multi_count_kernel): one row a thread in
//    256-thread blocks, the D levels' int32 route tables in shared memory
//    (six [L] rows a level, 18 KB at D = 3, L = 255; with a categorical
//    level seven rows and an [L, W] membership bitset a level, zero rows
//    for the levels without one; tables over the budget are read from
//    global memory). Each row reads its leaf id once, walks the D tables
//    with lgbt::route_row, writes its slot of each level into the [D, N]
//    slot vectors and its final leaf id, and each level's kept rows are
//    counted per slot (warp-aggregated with __match_any_sync, block-local
//    in shared memory, one global atomic per level, slot and block) into
//    the first S_d words of that level's idx. A level with one slot is
//    routed but not counted: its range starts at 0.
// 2. for each level d, slot_hist.cuh's slot_hist_launch given those counts:
//    scan, scatter of the level's kept rows into packed records (the
//    record buffer is reused level after level on the one stream), and the
//    histogram blocks, into band d of the output.
// Each level drops slots outside [0, S_d), its own width; a row whose leaf
// does not split keeps its leaf id through the later levels. Integer sums
// make every order exact: the bands and the final leaf ids equal D
// sequential D = 1 passes and the plain version bit for bit.
#include "slot_hist.cuh"

namespace {

using lgbt::kFullMask;
using lgbt::kSlotThreads;

// levels one call replays (the reference's megapass replays up to 5)
constexpr int kMaxLevels = 8;

struct LevelSlots {
  int s[kMaxLevels];
};

// route + count of D levels, one row a thread: tab [D, rows, L] i32 (rows
// 7 with bits, else 6), bits [D, L, w] u32 or null; slot [D, N] and lid2
// [N] out; level dd counts its kept rows into idx + dd * idx_stride (zero
// on entry) when S_dd > 1. local: the D x s_max counts fit shared memory.
__global__ void __launch_bounds__(lgbt::kRouteThreads)
hist_routed_multi_count_kernel(const uint8_t* __restrict__ bins_T,
                               const int* __restrict__ lid,
                               const int* __restrict__ tab_g,
                               const uint32_t* __restrict__ bits_g, int w,
                               const int* __restrict__ na_bin, int n, int f,
                               int l, int d, LevelSlots ls, int s_max,
                               int idx_stride, bool local, int tab_smem,
                               int* __restrict__ slot, int* __restrict__ lid2,
                               int* __restrict__ idx) {
  extern __shared__ int multi_count_sh[];
  const int rows = bits_g ? 7 : 6;
  const int cnt = local ? d * s_max : 0;
  const int* tab = tab_g;
  const uint32_t* bits = bits_g;
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) multi_count_sh[k] = 0;
  if (tab_smem) {
    int* tsh = multi_count_sh + cnt;
    for (int k = threadIdx.x; k < d * rows * l; k += blockDim.x)
      tsh[k] = tab_g[k];
    tab = tsh;
    if (bits_g) {
      uint32_t* bsh = reinterpret_cast<uint32_t*>(tsh + d * rows * l);
      for (int k = threadIdx.x; k < d * l * w; k += blockDim.x)
        bsh[k] = bits_g[k];
      bits = bsh;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // base is warp-uniform, so every lane of a warp takes the same
  // iterations and levels and the count's warp votes see every lane
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const int r = static_cast<int>(base) + lane;
    int lf = r < n ? lid[r] : -1;
    for (int dd = 0; dd < d; ++dd) {
      const int s = ls.s[dd];
      int sl = -1;
      if (r < n) {
        int nl;
        lgbt::route_row(bins_T, tab + static_cast<size_t>(dd) * rows * l,
                        bits ? bits + static_cast<size_t>(dd) * l * w
                             : nullptr,
                        w, na_bin, n, f, l, s, r, lf, sl, nl);
        slot[static_cast<size_t>(dd) * n + r] = sl;
        lf = nl;
      }
      if (s == 1) continue;   // the same for every lane
      const bool keep = sl >= 0 && sl < s;
      const unsigned km = __ballot_sync(kFullMask, keep);
      if (keep) {
        unsigned peers;
        int leader, rank;
        lgbt::slot_peers(km, sl, s, peers, leader, rank);
        int* dst = local ? multi_count_sh + dd * s_max
                         : idx + static_cast<size_t>(dd) * idx_stride;
        if (rank == 0) atomicAdd(dst + sl, __popc(peers));
      }
    }
    if (r < n) lid2[r] = lf;
  }
  if (local) {
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const int v = multi_count_sh[k];
      const int dd = k / s_max;
      if (v) atomicAdd(idx + static_cast<size_t>(dd) * idx_stride +
                           (k - dd * s_max), v);
    }
  }
}

__global__ void __launch_bounds__(kSlotThreads)
hist_routed_multi_scan_kernel(const int* __restrict__ counts, int s, int n,
                              int* __restrict__ off,
                              int* __restrict__ cursor) {
  lgbt::slot_scan(counts, s, n, off, cursor);
}

// eight blocks an SM (at most 32 registers), as hist_routed_fused.cu's
__global__ void __launch_bounds__(lgbt::kScatterThreads, 8)
hist_routed_multi_scatter_kernel(const uint8_t* __restrict__ bins,
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
hist_routed_multi_kernel(const uint8_t* __restrict__ bins_T,
                         const int8_t* __restrict__ gq,
                         const int8_t* __restrict__ hq,
                         const int8_t* __restrict__ cq,
                         const int* __restrict__ off,
                         const uint32_t* __restrict__ rec, int n, int f,
                         int b, int s, int nch, int fg, int min_rows,
                         int* __restrict__ hist) {
  lgbt::slot_hist<int8_t>(bins_T, gq, hq, cq, off, rec, n, f, b, s, nch, fg,
                          min_rows, hist);
}

}  // namespace

// tab [D, 6, L] i32, or [D, 7, L] with the is_cat rows when bits is not
// null; bits [D, L, w] u32 membership words (zero rows for a level without
// a categorical split), or null when no level has one; slots: D host ints,
// the levels' slot widths S_d in [1, s_max]; bins the row-major [N, F]
// matrix of bins_T; hq is null when nch == 2. hist [D, s_max, nch, F, B]
// i32 and idx [D, 3 s_max + 1] i32 zero on entry; slot [D, N] i32 and rec
// [n, rec_words] u32 scratch; lid2 [N] i32 out (the leaf ids after the D
// levels). Grid and range sizes from ops/hist_kernels.py slot_hist_plan.
// Returns the first launch error, or cudaErrorInvalidValue for arguments it
// refuses.
extern "C" int lgbt_hist_routed_fused_multi(
    const uint8_t* bins_T, const uint8_t* bins, const int8_t* gq,
    const int8_t* hq, const int8_t* cq, const int* lid, const int* tab,
    const uint32_t* bits, int w, const int* na_bin, int n, int f, int b,
    int l, int d, const int* slots, int s_max, int nch, int fg, int blocks,
    int min_rows, int pass_blocks, int* slot, int* idx, uint32_t* rec,
    int rec_words, int* hist, int* lid2, cudaStream_t stream) {
  if ((nch != 2 && nch != 3) || d < 1 || d > kMaxLevels || s_max < 1 ||
      l < 0 || (bits && w < 1) || !slots)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelSlots ls{};
  for (int dd = 0; dd < d; ++dd) {
    if (slots[dd] < 1 || slots[dd] > s_max)
      return static_cast<int>(cudaErrorInvalidValue);
    ls.s[dd] = slots[dd];
  }
  const int rc = lgbt::slot_hist_check<int8_t>(true, bins, n, f, f, 0, b, nch,
                                               fg, blocks, min_rows,
                                               pass_blocks, rec_words);
  if (rc != cudaSuccess) return rc;
  const int idx_stride = 3 * s_max + 1;
  const int rows = bits ? 7 : 6;
  const bool local = static_cast<long long>(d) * s_max <= lgbt::kCountSlots;
  const size_t count_smem = local ? static_cast<size_t>(d) * s_max * 4 : 0;
  const size_t tab_bytes =
      static_cast<size_t>(d) * l * (rows + (bits ? w : 0)) * sizeof(int);
  const int tab_smem = count_smem + tab_bytes <= lgbt::kSmemBudget ? 1 : 0;
  const size_t smem = count_smem + (tab_smem ? tab_bytes : 0);
  cudaError_t err = lgbt::allow_smem(hist_routed_multi_count_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_routed_multi_count_kernel<<<pass_blocks, lgbt::kRouteThreads, smem,
                                   stream>>>(
      bins_T, lid, tab, bits, bits ? w : 0, na_bin, n, f, l, d, ls, s_max,
      idx_stride, local, tab_smem, slot, lid2, idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const lgbt::SlotHistKernels<int8_t> k{
      nullptr, hist_routed_multi_scan_kernel,
      hist_routed_multi_scatter_kernel, hist_routed_multi_kernel};
  const size_t band = static_cast<size_t>(s_max) * nch * f * b;
  for (int dd = 0; dd < d; ++dd) {
    int* idx_d = idx + static_cast<size_t>(dd) * idx_stride;
    const int e = lgbt::slot_hist_launch<int8_t>(
        k, bins_T, bins, gq, nch == 3 ? hq : nullptr, cq,
        slot + static_cast<size_t>(dd) * n, idx_d, n, f, f, 0, b, ls.s[dd],
        nch, fg, blocks, min_rows, pass_blocks, idx_d, rec, rec_words,
        hist + dd * band, stream);
    if (e != cudaSuccess) return e;
  }
  return static_cast<int>(cudaSuccess);
}
