// The slot histogram shared by B8 hist_f32.cu (f32 rows, float cells), B5
// hist_q8.cu (int8 rows, int cells) and B2 hist_routed_fused.cu (int8 rows
// whose slots its own routing gives): sums of row channels by (slot,
// feature, bin) into the channel-major [S, nch, F, B] table (zero on
// entry). Rows whose slot lies outside [0, S), negative ones included, are
// dropped; a null slot vector puts every row in slot 0. Also the level
// routing (numerical and categorical splits) with its per-slot counts
// (route_count), shared by B2 and B6 route_level.cu, whose counts B5 and
// B8 then take in place of their own count pass. Each source wraps these
// device functions in __global__ kernels of its own names, so that a
// profile attributes every launch to its kernel.
//
// Design: group the kept rows by slot, then histogram each group with its
// slot's whole [nch, F, B] table in one block's shared memory, so that each
// kept row's bins and channels are read from device memory about once. (A
// (feature, slot-tile) tiling of shared memory, where one slot of a feature
// is nch KB at B = 256, makes 56 tiles at S = 127, and every tile re-reads
// every row's slot and channels.)
//
// 1. Compaction, with a slot vector; three launches:
//    count    per-slot counts of kept rows, block-local in shared memory
//             (warp-aggregated with __match_any_sync), then one global atomic
//             per slot and block: slot_count over a slot vector, or
//             route_count, which routes the rows and writes the slot vector
//             in the same launch (B2's first launch, and B6's, whose counts
//             B5 and B8 are handed, so that they skip this pass);
//    scan     one block: exclusive scan of the S counts into offsets [S + 1]
//             and per-slot cursors;
//    scatter  each kept row takes the next place in its slot's range (one
//             cursor atomic per slot and 1024-row tile, checked against
//             the range's end) and writes one
//             record there: its F bins as bytes, padded to a word, then its
//             channels (SlotChans: three f32 words, or one word of int8 g,
//             h, count). A warp writes its kept rows' records one word a
//             lane, so that stores of neighbouring lanes fall in one
//             record or the next (on an H100 this halved the scatter at
//             S = 127 against a lane a record, scripts/
//             torch_profile_slot_hist.py; 64 registers at half the
//             occupancy in place of 32 and a few spills, and prefetching
//             the next tile's slots, were slower).
//    One slot (a lossguide pass) skips count and scan: its range starts at
//    0. The list holds packed records, and the scatter copies a kept row's
//    bins from the row-major [N, F] matrix (basic.Dataset.bins, which the
//    wrappers take beside bins_T): one or two 32-byte sectors a row. From
//    bins_T [F, N] a row's bins cost a sector per feature (28 at F = 28), so
//    a pass keeping 5% of the rows reads most of bins_T, and gathering rows
//    by index from it in the histogram would cost about 9 GB at N = 10.5M.
//    The histogram then reads one 40-byte (f32, F = 28) or 32-byte (int8)
//    record a row, consecutive records in neighbouring lanes. The order
//    within a slot varies from
//    run to run: int sums are exact in any order, and each f32 row enters
//    its cell unrounded, so the f32 sums stay within a few ulp of the cell's
//    absolute mass.
// 2. Histogram: the list is cut into equal ranges of consecutive entries,
//    one per block (grid.x blocks for each feature group, grid.y), each of
//    at least min_rows entries. A block walks its range in slot segments: it
//    adds each row into the shared table with shared atomics, flushes the
//    nonzero cells into the segment's slot with global atomics when the slot
//    changes, zeroes the table and goes on. A slot that holds most rows
//    spreads over as many blocks as its share of the list. At F = 28,
//    B = 256 the table is 86,016 B (nch 3) or 57,344 B (nch 2): two
//    1024-thread blocks an SM. At B = 64 (21,504 B, nch 3) eight tables
//    would fit an SM, but on an H100 two blocks of 1024 threads beat four of
//    512 by 7-16% and eight of 256 by 19-35% (B2's histogram pass, S = 1 to
//    127, kSlotThreads and the plan's blocks an SM varied together; one
//    block of 1024 came within 4% of two), so every histogram block has
//    kSlotThreads threads and the plan keeps two an SM. Where one slot's
//    table exceeds the budget (F > 66 at B = 256 and nch 3) the features
//    are cut into groups and each row is read once a group.
//    Range size (ops/hist_kernels.py slot_hist_plan): 2 x SMs x blocks an SM
//    blocks (528 on an H100 at two blocks an SM), each taking at least
//    1024 entries. The flushes cost at most nch F B global atomics per
//    segment and there are at most blocks + S segments: at S = 127,
//    (528 + 127) x 21,504 = 14M global atomics against 220M shared ones for
//    2.6M kept rows (2.6M x 28 x 3), and 528 equal ranges cover the card
//    twice. The floor keeps a block's flush (at most nch F B = 21,504
//    cells) within a quarter of its row atomics (1024 x 28 x 3) when few
//    rows are kept: a lossguide pass keeping 52K rows takes 52 blocks, not
//    528. A sweep of the floor over 128 .. 4096 on an H100
//    (scripts/torch_profile_slot_hist.py --min-rows) found 256 .. 1024
//    best for such passes and no difference at S = 127 or the root.
// 3. Root pass (no slot vector): no compaction; the same histogram blocks
//    walk ranges of rows in natural order, reading bins_T and the channel
//    arrays directly, all in slot 0.
//
// Counts handed over (route_level's) must be those of the slot vector. Ones
// that do not match it stop the launch with a device-side assert
// (cudaErrorAssert at the next synchronizing call) and never move a write
// or a read outside the scratch: the scan clamps the offsets to [0, N], the
// scatter drops the rows of a reservation that passes its slot's range (too
// low a count), and the histogram asserts that the scatter filled every
// slot's range (too high a count).
#pragma once

#include <cassert>

#include "lgbt_common.cuh"

namespace lgbt {

constexpr int kSlotThreads = 1024;
// threads of a route_count block (one row a thread in 256-thread blocks
// beat four rows in flight in 1024-thread blocks by up to 9 us a call at
// narrow levels on an H100 80GB HBM3 at 700 W,
// scripts/torch_profile_slot_hist.py --only b6)
constexpr int kRouteThreads = 256;
// threads of a scatter block: more, smaller blocks an SM overlap one
// block's waits at its two barriers a tile with the others' loads (on an
// H100 a few per cent to a sixth faster than 1024)
constexpr int kScatterThreads = 256;
// slots whose counts the count pass keeps in shared memory (48 KB); more
// slots count straight into global memory
constexpr int kCountSlots = 12 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// How one row's channels sit in a record and in the cells.
template <typename C>
struct SlotChans;

// f32 rows (g, h, count): three words, float cells.
template <>
struct SlotChans<float> {
  using Cell = float;
  static constexpr int kWords = 3;
  __device__ static void load(const float* g, const float* h, const float* c,
                              int r, float& gv, float& hv, float& cv) {
    gv = g[r];
    hv = h[r];
    cv = c[r];
  }
  // word j of row r's channels in a record
  __device__ static uint32_t word(const float* g, const float* h,
                                  const float* c, int r, int j) {
    return __float_as_uint(j == 0 ? g[r] : j == 1 ? h[r] : c[r]);
  }
  __device__ static void unpack(const uint32_t* w, float& gv, float& hv,
                                float& cv) {
    gv = __uint_as_float(w[0]);
    hv = __uint_as_float(w[1]);
    cv = __uint_as_float(w[2]);
  }
};

// int8 rows (g[, h], count): one word of bytes (g, h, count, 0), int cells.
// A null h (const-hessian: channels g and count) reads as 0, which add_row
// skips.
template <>
struct SlotChans<int8_t> {
  using Cell = int;
  static constexpr int kWords = 1;
  __device__ static void load(const int8_t* g, const int8_t* h,
                              const int8_t* c, int r, int& gv, int& hv,
                              int& cv) {
    gv = g[r];
    hv = h ? h[r] : 0;
    cv = c[r];
  }
  __device__ static uint32_t word(const int8_t* g, const int8_t* h,
                                  const int8_t* c, int r, int) {
    const uint32_t hb = h ? static_cast<uint8_t>(h[r]) : 0u;
    return static_cast<uint8_t>(g[r]) | (hb << 8) |
           (static_cast<uint32_t>(static_cast<uint8_t>(c[r])) << 16);
  }
  __device__ static void unpack(const uint32_t* w, int& gv, int& hv,
                                int& cv) {
    gv = static_cast<int8_t>(w[0] & 0xffu);
    hv = static_cast<int8_t>((w[0] >> 8) & 0xffu);
    cv = static_cast<int8_t>((w[0] >> 16) & 0xffu);
  }
};

// 32-bit words of one record: F bin bytes padded to a word, then channels.
template <typename C>
__host__ __device__ constexpr int record_words(int f) {
  return (f + 3) / 4 + SlotChans<C>::kWords;
}

// The calling lane's rank among the lanes of its warp that share its slot,
// and the warp's leader for that slot (with one slot, every kept lane is a
// peer and no match is needed).
__device__ __forceinline__ void slot_peers(unsigned keep_mask, int sl, int s,
                                           unsigned& peers, int& leader,
                                           int& rank) {
  const int lane = threadIdx.x & 31;
  peers = s == 1 ? keep_mask : __match_any_sync(keep_mask, sl);
  leader = __ffs(peers) - 1;
  rank = __popc(peers & ((1u << lane) - 1u));
}

// count: counts [S] (zero on entry) += kept rows of each slot of the slot
// vector. sh is the block's [S] ints of dynamic shared memory when S <=
// kCountSlots (else unused: the counts go straight to global memory).
__device__ __forceinline__ void slot_count(const int* __restrict__ slot,
                                           int n, int s,
                                           int* __restrict__ counts,
                                           int* sh) {
  const bool local = s <= kCountSlots;
  if (local) {
    for (int k = threadIdx.x; k < s; k += blockDim.x) sh[k] = 0;
    __syncthreads();
  }
  int* dst = local ? sh : counts;
  // four rows in flight a thread (every load of the four before any
  // count); base is warp-uniform, so every lane of a warp takes the same
  // iterations
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long base = 4LL * blockIdx.x * blockDim.x; base < n;
       base += step) {
    int sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = base + u * blockDim.x + threadIdx.x;
      sl[u] = r < n ? slot[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool keep = sl[u] >= 0 && sl[u] < s;
      const unsigned km = __ballot_sync(kFullMask, keep);
      if (keep) {
        unsigned peers;
        int leader, rank;
        slot_peers(km, sl[u], s, peers, leader, rank);
        if (rank == 0) atomicAdd(dst + sl[u], __popc(peers));  // the leader
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int k = threadIdx.x; k < s; k += blockDim.x) {
      const int v = sh[k];
      if (v) atomicAdd(counts + k, v);
    }
  }
}

// Dynamic shared memory of route_count: the [S] counts when S <=
// kCountSlots, then the route tables when they fit the budget beside them
// (tab_smem set; larger tables are read from global memory): six [L] int32
// rows, or with a bitset (w > 0) seven rows and the [L, w] bitset words
// (15.3 KB at L = 255, B = 256).
inline size_t route_count_smem(int s, int l, int w, int& tab_smem) {
  const size_t count_smem = s <= kCountSlots ? s * sizeof(int) : 0;
  const size_t tab_bytes =
      static_cast<size_t>(w > 0 ? 7 + w : 6) * l * sizeof(int);
  tab_smem = count_smem + tab_bytes <= kSmemBudget ? 1 : 0;
  return count_smem + (tab_smem ? tab_bytes : 0);
}

// route + count, one row a thread: each block copies the route tables
// (feat, thr, dleft, new_leaf, slot_left, slot_right, and with a bitset
// is_cat and the [L, w] membership words) into shared memory (6 KB at
// L = 255 for a numerical level), routes its warps' rows through
// lgbt::route_row (a warp-uniform stride, so that the count's warp votes
// see every lane), writes each row's slot and new leaf id, and (with
// counting) adds the kept rows of each slot into counts [S] (zero on
// entry). bits_g is null on a level without a categorical split.
__device__ __forceinline__ void route_count(
    const uint8_t* __restrict__ bins_T, const int* __restrict__ lid,
    const int* __restrict__ tab_g, const uint32_t* __restrict__ bits_g,
    int w, const int* __restrict__ na_bin, int n, int f, int l, int s,
    int tab_smem, bool counting, int* __restrict__ slot,
    int* __restrict__ lid2, int* __restrict__ counts) {
  extern __shared__ int route_count_sh[];
  const bool local = counting && s <= kCountSlots;
  const int* tab = tab_g;
  const uint32_t* bits = bits_g;
  if (local)
    for (int k = threadIdx.x; k < s; k += blockDim.x) route_count_sh[k] = 0;
  if (tab_smem) {
    int* tsh = route_count_sh + (s <= kCountSlots ? s : 0);
    const int rows = bits_g ? 7 : 6;
    for (int k = threadIdx.x; k < rows * l; k += blockDim.x) tsh[k] = tab_g[k];
    tab = tsh;
    if (bits_g) {
      uint32_t* bsh = reinterpret_cast<uint32_t*>(tsh + rows * l);
      for (int k = threadIdx.x; k < l * w; k += blockDim.x) bsh[k] = bits_g[k];
      bits = bsh;
    }
  }
  __syncthreads();
  int* dst = local ? route_count_sh : counts;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const int r = static_cast<int>(base) + lane;
    int sl = -1, nl;
    if (r < n) {
      route_row(bins_T, tab, bits, w, na_bin, n, f, l, s, r, lid[r], sl, nl);
      slot[r] = sl;
      lid2[r] = nl;
    }
    if (!counting) continue;
    const bool keep = sl >= 0 && sl < s;
    const unsigned km = __ballot_sync(kFullMask, keep);
    if (keep) {
      unsigned peers;
      int leader, rank;
      slot_peers(km, sl, s, peers, leader, rank);
      if (rank == 0) atomicAdd(dst + sl, __popc(peers));
    }
  }
  if (local) {
    __syncthreads();
    for (int k = threadIdx.x; k < s; k += blockDim.x) {
      const int v = route_count_sh[k];
      if (v) atomicAdd(counts + k, v);
    }
  }
}

// Launch a __global__ wrapper of route_count on pass_blocks blocks of
// kRouteThreads; bits null (w 0) on a level without a categorical split.
// Returns the launch error.
template <typename Kernel>
inline int route_count_launch(Kernel kernel, const uint8_t* bins_T,
                              const int* lid, const int* tab,
                              const uint32_t* bits, int w, const int* na_bin,
                              int n, int f, int l, int s, bool counting,
                              int* slot, int* lid2, int* counts,
                              int pass_blocks, cudaStream_t stream) {
  int tab_smem = 0;
  const size_t smem = route_count_smem(s, l, bits ? w : 0, tab_smem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<pass_blocks, kRouteThreads, smem, stream>>>(
      bins_T, lid, tab, bits, bits ? w : 0, na_bin, n, f, l, s, tab_smem,
      counting, slot, lid2, counts);
  return static_cast<int>(cudaGetLastError());
}

// scan, one block: off [S + 1] = exclusive prefix sums of counts (off[S] =
// kept rows), cursor [S] = off[0 .. S). Counts handed over must lie in
// [0, N] and sum to at most N (asserted); the offsets are clamped to
// [0, N] all the same.
__device__ __forceinline__ void slot_scan(const int* __restrict__ counts,
                                          int s, int n,
                                          int* __restrict__ off,
                                          int* __restrict__ cursor) {
  __shared__ long long part[kSlotThreads];
  const int t = threadIdx.x;
  const int per = (s + blockDim.x - 1) / blockDim.x;
  const int k0 = min(s, t * per);
  const int k1 = min(s, k0 + per);
  long long sum = 0;
  for (int k = k0; k < k1; ++k) {
    assert(counts[k] >= 0 && counts[k] <= n);
    sum += min(max(counts[k], 0), n);
  }
  part[t] = sum;
  __syncthreads();
  // inclusive Hillis-Steele scan of the per-thread partial sums
  for (int d = 1; d < static_cast<int>(blockDim.x); d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - sum;
  for (int k = k0; k < k1; ++k) {
    off[k] = static_cast<int>(min(run, static_cast<long long>(n)));
    cursor[k] = off[k];
    run += min(max(counts[k], 0), n);
  }
  if (t == blockDim.x - 1) {
    assert(part[t] <= n);
    off[s] = static_cast<int>(min(part[t], static_cast<long long>(n)));
  }
}

// Word k of row r's record: its f bins as bytes (four a word, from columns
// [col0, col0 + f) of the row-major matrix bins, whose rows are ld bytes
// apart: the whole [N, F] matrix, or a feature tile of it read in place; as
// one load when every row's first bin starts on a word), then its channels.
template <typename C>
__device__ __forceinline__ uint32_t record_word(
    const uint8_t* __restrict__ bins, const C* __restrict__ g,
    const C* __restrict__ h, const C* __restrict__ c, int r, int f, int ld,
    int col0, int k, bool words) {
  const int wb = (f + 3) / 4;
  if (k >= wb) return SlotChans<C>::word(g, h, c, r, k - wb);
  const uint8_t* row = bins + static_cast<size_t>(r) * ld + col0;
  if (words) return reinterpret_cast<const uint32_t*>(row)[k];
  uint32_t w = 0;
  for (int t = 0; t < 4 && 4 * k + t < f; ++t)
    w |= static_cast<uint32_t>(row[4 * k + t]) << (8 * t);
  return w;
}

// The first of v places taken at slot k's cursor, or, where they would
// pass the end of its range (counts handed over that undercount slot k), a
// device-side assert and a negative place that drops the rows.
__device__ __forceinline__ int scatter_reserve(int* __restrict__ cursor,
                                               const int* __restrict__ end,
                                               int k, int v) {
  const int first = atomicAdd(cursor + k, v);
  const bool fits = !end || first + v <= end[k];
  assert(fits);
  return fits ? first : -(1 << 30);
}

// scatter: each kept row writes its record at the next place of its slot's
// range (cursor [S] from slot_scan) of rec [kept, record_words<C>(f)],
// reading its f bins from columns [col0, col0 + f) of the row-major matrix
// bins, ld bytes a row (record_word). end [S], the
// ranges' ends (off + 1; null at one slot, whose range ends at N), bounds
// each reservation (scatter_reserve). A block takes tiles of 4 x blockDim
// rows: the rows of a tile are ranked within their slot by shared atomics
// (warp-aggregated), and the tile then reserves each slot's run of places
// with one global atomic (a global
// atomic a row or a warp serializes on the cursor of a slot that holds many
// rows: the one slot of a lossguide pass). With more slots than fit shared
// memory, each warp reserves its places on the global cursors directly.
// Each warp then writes its kept rows' records together, one word a lane:
// neighbouring lanes load neighbouring words of a row and store neighbouring
// words of a record (a lane a record would store each word at the record
// stride, one sector a lane and word).
template <typename C>
__device__ __forceinline__ void slot_scatter(
    const uint8_t* __restrict__ bins, const C* __restrict__ g,
    const C* __restrict__ h, const C* __restrict__ c,
    const int* __restrict__ slot, int n, int f, int ld, int col0, int s,
    int* __restrict__ cursor, const int* __restrict__ end,
    uint32_t* __restrict__ rec) {
  extern __shared__ int slot_scatter_sh[];   // [S] tile counts, [S] bases
  __shared__ int2 kept_sh[kScatterThreads];  // a warp's (row, place) pairs
  const bool local = s <= kCountSlots / 2;
  int* cnt = slot_scatter_sh;
  int* start = slot_scatter_sh + s;
  const int rw = record_words<C>(f);
  const int lane = threadIdx.x & 31;
  int2* mine = kept_sh + (threadIdx.x & ~31);
  // word loads only where every row's tile starts on a word and ends on one
  const bool words = f % 4 == 0 && ld % 4 == 0 && col0 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(bins) % 4 == 0;
  if (local) {
    for (int k = threadIdx.x; k < s; k += blockDim.x) cnt[k] = 0;
    __syncthreads();
  }
  const long long tile = 4LL * blockDim.x;
  // base is block-uniform: every thread takes the same tiles
  for (long long base = blockIdx.x * tile; base < n;
       base += gridDim.x * tile) {
    int sl[4], at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = base + u * blockDim.x + threadIdx.x;
      sl[u] = r < n ? slot[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool keep = sl[u] >= 0 && sl[u] < s;
      const unsigned km = __ballot_sync(kFullMask, keep);
      at[u] = -1;
      if (keep) {
        unsigned peers;
        int leader, rank;
        slot_peers(km, sl[u], s, peers, leader, rank);
        int first = 0;
        if (lane == leader)
          first = local ? atomicAdd(cnt + sl[u], __popc(peers))
                        : scatter_reserve(cursor, end, sl[u], __popc(peers));
        at[u] = __shfl_sync(peers, first, leader) + rank;
      }
    }
    if (local) {   // one reservation a slot and tile; counts back to zero
      __syncthreads();
      for (int k = threadIdx.x; k < s; k += blockDim.x) {
        const int v = cnt[k];
        if (v) {
          start[k] = scatter_reserve(cursor, end, k, v);
          cnt[k] = 0;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int place = at[u] >= 0 && local ? start[sl[u]] + at[u] : at[u];
      const bool keep = place >= 0;
      const unsigned km = __ballot_sync(kFullMask, keep);
      if (!km) continue;                       // warp-uniform
      if (keep)
        mine[__popc(km & ((1u << lane) - 1u))] = make_int2(
            static_cast<int>(base + u * blockDim.x + threadIdx.x), place);
      __syncwarp();
      const int items = __popc(km) * rw;
      for (int t = lane; t < items; t += 32) {
        const int q = t / rw;
        const int k = t - q * rw;
        const int2 rp = mine[q];
        rec[static_cast<size_t>(rp.y) * rw + k] =
            record_word<C>(bins, g, h, c, rp.x, f, ld, col0, k, words);
      }
      __syncwarp();
    }
  }
}

// histogram, grid (blocks, feature groups): block (x, y) takes entries
// [x * per, (x + 1) * per) of the slot-ordered list (off non-null: records
// rec, off [S + 1] from slot_scan) or of the rows in natural order (off
// null: bins_T and the channel arrays, slot 0), per = max(min_rows,
// ceil(kept / grid.x)), and features [y * fg, y * fg + fg). Over S > 1
// slots the scatter's cursors follow the offsets in slot_hist_launch's idx
// (off + S + 1), and block (0, 0) asserts that each ends at its range's end.
template <typename C>
__device__ __forceinline__ void slot_hist(
    const uint8_t* __restrict__ bins_T, const C* __restrict__ g,
    const C* __restrict__ h, const C* __restrict__ c,
    const int* __restrict__ off, const uint32_t* __restrict__ rec, int n,
    int f, int b, int s, int nch, int fg, int min_rows,
    typename SlotChans<C>::Cell* __restrict__ hist) {
  using T = typename SlotChans<C>::Cell;
  extern __shared__ __align__(16) unsigned char slot_table_sh[];
  T* sh = reinterpret_cast<T*>(slot_table_sh);   // [nch][fg][B]
  const long long kept = off ? off[s] : n;
  const long long per = max(static_cast<long long>(min_rows),
                            (kept + gridDim.x - 1) / gridDim.x);
  const long long e0 = static_cast<long long>(blockIdx.x) * per;
  if (e0 >= kept) return;
  const int e1 = static_cast<int>(min(kept, e0 + per));
  const int f0 = blockIdx.y * fg;
  const int fcnt = min(fg, f - f0);
  const int ch_stride = fg * b;
  const int total = nch * ch_stride;
  const int wb = (f + 3) / 4;
  const int rw = record_words<C>(f);
  const int w0 = f0 / 4;                        // bin words of the group
  const int wg = (f0 + fcnt + 3) / 4 - w0;
  for (int k = threadIdx.x; k < total; k += blockDim.x) sh[k] = T(0);
  if (off && s > 1 && blockIdx.x == 0 && blockIdx.y == 0)
    for (int k = threadIdx.x; k < s; k += blockDim.x)
      assert(off[s + 1 + k] == off[k + 1]);
  __syncthreads();

  int e = static_cast<int>(e0);
  int sl = 0;
  if (off) {  // the slot whose range holds e: off[sl] <= e < off[sl + 1]
    int lo = 0, hi = s;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (off[mid] <= e) lo = mid; else hi = mid;
    }
    sl = lo;
  }
  while (true) {
    const int seg = off ? min(e1, off[sl + 1]) : e1;
    if (off) {
      // one thread a (record, bin word of the group): neighbouring lanes
      // read neighbouring words of a few records, and each word adds four
      // bins (a thread a record would load its bytes at the record stride,
      // about ten L1 wavefronts a warp load)
      const int items = (seg - e) * wg;
      for (int t = threadIdx.x; t < items; t += blockDim.x) {
        const int q = t / wg;
        const int k = w0 + (t - q * wg);
        const uint32_t* r = rec + static_cast<size_t>(e + q) * rw;
        T gv, hv, cv;
        SlotChans<C>::unpack(r + wb, gv, hv, cv);
        const uint32_t w = r[k];
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * k + u - f0;   // feature within the group
          const int bin = (w >> (8 * u)) & 0xffu;
          if (j < 0 || j >= fcnt || bin >= b) continue;
          T* cell = sh + j * b + bin;
          if (gv != T(0)) atomicAdd(cell, gv);
          if (hv != T(0)) atomicAdd(cell + ch_stride, hv);
          if (cv != T(0)) atomicAdd(cell + (nch - 1) * ch_stride, cv);
        }
      }
    } else {
      const uint8_t* col0 = bins_T + static_cast<size_t>(f0) * n;
      for (int i = e + threadIdx.x; i < seg; i += blockDim.x) {
        T gv, hv, cv;
        SlotChans<C>::load(g, h, c, i, gv, hv, cv);
        add_row<T>(sh, ch_stride, nch, col0 + i, n, fcnt, b, gv, hv, cv);
      }
    }
    __syncthreads();
    flush_hist(sh, 1, nch, fg, fcnt, b, sl, f0, f, hist);
    e = seg;
    if (e >= e1) break;
    // the slot changes inside the range: zero the table, skip empty slots
    __syncthreads();
    for (int k = threadIdx.x; k < total; k += blockDim.x) sh[k] = T(0);
    __syncthreads();
    ++sl;
    while (off[sl + 1] <= e) ++sl;
  }
}

// The four kernels of one cell type, each a __global__ wrapper of the device
// function of its name. count may be null where the caller always hands
// slot_hist_launch its counts (hist_routed_fused.cu routes and counts in
// one kernel).
template <typename C>
struct SlotHistKernels {
  using Cell = typename SlotChans<C>::Cell;
  void (*count)(const int*, int, int, int*);
  void (*scan)(const int*, int, int, int*, int*);
  void (*scatter)(const uint8_t*, const C*, const C*, const C*, const int*,
                  int, int, int, int, int, int*, const int*,
                  uint32_t*);                        // bins, not bins_T
  void (*hist)(const uint8_t*, const C*, const C*, const C*, const int*,
               const uint32_t*, int, int, int, int, int, int, int, Cell*);
};

// The arguments that the C entries refuse before slot_hist_launch, as
// cudaErrorInvalidValue: a table over the budget, a grid size below 1, a
// block range whose (record, bin word) items overflow an int, and, with a
// slot vector (slotted), a missing bins, a column tile [col0, col0 + f)
// that does not lie within rows of ld bytes, or a record size that is not
// record_words<C>(f).
template <typename C>
inline int slot_hist_check(bool slotted, const uint8_t* bins, int n, int f,
                           int ld, int col0, int b, int nch, int fg,
                           int blocks, int min_rows, int pass_blocks,
                           int rec_words) {
  const size_t smem = static_cast<size_t>(nch) * fg * b *
                      sizeof(typename SlotChans<C>::Cell);
  if (smem > kSmemBudget || fg < 1 || blocks < 1 || pass_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (static_cast<long long>(n) / blocks + min_rows + 1) *
                          ((fg + 3) / 4 + 1);
  if (items > 0x7fffffffLL ||
      (slotted && (!bins || col0 < 0 ||
                   static_cast<long long>(col0) + f > ld ||
                   rec_words != record_words<C>(f))))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

// Launch the slot histogram on one stream, after slot_hist_check has
// passed the arguments: with a slot vector the compaction passes
// (pass_blocks blocks for count, as many threads in kScatterThreads blocks
// for scatter; one slot needs the scatter alone) and the histogram over the
// records, else the histogram over the rows in natural order. bins is the
// row-major matrix whose columns [col0, col0 + F), ld bytes a row, are
// bins_T [F, N] (the whole matrix at col0 0 and ld F, or a feature tile of
// it), needed with a slot vector. idx [3S + 1]
// i32 holds counts, offsets and cursors: its counts zero on entry where the
// count pass adds into them, and at one slot its words zero (the cursor
// idx[S + 1] counts the scattered rows). counts [S], when not null, are the
// kept rows of each slot that the caller has counted (route_level's, or
// hist_routed_fused.cu's own, in idx), and no count pass runs; counts that
// do not match the slot vector stop the launch with a device-side assert
// (see the top of this file). rec holds n * rec_words words. Returns the
// first launch error.
template <typename C>
inline int slot_hist_launch(const SlotHistKernels<C>& k,
                            const uint8_t* bins_T, const uint8_t* bins,
                            const C* g, const C* h,
                            const C* c, const int* slot, const int* counts,
                            int n, int f, int ld, int col0, int b,
                            int s, int nch, int fg, int blocks, int min_rows,
                            int pass_blocks, int* idx, uint32_t* rec,
                            int rec_words, typename SlotChans<C>::Cell* hist,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nch) * fg * b *
                      sizeof(typename SlotChans<C>::Cell);
  const auto count = k.count;
  const auto scan = k.scan;
  const auto scatter = k.scatter;
  const auto histogram = k.hist;
  cudaError_t err = allow_smem(histogram, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* off = nullptr;
  if (slot) {
    int* offs = idx + s;
    // one slot (a lossguide pass, a first level) needs no counts: its range
    // starts at 0, and the scatter's cursor, offs[1], ends at the kept rows
    int* cursor = s > 1 ? idx + 2 * s + 1 : offs + 1;
    const size_t count_smem = s <= kCountSlots ? s * sizeof(int) : 0;
    const size_t scatter_smem =
        s <= kCountSlots / 2 ? 2 * s * sizeof(int) : 0;
    if (s > 1) {
      if (!counts) {
        count<<<pass_blocks, kSlotThreads, count_smem, stream>>>(slot, n, s,
                                                                 idx);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
        counts = idx;
      }
      scan<<<1, kSlotThreads, 0, stream>>>(counts, s, n, offs, cursor);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    scatter<<<pass_blocks * (kSlotThreads / kScatterThreads), kScatterThreads,
              scatter_smem, stream>>>(
        bins, g, h, c, slot, n, f, ld, col0, s, cursor,
        s > 1 ? offs + 1 : nullptr, rec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    off = offs;
  }
  const dim3 grid(blocks, (f + fg - 1) / fg);
  histogram<<<grid, kSlotThreads, smem, stream>>>(
      bins_T, g, h, c, off, rec, n, f, b, s, nch, fg, min_rows, hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt
