// The leaf-sum pass shared by leaf_sums.cu (B7, materialized rows) and
// leaf_sums_grad.cu (B3, gradients recomputed from score, aux and bag):
// exact per-leaf (grad, hess, count) sums [3, L] f32 of f64 sums, leaf ids
// outside [0, L) dropped. Each source wraps these device functions in
// __global__ kernels of its own names and launches them with
// leaf_sums_launch.
//
// Two launches on one stream, no floating-point atomics:
// 1. rows: each warp of a block owns a private f64 table in shared memory,
//    the (g, h) of a leaf in one 16-byte cell, then the counts. A thread
//    takes four consecutive rows a step (16-byte loads of every row vector
//    and of the leaf ids where all start on 16 bytes, scalar loads
//    otherwise and for the last N % 4 rows). For each of the four, the
//    warp finds the lanes that hold the same leaf (__match_any_sync's
//    groups, built from one ballot a bit of the leaf id; lanes with an id
//    outside [0, L), or without a row, are dropped), and the warp
//    walks the ranks within the groups, 0, 1, 2, ...: at each rank every
//    lane of that rank adds its row to its leaf's cells with plain loads,
//    f64 adds and stores. Lanes of one rank hold distinct leaves, so
//    nothing races, and the order is fixed: lane order within a step,
//    steps in row order. Zero rows are skipped (adding 0.0 to a cell that
//    starts at +0.0 changes no sum). At the end the block sums its warps'
//    tables in warp order into its own row of a [grid, 3, L] f64 scratch,
//    written plainly.
// 2. final: each cell's grid rows are summed in a fixed order (kFinalGroups
//    strided partial sums, combined in group order) and rounded once to f32
//    with __double2float_rn into the output.
// Deterministic: two calls on the same inputs at the same grid give the
// same bits. The grid is ops/hist_kernels.py leaf_sums_plan's: two blocks
// an SM (from the SM count), fewer when the rows do not fill them.
//
// A block has kLeafWarps warps while their tables fit kSmemBudget (L = 255:
// 6,128 B a warp, 98 KB a block, two blocks an SM), fewer for larger L,
// down to one (L <= 8,533). Where one warp's table does not fit (warps = 0),
// the rows are added with global f64 atomicAdd into one zeroed [3, L] row
// of the scratch, then rounded by the same final launch: correct, neither
// deterministic nor fast, and not on the main path (num_leaves = 255).
#pragma once

#include "lgbt_common.cuh"

namespace lgbt {

// warps a block at most, and threads (must equal LEAF_WARPS of
// ops/hist_kernels.py)
constexpr int kLeafWarps = 16;
constexpr int kLeafThreads = 32 * kLeafWarps;
// the final launch: cells a block, strided partial sums a cell
constexpr int kFinalCells = 32;
constexpr int kFinalGroups = 8;

// Row sources: three f32 row vectors x, and a row's (g, h, c) from its
// values v[0..2] in them.
// B7: materialized g, h, c.
struct GhcRows {
  const float* x[3];

  __device__ __forceinline__ void ghc(const float v[3], float& g, float& h,
                                      float& c) const {
    g = v[0];
    h = v[1];
    c = v[2];
  }
};

// B3: score, aux, bag; g = grad * bag, h = hess * bag, c = (bag > 0), grad
// and hess recomputed from (score, aux) as _leaf_sums_grad_kernel
// (lightgbm_tpu/ops/pallas_hist.py:1005) does.
struct GradRows {
  const float* x[3];
  GradSpec sp;

  __device__ __forceinline__ void ghc(const float v[3], float& g, float& h,
                                      float& c) const {
    float grad, hess;
    grad_rows(sp, v[0], v[1], grad, hess);
    g = __fmul_rn(grad, v[2]);
    h = __fmul_rn(hess, v[2]);
    c = v[2] > 0.0f ? 1.0f : 0.0f;
  }
};

// f64 words of one warp's table: (g, h) pairs of 16 bytes [L][2], then the
// counts [L], rounded up to 16 bytes
__host__ __device__ __forceinline__ int leaf_table_words(int l) {
  return (3 * l + 1) & ~1;
}

// One row a lane into the warp's table tab, race-free and in lane order
// (every lane of the warp calls it; lf outside [0, L) drops the row).
__device__ __forceinline__ void warp_leaf_add(double* tab, int l, int lf,
                                              float g, float h, float c) {
  const bool ok = lf >= 0 && lf < l;
  // the lanes holding lf: __match_any_sync's mask, from one ballot a bit of
  // the id (MATCH.ANY's cost grows with the distinct ids of a warp); eight
  // bits, unrolled, serve every L <= 256
  unsigned peers = __ballot_sync(0xffffffffu, ok);
  const auto match_bit = [&](int b) {
    const bool bit = (lf >> b) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  };
  if (l <= 256) {
#pragma unroll
    for (int b = 0; b < 8; ++b) match_bit(b);
  } else {
    for (int b = 0; (1 << b) < l; ++b) match_bit(b);
  }
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int rank = __popc(peers & below);
  const int ranks = static_cast<int>(__reduce_max_sync(
      0xffffffffu, ok ? static_cast<unsigned>(__popc(peers)) : 0u));
  for (int k = 0; k < ranks; ++k) {
    if (ok && rank == k) {
      if (g != 0.0f || h != 0.0f) {
        double2* cell = reinterpret_cast<double2*>(tab) + lf;
        double2 v = *cell;
        v.x += static_cast<double>(g);
        v.y += static_cast<double>(h);
        *cell = v;
      }
      if (c != 0.0f) tab[2 * l + lf] += static_cast<double>(c);
    }
    __syncwarp();
  }
}

// The row vectors' and the leaf ids' values of thread quad q (rows 4q ..
// 4q + nr - 1; nr = 0 past the last quad).
template <typename Src>
__device__ __forceinline__ int load_quad(const Src& src,
                                         const int* __restrict__ lid, int n,
                                         long long nq, long long q, bool vec,
                                         float v[3][4], int l4[4]) {
  const long long r = 4 * q;
  const int nr = q < nq ? static_cast<int>(min(4LL, n - r)) : 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) load_rows(src.x[i], r, nr, vec, v[i]);
  load_rows(lid, r, nr, vec, l4);
  return nr;
}

// Launch 1 with warp tables: a block of 32 * warps threads, warps *
// leaf_table_words(L) f64 of dynamic shared memory; part is
// [gridDim.x, 3, L].
template <typename Src>
__device__ __forceinline__ void leaf_rows(const Src& src,
                                          const int* __restrict__ lid,
                                          int n, int l,
                                          double* __restrict__ part) {
  extern __shared__ double4 sh_raw[];    // 16-byte aligned
  double* sh_tab = reinterpret_cast<double*>(sh_raw);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = leaf_table_words(l);
  for (int k = threadIdx.x; k < warps * words; k += blockDim.x)
    sh_tab[k] = 0.0;
  __syncthreads();
  double* tab = sh_tab + warp * words;
  const bool vec = ((reinterpret_cast<uintptr_t>(src.x[0]) |
                     reinterpret_cast<uintptr_t>(src.x[1]) |
                     reinterpret_cast<uintptr_t>(src.x[2]) |
                     reinterpret_cast<uintptr_t>(lid)) & 15) == 0;
  const long long nq = (static_cast<long long>(n) + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // warp-uniform bases: every lane reaches the warp votes
  for (long long q0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      32 * warp;
       q0 < nq; q0 += stride) {
    float v[3][4];
    int l4[4];
    const int nr = load_quad(src, lid, n, nq, q0 + lane, vec, v, l4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x[3] = {v[0][u], v[1][u], v[2][u]};
      float g, h, c;
      src.ghc(x, g, h, c);
      warp_leaf_add(tab, l, u < nr ? l4[u] : -1, g, h, c);
    }
  }
  __syncthreads();
  // cell k of [3, L]: g and h of leaf k % L in its pair, counts after
  for (int k = threadIdx.x; k < 3 * l; k += blockDim.x) {
    const int ch = k / l, lf = k - ch * l;
    const int at = ch < 2 ? 2 * lf + ch : 2 * l + lf;
    double s = 0.0;
    for (int w = 0; w < warps; ++w) s += sh_tab[w * words + at];
    part[static_cast<size_t>(blockIdx.x) * 3 * l + k] = s;
  }
}

// Launch 1 without warp tables (warps = 0): global f64 atomics into acc
// [3, L], zero on entry.
template <typename Src>
__device__ __forceinline__ void leaf_rows_global(const Src& src,
                                                 const int* __restrict__ lid,
                                                 int n, int l,
                                                 double* __restrict__ acc) {
  const long long nq = (static_cast<long long>(n) + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < nq; q += stride) {
    float v[3][4];
    int l4[4];
    const int nr = load_quad(src, lid, n, nq, q, false, v, l4);
    for (int u = 0; u < nr; ++u) {
      const int lf = l4[u];
      if (lf < 0 || lf >= l) continue;
      const float x[3] = {v[0][u], v[1][u], v[2][u]};
      float g, h, c;
      src.ghc(x, g, h, c);
      if (g != 0.0f) atomicAdd(acc + lf, static_cast<double>(g));
      if (h != 0.0f) atomicAdd(acc + l + lf, static_cast<double>(h));
      if (c != 0.0f) atomicAdd(acc + 2 * l + lf, static_cast<double>(c));
    }
  }
}

// Launch 2: out[k] = f32 of the sum over the rows of part [rows, cells],
// for kFinalCells cells a block of kFinalGroups * kFinalCells threads.
// Group j sums rows j, j + kFinalGroups, ... in row order; the groups'
// sums are added in group order.
__device__ __forceinline__ void leaf_final(const double* __restrict__ part,
                                           int rows, int cells,
                                           float* __restrict__ out) {
  __shared__ double red[kFinalGroups][kFinalCells];
  const int lane = threadIdx.x % kFinalCells;
  const int grp = threadIdx.x / kFinalCells;
  const int k = blockIdx.x * kFinalCells + lane;
  double s = 0.0;
  if (k < cells)
    for (int b = grp; b < rows; b += kFinalGroups)
      s += part[static_cast<size_t>(b) * cells + k];
  red[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || k >= cells) return;
  double t = red[0][lane];
  for (int j = 1; j < kFinalGroups; ++j) t += red[j][lane];
  out[k] = __double2float_rn(t);
}

// The three __global__ wrappers of one row source.
template <typename Src>
struct LeafSumsKernels {
  void (*rows)(Src, const int*, int, int, double*);
  void (*rows_global)(Src, const int*, int, int, double*);
  void (*final)(const double*, int, int, float*);
};

// Both launches on stream. warps and grid are leaf_sums_plan's; part holds
// grid * 3 * L f64 (3 * L when warps = 0), out 3 * L f32. Returns a
// cudaError_t: invalid arguments, or cudaGetLastError() after the launches.
template <typename Src>
inline int leaf_sums_launch(const LeafSumsKernels<Src>& k, const Src& src,
                            const int* lid, int n, int l, int warps,
                            int grid, double* part, float* out,
                            cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(3) * l;
  const size_t smem = static_cast<size_t>(leaf_table_words(l)) *
                      sizeof(double) * warps;
  if (n < 0 || l < 1 || warps < 0 || warps > kLeafWarps || grid < 1 ||
      smem > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = grid;
  if (warps > 0) {
    const cudaError_t err = allow_smem(k.rows, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k.rows<<<grid, 32 * warps, smem, stream>>>(src, lid, n, l, part);
  } else {
    const cudaError_t err =
        cudaMemsetAsync(part, 0, cells * sizeof(double), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    k.rows_global<<<grid, kLeafThreads, 0, stream>>>(src, lid, n, l, part);
    rows = 1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((cells + kFinalCells - 1) / kFinalCells);
  k.final<<<blocks, kFinalGroups * kFinalCells, 0, stream>>>(
      part, rows, static_cast<int>(cells), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt
