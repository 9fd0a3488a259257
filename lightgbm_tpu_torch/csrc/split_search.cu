// Numerical split search (S1): the best split of every leaf of a frontier
// from its [L, 3, F, B] channel-major (grad, hess, count) f32 histograms.
//
// Replaces no TPU kernel: the JAX package's best_split
// (lightgbm_tpu/ops/split.py:218) is plain JAX, which XLA fuses on the TPU.
// The port's plain version, best_split's planes
// (lightgbm_tpu_torch/ops/split.py best_split_planes), issues about 130
// PyTorch launches a search over [L, 3, F, B] and [L, F, B] f32 planes (the
// prefix sums' strided adds, two gain planes, the masks, a concatenation, a
// max, the tie band and an index min); this pair reads each histogram once.
//
// What it computes: best_split's SplitResult where the flat sections are
// [num_r, num_l] only (no categorical features, bundles, monotone
// constraints, feature_contri, CEGB penalty or extra_trees), bit for bit on
// every row, allowed or not. Every f32 operation is the plain version's, in
// its order, with the round-to-nearest intrinsics (the library is built with
// -fmad=false):
// - the missing bin's value zeroed before the scan, and its stats (x + 0.0,
//   the plain version's sum over the bin axis) added to every prefix to
//   form the missing-left plane;
// - the prefix sums in scan.blocked_cumsum's order: sequential within
//   16-bin blocks, a sequential inclusive scan of the block totals, and the
//   total of the blocks before each block added to its elements (+0.0 to
//   the first block, which makes a -0.0 +0.0);
// - the gains and masks of both planes, then the tie band
//   best - TIE_RTOL * clamp(max(|best|, |parent gain|), 1), in which the
//   lowest flat (plane, feature, bin) index wins: index 0 where every
//   candidate is masked, the last index where none reaches the band (a NaN
//   maximum).
//
// Bound on the H100: bytes, each histogram read once (12 x F x B a leaf)
// plus one row read again a leaf: [255, 3, 700, 64] (Yahoo LTR) 137 MB,
// 0.041 ms at 3.35 TB/s; [255, 3, 28, 256] 22 MB, 0.0065 ms;
// [255, 3, 28, 64] 5.5 MB, under a launch's latency.
//
// Design. Launch 1 (rows): a (leaf, feature) row is G = B / 16 neighbouring
// threads of one warp, each holding one 16-bin block of the three channels
// in registers (twelve 16-byte loads; a warp's rows are neighbouring
// features, so its loads cover contiguous bytes). A thread scans its block,
// takes the totals of the blocks before it by shuffles in their order,
// scores both planes at its 16 bins under every mask, and the group's
// maximum of each plane (max is exact, so in any order; a NaN wins, as in
// torch's max) goes to an [L, 2, F] scratch. Launch 2 (elect): a block a
// leaf takes its best gain as the maximum of the 2F row maxima, the band's
// threshold, and the first (plane, feature) in flat order whose maximum
// reaches it, where the lowest flat index lies. One warp scores that row
// again, as launch 1 did, for its lowest bin in the band and writes the
// record. Nothing is allocated and nothing is read back: the pair captures
// into a CUDA graph.
#include "lgbt_common.cuh"

namespace {

constexpr int kBlk = 16;            // ops/scan.py SCAN_BLOCK
constexpr int kRowThreads = 256;    // launch 1: 256 / G rows a block
constexpr int kElectThreads = 256;  // launch 2: one block a leaf
constexpr unsigned kFull = 0xffffffffu;

// The split hyperparameters as the plain version meets them: Python floats
// rounded once to f32, and the constants of ops/split.py.
struct Search {
  float l1, l2, mds, min_data, min_hess, min_gain;
  float eps;          // _EPS_H
  float tie_rtol;     // TIE_RTOL
  float neg_inf;      // NEG_INF
  float found_floor;  // NEG_INF / 2
  int use_l1;         // lambda_l1 > 0
  int use_mds;        // max_delta_step > 0
};

// torch.max's NaN rule: a NaN operand wins.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// split.threshold_l1
__device__ __forceinline__ float threshold_l1(float s, const Search& p) {
  if (!p.use_l1) return s;
  float a = __fsub_rn(fabsf(s), p.l1);
  a = a != a ? a : fmaxf(a, 0.0f);
  const float sign = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(sign, a);
}

// split.leaf_split_gain: sg^2 / (h + l2 + eps), or under max_delta_step
// the gain at the clamped output (leaf_output, leaf_gain_given_output).
__device__ __forceinline__ float leaf_gain(float g, float h,
                                           const Search& p) {
  const float sg = threshold_l1(g, p);
  const float hl = __fadd_rn(h, p.l2);
  if (!p.use_mds) return __fdiv_rn(__fmul_rn(sg, sg), __fadd_rn(hl, p.eps));
  float w = __fdiv_rn(-sg, __fadd_rn(hl, p.eps));
  if (w == w) w = fminf(fmaxf(w, -p.mds), p.mds);
  return -__fadd_rn(__fmul_rn(__fmul_rn(2.0f, sg), w),
                    __fmul_rn(__fmul_rn(hl, w), w));
}

// best_split's gains_of at one threshold: both sides' gains where both
// sides hold enough rows and hessian, else NEG_INF.
__device__ __forceinline__ float split_gain(float lg, float lh, float lc,
                                            float pg, float ph, float pc,
                                            const Search& p) {
  const float rg = __fsub_rn(pg, lg);
  const float rh = __fsub_rn(ph, lh);
  const float rc = __fsub_rn(pc, lc);
  const bool ok = lc >= p.min_data && rc >= p.min_data &&
                  lh >= p.min_hess && rh >= p.min_hess;
  return ok ? __fadd_rn(leaf_gain(lg, lh, p), leaf_gain(rg, rh, p))
            : p.neg_inf;
}

// One thread's block k of row (l, f), its group the G threads of the row:
// cum[c][i] the inclusive prefix sum of channel c through bin 16 k + i in
// blocked_cumsum's order, the missing bin na zeroed; nav[c] the missing
// bin's value + 0.0 (0 when na >= B). Every lane of the warp calls it
// (shuffles); a lane whose row is not live reads nothing.
template <int G>
__device__ __forceinline__ void row_block(const float* __restrict__ hist,
                                          long long l, int f, int F, int k,
                                          int na, bool live,
                                          float cum[3][kBlk], float nav[3]) {
  constexpr int B = G * kBlk;
  const int na_k = na - k * kBlk;          // the missing bin in my block
  const int na_src = na < B ? na / kBlk : 0;
  float tot[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x[kBlk];
    if (live) {
      const float4* src = reinterpret_cast<const float4*>(
          hist + ((l * 3 + c) * F + f) * static_cast<long long>(B) +
          k * kBlk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(src + q);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBlk; ++i) x[i] = 0.0f;
    }
    float mine = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlk; ++i) {
      if (i == na_k) {
        mine = x[i];
        x[i] = 0.0f;
      }
    }
    const float na_v = __shfl_sync(kFull, mine, na_src, G);
    nav[c] = na < B ? __fadd_rn(na_v, 0.0f) : 0.0f;
    cum[c][0] = x[0];
#pragma unroll
    for (int i = 1; i < kBlk; ++i) cum[c][i] = __fadd_rn(cum[c][i - 1], x[i]);
    tot[c] = cum[c][kBlk - 1];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // the blocks before mine, summed left to right (0.0 for block 0)
    float excl = 0.0f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float t = __shfl_sync(kFull, tot[c], j, G);
      if (j < k) excl = j == 0 ? t : __fadd_rn(excl, t);
    }
#pragma unroll
    for (int i = 0; i < kBlk; ++i) cum[c][i] = __fadd_rn(cum[c][i], excl);
  }
}

// The candidate of plane d (0: missing right, 1: missing left) at bin b of
// a row: its gain, or NEG_INF where best_split masks it.
__device__ __forceinline__ float candidate(int d, int b, int nbins, int na,
                                           int B, bool fm, const float cum[3],
                                           const float nav[3], float pg,
                                           float ph, float pc,
                                           const Search& p) {
  const bool valid = fm && b < nbins - 1 && b != na && (d == 0 || na < B);
  if (!valid) return p.neg_inf;
  if (d == 0) return split_gain(cum[0], cum[1], cum[2], pg, ph, pc, p);
  return split_gain(__fadd_rn(cum[0], nav[0]), __fadd_rn(cum[1], nav[1]),
                    __fadd_rn(cum[2], nav[2]), pg, ph, pc, p);
}

// What a search reads: the frontier's histograms and per-feature tables,
// the leaves' parents and the masks.
struct Frontier {
  const float* hist;        // [L, 3, F, B], 16-byte aligned
  const int* num_bins;      // [F]
  const int* na_bin;        // [F], >= B: no missing bin
  const float* pg;          // [L] parent sums
  const float* ph;
  const float* pc;
  const uint8_t* fmask;     // [F] (fm_stride 0) or [L, F] bool
  int fm_stride;
  const uint8_t* allow;     // [L] bool
  int L, F;
};

// What it writes: best_split's SplitResult fields, [L] each but
// cat_member [L, B].
struct Record {
  float* gain;
  long long* feature;
  long long* bin;
  uint8_t* default_left;
  float* left_g;
  float* left_h;
  float* left_c;
  uint8_t* is_cat;
  uint8_t* cat_member;
};

// Launch 1: each (leaf, feature) row's maximum of each plane into
// rowmax [L, 2, F].
template <int G>
__device__ __forceinline__ void rows(const Frontier& fr, const Search& p,
                                     float* __restrict__ rowmax) {
  constexpr int B = G * kBlk;
  const int F = fr.F;
  const int k = (threadIdx.x & 31) % G;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kRowThreads / G) + threadIdx.x / G;
  const bool live = row < static_cast<long long>(fr.L) * F;
  const long long l = live ? row / F : 0;
  const int f = live ? static_cast<int>(row % F) : 0;
  const int na = fr.na_bin[f];
  const int nbins = fr.num_bins[f];
  const bool fm = live && fr.fmask[l * fr.fm_stride + f] != 0;
  float cum[3][kBlk], nav[3];
  row_block<G>(fr.hist, l, f, F, k, na, live, cum, nav);
  float m0 = p.neg_inf, m1 = p.neg_inf;
  if (fm) {
    const float pg = fr.pg[l], ph = fr.ph[l], pc = fr.pc[l];
#pragma unroll
    for (int i = 0; i < kBlk; ++i) {
      const float c3[3] = {cum[0][i], cum[1][i], cum[2][i]};
      const int b = k * kBlk + i;
      m0 = nanmax(m0, candidate(0, b, nbins, na, B, fm, c3, nav, pg, ph, pc,
                                p));
      if (na < B)
        m1 = nanmax(m1, candidate(1, b, nbins, na, B, fm, c3, nav, pg, ph,
                                  pc, p));
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    m0 = nanmax(m0, __shfl_xor_sync(kFull, m0, off, G));
    m1 = nanmax(m1, __shfl_xor_sync(kFull, m1, off, G));
  }
  if (live && k == 0) {
    rowmax[(l * 2) * F + f] = m0;
    rowmax[(l * 2 + 1) * F + f] = m1;
  }
}

// Launch 2: one block a leaf elects its split and writes its record.
template <int G>
__device__ __forceinline__ void elect(const Frontier& fr, const Search& p,
                                      const float* __restrict__ rowmax,
                                      const Record& out) {
  constexpr int B = G * kBlk;
  constexpr int kWarps = kElectThreads / 32;
  __shared__ float s_max[kWarps];
  __shared__ int s_first[kWarps];
  const int F = fr.F;
  const int l = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* rm = rowmax + static_cast<long long>(l) * 2 * F;
  const int n_rows = 2 * F;

  // the best gain: the maximum of the row maxima
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = threadIdx.x; j < n_rows; j += kElectThreads)
    m = nanmax(m, rm[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  float best_raw = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) best_raw = nanmax(best_raw, s_max[w]);

  // the band: best - TIE_RTOL * clamp(max(|best|, |parent|), min=1), NaN
  // where either is (torch.maximum, torch.clamp)
  const float pg = fr.pg[l], ph = fr.ph[l], pc = fr.pc[l];
  const float parent = leaf_gain(pg, ph, p);
  const float a = fabsf(best_raw), b = fabsf(parent);
  float scale = (a != a || b != b) ? __int_as_float(0x7fc00000)
                                   : fmaxf(a, b);
  if (scale == scale) scale = fmaxf(scale, 1.0f);
  const float thr = __fsub_rn(best_raw, __fmul_rn(p.tie_rtol, scale));

  // the first (plane, feature) row whose maximum reaches the band
  int first = n_rows;
  for (int j = threadIdx.x; j < n_rows; j += kElectThreads) {
    if (rm[j] >= thr) {
      first = j;
      break;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(kFull, first, off));
  if (lane == 0) s_first[warp] = first;
  __syncthreads();
  first = s_first[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) first = min(first, s_first[w]);

  // none reaches it (a NaN): the last flat index, as the plain version's
  // clamp of its sentinel
  const bool none = first == n_rows;
  const int d = none ? 1 : first / F;
  const int f = none ? F - 1 : first % F;

  if (warp == 0) {
    // every lane's group scores the elected row; group 0 writes
    const int k = lane % G;
    const int na = fr.na_bin[f];
    const int nbins = fr.num_bins[f];
    const bool fm =
        fr.fmask[static_cast<long long>(l) * fr.fm_stride + f] != 0;
    float cum[3][kBlk], nav[3];
    row_block<G>(fr.hist, l, f, F, k, na, true, cum, nav);
    float val[kBlk];
    int mine = B;
#pragma unroll
    for (int i = kBlk - 1; i >= 0; --i) {
      const float c3[3] = {cum[0][i], cum[1][i], cum[2][i]};
      val[i] = candidate(d, k * kBlk + i, nbins, na, B, fm, c3, nav, pg, ph,
                         pc, p);
      if (val[i] >= thr) mine = k * kBlk + i;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      mine = min(mine, __shfl_xor_sync(kFull, mine, off, G));
    const int tb = none ? B - 1 : mine;
    if (lane < G && k == tb / kBlk) {
      float best = 0.0f, lg = 0.0f, lh = 0.0f, lc = 0.0f;
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
        if (i == tb % kBlk) {
          best = val[i];
          // the left stats: the prefix + 0.0, or + the missing bin's
          lg = __fadd_rn(cum[0][i], d == 1 ? nav[0] : 0.0f);
          lh = __fadd_rn(cum[1][i], d == 1 ? nav[1] : 0.0f);
          lc = __fadd_rn(cum[2][i], d == 1 ? nav[2] : 0.0f);
        }
      }
      const float imp = __fsub_rn(best, parent);
      const bool found = fr.allow[l] != 0 && best > p.found_floor &&
                         imp > p.min_gain && imp > 0.0f;
      out.gain[l] = found ? imp : p.neg_inf;
      out.feature[l] = f;
      out.bin[l] = tb;
      out.default_left[l] = d == 1;
      out.left_g[l] = lg;
      out.left_h[l] = lh;
      out.left_c[l] = lc;
    }
  }
  if (threadIdx.x == 0) out.is_cat[l] = 0;
  for (int j = threadIdx.x; j < B; j += kElectThreads)
    out.cat_member[static_cast<long long>(l) * B + j] = 0;
}

// The launches by bin axis, each a kernel of its own name (a profile
// attributes its time by name).
__global__ void __launch_bounds__(kRowThreads)
split_rows_b64_kernel(Frontier fr, Search p, float* rowmax) {
  rows<4>(fr, p, rowmax);
}
__global__ void __launch_bounds__(kRowThreads)
split_rows_b128_kernel(Frontier fr, Search p, float* rowmax) {
  rows<8>(fr, p, rowmax);
}
__global__ void __launch_bounds__(kRowThreads)
split_rows_b256_kernel(Frontier fr, Search p, float* rowmax) {
  rows<16>(fr, p, rowmax);
}
__global__ void __launch_bounds__(kElectThreads)
split_elect_b64_kernel(Frontier fr, Search p, const float* rowmax,
                       Record out) {
  elect<4>(fr, p, rowmax, out);
}
__global__ void __launch_bounds__(kElectThreads)
split_elect_b128_kernel(Frontier fr, Search p, const float* rowmax,
                        Record out) {
  elect<8>(fr, p, rowmax, out);
}
__global__ void __launch_bounds__(kElectThreads)
split_elect_b256_kernel(Frontier fr, Search p, const float* rowmax,
                        Record out) {
  elect<16>(fr, p, rowmax, out);
}

}  // namespace

// hist [L, 3, F, B] f32 (16-byte aligned, B in {64, 128, 256}); num_bins,
// na_bin [F] i32; pg, ph, pc [L] f32; fmask [F] (fm_stride 0) or [L, F]
// (fm_stride F) bool as bytes; allow [L] bool; rowmax [L * 2 * F] f32
// scratch. Writes gain, left_g/h/c [L] f32, feature and bin [L] i64,
// default_left and is_cat [L] bool, cat_member [L, B] bool. Returns
// cudaGetLastError() after the launches.
extern "C" int lgbt_split_search(
    const float* hist, const int* num_bins, const int* na_bin,
    const float* pg, const float* ph, const float* pc, const uint8_t* fmask,
    int fm_stride, const uint8_t* allow, int L, int F, int B, float l1,
    float l2, float mds, float min_data, float min_hess, float min_gain,
    float eps, float tie_rtol, float neg_inf, float found_floor, int use_l1,
    int use_mds, float* rowmax, float* gain, long long* feature,
    long long* bin, uint8_t* default_left, float* left_g, float* left_h,
    float* left_c, uint8_t* is_cat, uint8_t* cat_member,
    cudaStream_t stream) {
  if (L < 1 || F < 1 || (B != 64 && B != 128 && B != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const Frontier fr{hist, num_bins, na_bin, pg,    ph, pc,
                    fmask, fm_stride, allow, L, F};
  const Search p{l1,       l2,          mds,      min_data, min_hess,
                 min_gain, eps,         tie_rtol, neg_inf,  found_floor,
                 use_l1,   use_mds};
  const Record out{gain,   feature, bin,    default_left, left_g,
                   left_h, left_c,  is_cat, cat_member};
  const int G = B / kBlk;
  const long long rows_ = static_cast<long long>(L) * F;
  const long long blocks = (rows_ + kRowThreads / G - 1) / (kRowThreads / G);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (B == 64)
    split_rows_b64_kernel<<<grid, kRowThreads, 0, stream>>>(fr, p, rowmax);
  else if (B == 128)
    split_rows_b128_kernel<<<grid, kRowThreads, 0, stream>>>(fr, p, rowmax);
  else
    split_rows_b256_kernel<<<grid, kRowThreads, 0, stream>>>(fr, p, rowmax);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 64)
    split_elect_b64_kernel<<<L, kElectThreads, 0, stream>>>(fr, p, rowmax,
                                                            out);
  else if (B == 128)
    split_elect_b128_kernel<<<L, kElectThreads, 0, stream>>>(fr, p, rowmax,
                                                             out);
  else
    split_elect_b256_kernel<<<L, kElectThreads, 0, stream>>>(fr, p, rowmax,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}
