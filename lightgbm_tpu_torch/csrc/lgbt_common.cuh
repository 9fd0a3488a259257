// Shared device helpers of the training-path kernels.
//
// grad_rows() is the in-register gradient replica of the fused objective
// front (lightgbm_tpu/ops/pallas_hist.py _grad_rows). Every multiply, add and
// divide is spelled with the round-to-nearest intrinsics and in the
// reference's association order, so nvcc cannot contract a pair into an FMA
// (the library is also built with -fmad=false) and each f32 result is the
// value the JAX objective computes. expf is the precise CUDA libm exp; no
// fast-math anywhere.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

// kind 0: ("l2",)  grad = score - aux, hess = 1
// kind 1: ("logloss", sigmoid, lw_pos, lw_neg)
// sig2 is sigmoid * sigmoid rounded once to f32, as the reference folds the
// two Python floats before they meet the f32 row.
struct GradSpec {
  int kind;
  float sigmoid;
  float sig2;
  float lw_pos;
  float lw_neg;
};

__device__ __forceinline__ void grad_rows(const GradSpec& sp, float score,
                                          float aux, float& grad,
                                          float& hess) {
  if (sp.kind == 0) {
    grad = __fsub_rn(score, aux);
    hess = 1.0f;
    return;
  }
  const float t = __fsub_rn(__fmul_rn(2.0f, aux), 1.0f);
  const float lw = aux > 0.0f ? sp.lw_pos : sp.lw_neg;
  const float e = expf(__fmul_rn(__fmul_rn(t, sp.sigmoid), score));
  const float resp = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
  grad = __fmul_rn(__fmul_rn(__fmul_rn(-t, resp), sp.sigmoid), lw);
  hess = __fmul_rn(__fmul_rn(__fmul_rn(sp.sig2, resp), __fsub_rn(1.0f, resp)),
                   lw);
}

// Counter-hash dither of the stochastic-rounding quantizer
// (lightgbm_tpu/ops/histogram.py quantize_sr), in native uint32.
__device__ __forceinline__ float sr_dither(uint32_t idx, uint32_t seed,
                                           uint32_t salt) {
  const uint32_t i = idx + salt * 0x632BE59Bu;
  uint32_t z = (i ^ (seed * 0x9E3779B9u)) * 2654435761u;
  z = (z ^ (z >> 15)) * 2246822519u;
  z = z ^ (z >> 13);
  return __fmul_rn(static_cast<float>(z >> 8), 1.0f / 16777216.0f);
}

// Rows r .. r + nr - 1 of a 32-bit row vector p into v (nr <= 4; v[u] = 0
// for u >= nr): one 16-byte load when vec (every row vector of the kernel
// starts on 16 bytes) and all four are rows, else scalar loads.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ p,
                                          long long r, int nr, bool vec,
                                          T v[4]) {
  static_assert(sizeof(T) == 4, "32-bit rows");
  if (vec && nr == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p + r);
    memcpy(&v[0], &x.x, 4);
    memcpy(&v[1], &x.y, 4);
    memcpy(&v[2], &x.z, 4);
    memcpy(&v[3], &x.w, 4);
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < nr ? p[r + u] : T(0);
}

// DataPartition::Split for one row: the (slot, new leaf id) of row r in leaf
// lf through the route tables, int32 rows of L (feat, thr, dleft, new_leaf,
// slot_left, slot_right, then is_cat when bits is not null). A numerical
// split sends a bin equal to the feature's missing bin right iff dleft == 0,
// any other bin iff bin > thr. A categorical split (bits not null and
// is_cat[lf] set) sends a bin left iff its bit is set in the leaf's w words
// of bits ([L, w], bit b of word b / 32; LightGBM's cat_threshold bitset,
// tree.h FindInBitset), and every other bin right, the missing bin
// included. Rows of a leaf that does not split (feat outside [0, F)) or of
// no leaf keep their id and get the dropped slot s. A level without a
// categorical split passes a null bits and never reads an is_cat row.
__device__ __forceinline__ void route_row(const uint8_t* __restrict__ bins_T,
                                          const int* tab, const uint32_t* bits,
                                          int w,
                                          const int* __restrict__ na_bin,
                                          int n, int f, int l, int s, int r,
                                          int lf, int& slot, int& new_leaf) {
  slot = s;
  new_leaf = lf;
  if (lf < 0 || lf >= l) return;
  const int ft = tab[lf];
  if (ft < 0 || ft >= f) return;
  const int colv = bins_T[static_cast<size_t>(ft) * n + r];
  bool right;
  if (bits && tab[6 * l + lf]) {
    const int word = colv >> 5;
    right = word >= w ||
            !((bits[static_cast<size_t>(lf) * w + word] >> (colv & 31)) & 1u);
  } else {
    right = colv == __ldg(na_bin + ft) ? tab[2 * l + lf] == 0
                                       : colv > tab[l + lf];
  }
  if (right) new_leaf = tab[3 * l + lf];
  slot = right ? tab[5 * l + lf] : tab[4 * l + lf];
}

// Add one row's channels (g[, h], count) into a histogram laid out
// [..][nch][width][B] with channel stride ch_stride = width * B: base points
// at the row's slot and first feature, col at the row's bin of that feature
// in bins_T (feature stride n). T is int (int8 quantized channels, exact
// sums) or float (f32 rows). Bins >= b are dropped; zero values are skipped
// (adding 0 to a cell that starts at +0 changes no sum).
template <typename T>
__device__ __forceinline__ void add_row(T* base, int ch_stride, int nch,
                                        const uint8_t* __restrict__ col,
                                        size_t n, int fcnt, int b, T gv, T hv,
                                        T cv) {
  for (int j = 0; j < fcnt; ++j) {
    const int bin = col[j * n];
    if (bin >= b) continue;
    T* cell = base + j * b + bin;
    if (gv != T(0)) atomicAdd(cell, gv);
    if (hv != T(0)) atomicAdd(cell + ch_stride, hv);
    if (cv != T(0)) atomicAdd(cell + (nch - 1) * ch_stride, cv);
  }
}

// Flush a block-private [ss][nch][fg][B] shared histogram (features
// f0 .. f0 + fcnt - 1, slots s0 .. s0 + ss - 1) into the global
// [S][nch][F][B] histogram with atomicAdd. Call after __syncthreads().
template <typename T>
__device__ __forceinline__ void flush_hist(const T* sh, int ss, int nch,
                                           int fg, int fcnt, int b, int s0,
                                           int f0, int f, T* hist) {
  const int total = ss * nch * fg * b;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const T v = sh[k];
    if (v == T(0)) continue;
    const int bin = k % b;
    const int j = (k / b) % fg;
    const int sc = k / (fg * b);  // local slot * nch + channel
    if (j >= fcnt) continue;
    atomicAdd(hist + (static_cast<size_t>(s0 * nch + sc) * f + f0 + j) * b +
                  bin,
              v);
  }
}

// Shared-memory budget of one block's private table (the H100 allows 227 KB
// a block; the rest is headroom for the runtime's reservation). Must equal
// SMEM_BUDGET of ops/hist_kernels.py.
constexpr size_t kSmemBudget = 200 * 1024;

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lgbt
