// Fused objective gradient + int8 stochastic-rounding quantization + root
// histogram.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py
// grad_quant_hist0_pallas (:918), kernel body _grad_quant_kernel (:807).
//
// Bound on the H100: bytes. One pass reads bins_T [F, N] u8 and
// score/aux/bag [N] f32 and writes gq/hq/cq [N] i8: about (F + 15) bytes a
// row, against a few dozen f32 operations a row. In practice the shared
// atomics of the root histogram (one a kept row and feature) bound it.
//
// Design: the TPU ran a two-phase sequential grid whose first phase left the
// global max|g| / max h in scratch for the second, and contracted a one-hot
// of the bins against the quantized channels on the MXU. Hopper blocks run
// in no order, so this is two launches on one stream:
// 1. max pass (max_kernel): four consecutive rows a thread (16-byte loads of
//    score, aux and bag where they start on 16 bytes, else four scalar
//    loads), g and h recomputed, the maxima folded into two device words
//    with atomicMax on the float bits (exact and order-free for
//    non-negative floats);
// 2. quantize + histogram pass (quant_hist_kernel): 1024-thread blocks, two
//    an SM, each over an equal range of consecutive rows
//    (ops/hist_kernels.py grad_quant_plan). A thread takes four consecutive
//    rows: the scales derived exactly as the reference does (scale_g
//    floored at 1e-20; under const-hessian scale_h = 127 * max h,
//    unfloored), g and h recomputed and quantized with the counter-hash
//    dither, one 4-byte store each of gq/hq/cq for the four, then for each
//    feature one 4-byte load of their four bins (a warp reads 128 B a
//    feature) and one shared atomic a kept row. Ranges of rows and stores
//    that do not start on a word, and the last N % 4 rows, take byte loads
//    and stores.
// The root histogram lives in shared memory. g and the count share one
// packed 32-bit cell a (feature, bin), so that a kept row adds one shared
// atomic a feature for both (the packed g/h lattice of the reference,
// pallas_hist.py:195-214, for the same reason: fewer accumulations), plus
// one into an int32 h cell with 3 channels:
//   bits  0-11  count, modulo 2^12      (at most kStepRows = 2^12 rows)
//   bits 12-31  sum of (gq + 127)       (at most 254 * 2^12 < 2^20)
// The offset keeps the g field non-negative, so it never borrows from the
// count. A count of exactly 2^12 (every row of a step in one cell) wraps
// to 0 and carries one into the g field; since only an empty cell holds 0,
// a cell whose count field is 0 and whose word is not counts 2^12 rows.
// Each block step adds kStepRows rows (1024 threads, four rows each), then
// the block drains the packed cells into int32 (g, count) cells of its own
// and zeroes them, so no field can overflow, whatever the bins. Rows with
// cq = 0 add nothing: their g and h are 0 * grad = 0 and quantize to
// floor(0 + u) = 0, so the count field counts exactly the rows that add.
// At the end each block adds its int32 channels [nch, F, B] into the
// global table with atomics. Integer sums make every order exact.
// (A 64-bit cell holding h too compiles, on sm_90a, to a compare-and-swap
// loop, ATOMS.CAST.SPIN.64, where a 32-bit add is one ATOMS.ADD; on an
// H100 it took the quantize + histogram pass to 1.015 ms against the
// earlier three 32-bit cells' 1.152, scripts/torch_profile_slot_hist.py
// --only b1.)
#include "lgbt_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kHistThreads = 1024;
// the packed cell: rows a block adds between drains, and the g field's
// first bit (must equal GQ_STEP_ROWS and GQ_FIELDS of ops/hist_kernels.py)
constexpr int kStepRows = 4 * kHistThreads;
constexpr int kGShift = 12;
constexpr uint32_t kCountMask = (1u << kGShift) - 1;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// rows r .. r + nr - 1 of p into v (nr <= 4; one 16-byte load when vec and
// all four are rows)
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          long long r, int nr, bool vec,
                                          float v[4]) {
  if (vec && nr == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + r);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < nr ? p[r + u] : 0.0f;
}

// g = grad * bag and h = hess * bag of row r (bag is the 0/1 row mask)
__device__ __forceinline__ void grad_row(const lgbt::GradSpec& sp,
                                         float score, float aux, float bag,
                                         float& g, float& h) {
  float grad, hess;
  lgbt::grad_rows(sp, score, aux, grad, hess);
  g = __fmul_rn(grad, bag);
  h = __fmul_rn(hess, bag);
}

__global__ void __launch_bounds__(kMaxThreads)
max_kernel(const float* __restrict__ score, const float* __restrict__ aux,
           const float* __restrict__ bag, int n, lgbt::GradSpec sp,
           int const_hess, unsigned int* __restrict__ mx) {
  __shared__ float red[32];
  float mg = 0.0f, mh = 0.0f;
  const bool vec = ((reinterpret_cast<uintptr_t>(score) |
                     reinterpret_cast<uintptr_t>(aux) |
                     reinterpret_cast<uintptr_t>(bag)) & 15) == 0;
  const long long nq = (static_cast<long long>(n) + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < nq; q += stride) {
    const long long r = 4 * q;
    const int nr = static_cast<int>(min(4LL, n - r));
    float s4[4], a4[4], b4[4];
    load_rows(score, r, nr, vec, s4);
    load_rows(aux, r, nr, vec, a4);
    load_rows(bag, r, nr, vec, b4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u >= nr) break;
      float g, h;
      grad_row(sp, s4[u], a4[u], b4[u], g, h);
      mg = fmaxf(mg, fabsf(g));
      mh = fmaxf(mh, const_hess ? h : fabsf(h));
    }
  }
  mg = block_max(mg, red);
  mh = block_max(mh, red);
  if (threadIdx.x == 0) {
    // canonical +0 for an all-zero block, so the uint compare stays monotone
    if (!(mg > 0.0f)) mg = 0.0f;
    if (!(mh > 0.0f)) mh = 0.0f;
    atomicMax(mx, __float_as_uint(mg));
    atomicMax(mx + 1, __float_as_uint(mh));
  }
}

__device__ __forceinline__ int quantize(float x, float mul, float u) {
  const float q = floorf(__fadd_rn(__fmul_rn(x, mul), u));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// the bytes of w as the int8 rows r .. r + nr - 1 of p (one 4-byte store
// when word and nr == 4)
__device__ __forceinline__ void store_rows(int8_t* __restrict__ p,
                                           long long r, int nr, bool word,
                                           uint32_t w) {
  if (word && nr == 4) {
    *reinterpret_cast<uint32_t*>(p + r) = w;
    return;
  }
  for (int u = 0; u < nr; ++u)
    p[r + u] = static_cast<int8_t>((w >> (8 * u)) & 0xffu);
}

// The four bins at col[0 .. nr) as the bytes of a word (one 4-byte load when
// col starts on a word and nr == 4; warp-uniform, as every lane's col
// differs by a multiple of 4)
__device__ __forceinline__ uint32_t load_bins(const uint8_t* __restrict__ col,
                                              int nr) {
  if (nr == 4 && (reinterpret_cast<uintptr_t>(col) & 3) == 0)
    return *reinterpret_cast<const uint32_t*>(col);
  uint32_t w = 0;
  for (int u = 0; u < nr; ++u) w |= static_cast<uint32_t>(col[u]) << (8 * u);
  return w;
}

// (g sum, count) of a packed cell (see the top of this file)
__device__ __forceinline__ void unpack(uint32_t v, int& g, int& c) {
  c = static_cast<int>(v & kCountMask);
  if (v && !c) c = kStepRows;
  g = static_cast<int>((v - static_cast<uint32_t>(c)) >> kGShift) - 127 * c;
}

// two blocks an SM: at most 32 registers a thread
__global__ void __launch_bounds__(kHistThreads, 2)
quant_hist_kernel(const uint8_t* __restrict__ bins_T,
                  const float* __restrict__ score,
                  const float* __restrict__ aux, const float* __restrict__ bag,
                  int n, int f, int b, lgbt::GradSpec sp, int const_hess,
                  unsigned int seed, const unsigned int* __restrict__ mx,
                  long long quads, int8_t* __restrict__ gq,
                  int8_t* __restrict__ hq, int8_t* __restrict__ cq,
                  float* __restrict__ scales, int* __restrict__ hist) {
  // [F, B] packed cells, then the int32 channels [nch, F, B] (g, [h,] count)
  extern __shared__ uint32_t sh[];
  const int fb = f * b;
  const int nch = const_hess ? 2 : 3;
  uint32_t* cell = sh;
  int* acc = reinterpret_cast<int*>(sh + fb);
  int* acc_h = acc + fb;
  int* acc_c = acc + (nch - 1) * fb;
  for (int k = threadIdx.x; k < (nch + 1) * fb; k += blockDim.x) sh[k] = 0u;
  __syncthreads();

  const float mg = __uint_as_float(mx[0]), mh = __uint_as_float(mx[1]);
  const float scale_g = fmaxf(mg, 1e-20f);
  const float scale_h = const_hess ? __fmul_rn(127.0f, mh) : fmaxf(mh, 1e-20f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scales[0] = scale_g;
    scales[1] = scale_h;
  }
  const float mul_g = __fdiv_rn(127.0f, scale_g);
  const float mul_h = __fdiv_rn(127.0f, scale_h);

  const bool vec = ((reinterpret_cast<uintptr_t>(score) |
                     reinterpret_cast<uintptr_t>(aux) |
                     reinterpret_cast<uintptr_t>(bag)) & 15) == 0;
  const bool word = ((reinterpret_cast<uintptr_t>(gq) |
                      reinterpret_cast<uintptr_t>(cq) |
                      reinterpret_cast<uintptr_t>(hq)) & 3) == 0;
  const long long nq = (static_cast<long long>(n) + 3) / 4;
  const long long q1 = min(nq, (blockIdx.x + 1LL) * quads);
  // block-uniform steps of blockDim.x groups of four rows
  for (long long base = blockIdx.x * quads; base < q1; base += blockDim.x) {
    const long long q = base + threadIdx.x;
    if (q < q1) {
      const long long r = 4 * q;
      const int nr = static_cast<int>(min(4LL, n - r));
      uint32_t gw = 0, hw = 0, cw = 0;   // the four rows' int8 bytes
      uint32_t w[4];                     // their packed (g, count) words
      int hv[4];
      {
        float s4[4], a4[4], b4[4];
        load_rows(score, r, nr, vec, s4);
        load_rows(aux, r, nr, vec, a4);
        load_rows(bag, r, nr, vec, b4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float g, h;
          grad_row(sp, s4[u], a4[u], b4[u], g, h);
          const uint32_t i = static_cast<uint32_t>(r + u);
          const int gi = quantize(g, mul_g, lgbt::sr_dither(i, seed, 1u));
          const int hi = const_hess
                             ? 0
                             : quantize(h, mul_h, lgbt::sr_dither(i, seed, 2u));
          const bool kept = u < nr && b4[u] > 0.0f;
          gw |= (static_cast<uint32_t>(gi) & 0xffu) << (8 * u);
          hw |= (static_cast<uint32_t>(hi) & 0xffu) << (8 * u);
          cw |= static_cast<uint32_t>(kept) << (8 * u);
          w[u] = kept ? 1u | static_cast<uint32_t>(gi + 127) << kGShift : 0u;
          hv[u] = kept ? hi : 0;
        }
      }
      store_rows(gq, r, nr, word, gw);
      store_rows(cq, r, nr, word, cw);
      if (!const_hess) store_rows(hq, r, nr, word, hw);
      if (w[0] | w[1] | w[2] | w[3]) {
        const uint8_t* col = bins_T + r;
        for (int j = 0; j < f; ++j, col += n) {
          const uint32_t bw = load_bins(col, nr);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int bin = (bw >> (8 * u)) & 0xffu;
            if (!w[u] || bin >= b) continue;
            atomicAdd(cell + j * b + bin, w[u]);
            if (hv[u]) atomicAdd(acc_h + j * b + bin, hv[u]);
          }
        }
      }
    }
    // drain: at most kStepRows rows entered each cell since the last one
    __syncthreads();
    for (int k = threadIdx.x; k < fb; k += blockDim.x) {
      const uint32_t v = cell[k];
      if (!v) continue;
      int g, c;
      unpack(v, g, c);
      acc[k] += g;
      acc_c[k] += c;
      cell[k] = 0u;
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < nch * fb; k += blockDim.x) {
    const int v = acc[k];
    if (v) atomicAdd(hist + k, v);
  }
}

}  // namespace

// mx [2] u32 and hist [nch * F * B] i32 must be zero on entry; hq may be null
// when const_hess is set. max_grid blocks of 256 threads take the max pass;
// blocks blocks of 1024 the quantize + histogram pass, block k over the
// rows [4 quads k, 4 quads (k + 1)) (ops/hist_kernels.py grad_quant_plan).
// Returns cudaGetLastError() after the two launches, or
// cudaErrorInvalidValue for a plan that leaves rows out or shared tables
// ((nch + 1) [F, B] words) over 48 KB.
extern "C" int lgbt_grad_quant_hist0(
    const uint8_t* bins_T, const float* score, const float* aux,
    const float* bag, int n, int f, int b, int kind, float sigmoid,
    float sig2, float lw_pos, float lw_neg, int const_hess, unsigned int seed,
    unsigned int* mx, int8_t* gq, int8_t* hq, int8_t* cq, float* scales,
    int* hist, int max_grid, int blocks, int quads, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(const_hess ? 3 : 4) * f * b * sizeof(uint32_t);
  if (max_grid < 1 || blocks < 1 || quads < 1 ||
      static_cast<long long>(blocks) * quads * 4 < n || smem > 48 * 1024 ||
      (!const_hess && !hq))
    return static_cast<int>(cudaErrorInvalidValue);
  const lgbt::GradSpec sp{kind, sigmoid, sig2, lw_pos, lw_neg};
  max_kernel<<<max_grid, kMaxThreads, 0, stream>>>(score, aux, bag, n, sp,
                                                   const_hess, mx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_hist_kernel<<<blocks, kHistThreads, smem, stream>>>(
      bins_T, score, aux, bag, n, f, b, sp, const_hess, seed, mx, quads, gq,
      hq, cq, scales, hist);
  return static_cast<int>(cudaGetLastError());
}
