// Small-table gather: out[i] = table[idx[i]], 0 where idx is out of range.
// It is the per-tree score update (leaf value of each row's leaf).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py take_small_pallas
// (:1213), kernel body _take_kernel (:1199).
//
// Bound on the H100: bytes (4 in + 4 out a row; the table is at most 16 KB
// at the reference's L <= 4096): 84 MB at N = 10.5M, 0.025 ms at 3.35 TB/s.
//
// Design: the TPU had no hardware gather and expressed the lookup as a
// HIGHEST-precision one-hot [L, C] contraction. Here each block copies the
// table into shared memory (tables over 16 KB are read from global
// memory), and each thread moves four rows a step with one 16-byte
// load of idx and one 16-byte store of out, two steps in flight: a card
// full of 256-thread blocks then keeps about 8 MB of loads in flight, where
// a 4-byte row a thread kept about 1 MB, half of what HBM3 needs. The
// grid covers the card once. Rows past the last whole four (N % 4), and
// every row when idx or out does not start on 16 bytes (a sliced view), take
// a scalar grid-stride path. The loaded f32 value is the table entry itself,
// so the result is bit-exact.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTableMax = 4096;   // entries held in shared memory

__device__ __forceinline__ float take(const float* t, int l, int k) {
  return (k >= 0 && k < l) ? t[k] : 0.0f;
}

__device__ __forceinline__ float4 take4(const float* t, int l, int4 k) {
  return make_float4(take(t, l, k.x), take(t, l, k.y), take(t, l, k.z),
                     take(t, l, k.w));
}

__global__ void __launch_bounds__(kThreads)
take_kernel(const float* __restrict__ table, const int* __restrict__ idx,
            int n, int l, float* __restrict__ out) {
  extern __shared__ float tsh[];
  const float* t = table;
  if (l <= kTableMax) {
    for (int k = threadIdx.x; k < l; k += blockDim.x) tsh[k] = table[k];
    __syncthreads();
    t = tsh;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long i0 = 0;   // first row of the scalar path
  if (vec) {
    const long long nv = n / 4;
    const int4* iv = reinterpret_cast<const int4*>(idx);
    float4* ov = reinterpret_cast<float4*>(out);
    for (long long v = tid; v < nv; v += 2 * stride) {
      const long long v2 = v + stride;
      const int4 a = iv[v];
      const int4 b = v2 < nv ? iv[v2] : make_int4(-1, -1, -1, -1);
      ov[v] = take4(t, l, a);
      if (v2 < nv) ov[v2] = take4(t, l, b);
    }
    i0 = 4 * nv;
  }
  for (long long i = i0 + tid; i < n; i += stride) out[i] = take(t, l, idx[i]);
}

}  // namespace

// table [L] f32, idx [N] i32, out [N] f32; any alignment of idx and out.
// Returns cudaGetLastError() after the launch.
extern "C" int lgbt_take_small(const float* table, const int* idx, int n,
                               int l, float* out, int grid,
                               cudaStream_t stream) {
  if (l < 0 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = l <= kTableMax ? l * sizeof(float) : 0;
  take_kernel<<<grid, kThreads, smem, stream>>>(table, idx, n, l, out);
  return static_cast<int>(cudaGetLastError());
}
