// Level routing (DataPartition::Split): every row's histogram slot and new
// leaf id from its leaf's split, the first pass of a level on data too wide
// for the fused level pass (F * B > 2048).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py route_level_pallas
// (:1138), kernel body _route_kernel (:1078), for numerical splits.
//
// Bound on the H100: bytes. A row reads its leaf id (4 bytes) and one bin
// byte of its split feature and writes slot and new leaf id (8 bytes): at
// N = 10.5M, 137 MB, 0.041 ms at 3.35 TB/s. The bin byte is a gather across
// feature rows of bins_T, so in practice each row costs a 32-byte sector of
// it where neighbouring rows split on different features.
//
// Design: the TPU decoded each row's split with a one-hot [L, C] x [8, L]
// MXU product at HIGHEST precision (f32-encoded tables) and selected the
// row's bin with an [F, C] mask sum. Here one thread takes one row, reads
// the block's copy of the [6, L] int32 tables (feat, thr, dleft, new_leaf,
// slot_left, slot_right) from shared memory (6 KB at L = 255; tables too
// large for it are read from global memory) and reads its bin straight
// from bins_T[feat, r]. The routing itself is lgbt::route_row, which the
// fused level pass shares. Categorical membership is outside this kernel.
#include "lgbt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
route_level_kernel(const uint8_t* __restrict__ bins_T,
                   const int* __restrict__ lid, const int* __restrict__ tab_g,
                   const int* __restrict__ na_bin, int n, int f, int l, int s,
                   int use_smem, int* __restrict__ slot_out,
                   int* __restrict__ lid2_out) {
  extern __shared__ int tsh[];
  const int* tab = tab_g;
  if (use_smem) {
    for (int k = threadIdx.x; k < 6 * l; k += blockDim.x) tsh[k] = tab_g[k];
    __syncthreads();
    tab = tsh;
  }
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    int slot, nl;
    lgbt::route_row(bins_T, tab, na_bin, n, f, l, s, r, lid[r], slot, nl);
    slot_out[r] = slot;
    lid2_out[r] = nl;
  }
}

}  // namespace

// tab [6, L] i32; slot_out / lid2_out [N] i32. Returns cudaGetLastError()
// after the launch.
extern "C" int lgbt_route_level(const uint8_t* bins_T, const int* lid,
                                const int* tab, const int* na_bin, int n,
                                int f, int l, int s, int* slot_out,
                                int* lid2_out, int grid, cudaStream_t stream) {
  const size_t need = static_cast<size_t>(6) * l * sizeof(int);
  const int use_smem = need <= lgbt::kSmemBudget ? 1 : 0;
  const size_t smem = use_smem ? need : 0;
  const cudaError_t err = lgbt::allow_smem(route_level_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  route_level_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, lid, tab, na_bin, n, f, l, s, use_smem, slot_out, lid2_out);
  return static_cast<int>(cudaGetLastError());
}
