// Fused k-means assignment for Hopper (sm_90a): the first pass of the
// paper's two-pass Lloyd iteration (Alg. 4), without the n×k distance
// matrix.  Per point row i:
//   min[i] = min_j (‖c_j‖² − 2 x_i·c_j)   (‖x_i‖² is added by the wrapper)
//   idx[i] = the lowest j attaining it
//
// Replaces the TPU kernel kmeans_assign_pallas / _kernel in
// src/repro/kernels/kmeans_assign/kernel.py.
//
// What bounds it on the H100: arithmetic, 2·n·k·d flops (7.1e10 at
// n = 142,541, k = d = 500, 1.06 ms at the fp32 peak); x is read once
// (285 MB, a tenth of that time).  The TPU kernel swept centroid tiles
// along the minor grid axis and folded a running (min, argmin) in its
// output block.  On the card a block owns 64 rows and runs the same
// online sweep inside the block (kmeans_tile.cuh, shared with the fused
// iteration kmeans_iter.cu): the distance tile never leaves registers,
// ties go to the lowest index, and ragged tiles are masked, so any n, k
// and d work without padding.
#include "kmeans_tile.cuh"

namespace {

using namespace kmeans_tile;

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ cn, int n, int k, int d,
                     float* __restrict__ out_min, int* __restrict__ out_idx) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  float best[TM];
  int bidx[TM];
  argmin_rows(x, c, cn, n, k, d, row0, sm, best, bidx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty * TM + i;
      if (r < n) {
        out_min[r] = best[i];
        out_idx[r] = bidx[i];
      }
    }
  }
}

}  // namespace

// x [n, d], c [k, d] row-major fp32; cn [k] = ‖c_j‖²; out_min [n] fp32,
// out_idx [n] int32.
extern "C" int kmeans_assign_f32(const float* x, const float* c, const float* cn,
                                 int n, int k, int d, float* out_min, int* out_idx,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const dim3 grid((n + BM - 1) / BM);
  kmeans_assign_kernel<<<grid, kThreads, 0, st>>>(x, c, cn, n, k, d, out_min, out_idx);
  return (int)cudaGetLastError();
}
