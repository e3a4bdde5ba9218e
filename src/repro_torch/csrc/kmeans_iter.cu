// Fused k-means (Lloyd) iteration for Hopper (sm_90a): assignment and
// centroid accumulation from one pass over the points.
//
// Replaces the TPU kernel kmeans_iter_pallas / _kernel in
// src/repro/kernels/kmeans_iter/kernel.py.  Per point row i:
//   min[i] = min_j (‖c_j‖² − 2 x_i·c_j)   (‖x_i‖² is added by the wrapper)
//   idx[i] = the lowest j attaining it
// and acc[idx[i], :d] += x_i, acc[idx[i], d] += 1  (sums and counts).
//
// What bounds it on the H100: arithmetic.  The distance products are
// 2·n·k·d flops (7.1e10 at n = 142,541, k = d = 500); the bytes (x once,
// 285 MB) take a tenth of that time.  The TPU kernel ran the distance tile
// on the MXU and accumulated with a one-hot MXU contraction into a
// [k, d+1] accumulator resident in VMEM, visited in grid order.  On the
// card blocks run in no order and the accumulator (1 MB at k = d = 500)
// does not fit in the 227 KB of shared memory, so:
//   * a block owns 64 rows and finds their labels with the tiled online
//     argmin of kmeans_tile.cuh (ties to the lowest index);
//   * once a row tile's labels are final, its rows are added to a global
//     [k, d+1] accumulator with atomicAdd (neighbouring threads add
//     neighbouring columns of one row, so each warp's atomics coalesce);
//     the counts ride in column d.  Counts are exact (sums of 1.0 below
//     2^24); the order of the float sums varies from run to run.
// Any n, k and d: ragged tiles are masked, and nothing depends on a
// shared-memory budget for the accumulator.
#include "kmeans_tile.cuh"

namespace {

using namespace kmeans_tile;

__global__ void __launch_bounds__(kThreads)
kmeans_iter_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ cn, int n, int k, int d,
                   float* __restrict__ out_min, int* __restrict__ out_idx,
                   float* __restrict__ acc) {
  __shared__ Smem sm;
  __shared__ int lab[BM];
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
      const int r = ty * TM + i;
      lab[r] = bidx[i];
      if (row0 + r < n) {
        out_min[row0 + r] = best[i];
        out_idx[row0 + r] = bidx[i];
      }
    }
  }
  __syncthreads();
  const int rows = min(BM, n - row0);
  const long long dp1 = (long long)d + 1;
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, j = e % d;
    atomicAdd(&acc[lab[r] * dp1 + j], x[(long long)(row0 + r) * d + j]);
  }
  for (int r = tid; r < rows; r += kThreads) atomicAdd(&acc[lab[r] * dp1 + d], 1.f);
}

}  // namespace

// x [n, d], c [k, d] row-major fp32; cn [k] = ‖c_j‖²; out_min [n] fp32,
// out_idx [n] int32; acc [k, d+1] fp32, zeroed by the caller.
extern "C" int kmeans_iter_f32(const float* x, const float* c, const float* cn,
                               int n, int k, int d, float* out_min, int* out_idx,
                               float* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const dim3 grid((n + BM - 1) / BM);
  kmeans_iter_kernel<<<grid, kThreads, 0, st>>>(x, c, cn, n, k, d, out_min, out_idx, acc);
  return (int)cudaGetLastError();
}
