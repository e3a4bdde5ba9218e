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
//   * a block owns 64 rows and sweeps the centroids in tiles of 64, staging
//     16-wide slices of the row tile and the centroid tile in shared memory;
//     each of 256 threads holds a 4×4 register tile of dot products (a
//     plain SIMT fp32 GEMM — no TF32, labels are held to fp32 distances);
//   * the argmin is online: within a tile each thread scans its 4 centroids
//     in order with a strict <, the 16 threads that share rows combine with
//     shuffles (lower index wins a tie), and across tiles a strict < keeps
//     the earlier tile — ties go to the lowest index, as in the reference;
//   * once a row tile's labels are final, its rows are added to a global
//     [k, d+1] accumulator with atomicAdd (neighbouring threads add
//     neighbouring columns of one row, so each warp's atomics coalesce);
//     the counts ride in column d.  Counts are exact (sums of 1.0 below
//     2^24); the order of the float sums varies from run to run.
// Any n, k and d: ragged tiles are masked, and nothing depends on a
// shared-memory budget for the accumulator.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // centroids per tile
constexpr int BK = 16;   // depth per shared-memory slice
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // centroids per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(kThreads)
kmeans_iter_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ cn, int n, int k, int d,
                   float* __restrict__ out_min, int* __restrict__ out_idx,
                   float* __restrict__ acc) {
  __shared__ __align__(16) float xs[BK][BM + 4];  // transposed row slice
  __shared__ __align__(16) float cs[BK][BN + 4];  // transposed centroid slice
  __shared__ int lab[BM];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // centroid group
  const int ty = tid / (BN / TN);  // row group
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = CUDART_INF_F;
    bidx[i] = 0;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float dot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dot[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[kk][r] = (gr < n && gk < d) ? x[(long long)gr * d + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        cs[kk][r] = (gc < k && gk < d) ? c[(long long)gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dot[i][j] = fmaf(av[i], bv[j], dot[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = CUDART_INF_F;
      int id = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cj = c0 + tx * TN + j;
        if (cj < k) {
          const float s = cn[cj] - 2.f * dot[i][j];
          if (s < v) {
            v = s;
            id = cj;
          }
        }
      }
      // the 16 threads sharing these rows are one half-warp: xor 8..1 stays in it
#pragma unroll
      for (int off = (BN / TN) / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, id, off);
        if (ov < v || (ov == v && oi < id)) {
          v = ov;
          id = oi;
        }
      }
      if (v < best[i]) {
        best[i] = v;
        bidx[i] = id;
      }
    }
  }

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
