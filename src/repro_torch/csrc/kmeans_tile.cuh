// The online (min, argmin) sweep of the fused k-means iteration
// (kmeans_iter.cu): for the BM point rows starting at row0,
// min_j (‖c_j‖² − 2 x_i·c_j) and the lowest j attaining it.  (The
// assignment kernel, kmeans_assign.cu, has its own tensor-core tile.)
//
// A block of kThreads = 256 threads owns BM = 64 rows and sweeps the
// centroids in tiles of BN = 64, staging BK = 16-wide slices of the row
// tile and the centroid tile in shared memory; each thread holds a TM×TN
// = 4×4 register tile of dot products (a plain SIMT fp32 GEMM — no TF32,
// labels are held to fp32 distances).  Block b starts its sweep at
// centroid tile b mod (number of tiles) and wraps around, so that the
// resident blocks do not all read the same centroid tile at the same
// moment.  Within a tile each thread scans its 4 centroids in order with a
// strict <, the 16 threads that share rows combine with shuffles, and
// across tiles an equal distance keeps the lower index: ties go to the
// lowest index whatever the sweep order, as in the reference.  Ragged row,
// centroid and depth tiles are masked, so any n, k and d work.  On return
// the threads with tx == 0 hold the final (best, bidx) of rows
// ty·TM .. ty·TM + 3.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace kmeans_tile {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // centroids per tile
constexpr int BK = 16;   // depth per shared-memory slice
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // centroids per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

struct Smem {
  __align__(16) float xs[BK][BM + 4];  // transposed row slice
  __align__(16) float cs[BK][BN + 4];  // transposed centroid slice
};

__device__ __forceinline__ void argmin_rows(const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            const float* __restrict__ cn, int n, int k,
                                            int d, int row0, Smem& sm, float (&best)[TM],
                                            int (&bidx)[TM]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // centroid group
  const int ty = tid / (BN / TN);  // row group
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = CUDART_INF_F;
    bidx[i] = 0;
  }

  const int n_tiles = (k + BN - 1) / BN;
  const int t0 = (int)(blockIdx.x % n_tiles);
  for (int t = 0; t < n_tiles; ++t) {
    const int tile = t0 + t < n_tiles ? t0 + t : t0 + t - n_tiles;
    const int c0 = tile * BN;
    float dot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dot[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        sm.xs[kk][r] = (gr < n && gk < d) ? x[(long long)gr * d + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        sm.cs[kk][r] = (gc < k && gk < d) ? c[(long long)gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&sm.cs[kk][tx * TN]);
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
      if (v < best[i] || (v == best[i] && id < bidx[i])) {
        best[i] = v;
        bidx[i] = id;
      }
    }
  }
}

}  // namespace kmeans_tile
