// Fused k-means assignment for Hopper (sm_90a): the first pass of the
// paper's two-pass Lloyd iteration (Alg. 4), without the n×k distance
// matrix.  Per point row i:
//   min[i] = min_j (‖c_j‖² − 2 x_i·c_j)   (‖x_i‖² is added by the wrapper)
//   idx[i] = the lowest j attaining it
//
// Replaces the TPU kernel kmeans_assign_pallas / _kernel in
// src/repro/kernels/kmeans_assign/kernel.py.  The TPU kernel swept centroid
// tiles along the minor grid axis and folded a running (min, argmin) in its
// output block.  Here each block runs the tensor-core tile of
// kmeans_tile.cuh over its 128 rows (3xTF32 mma.sync, a cp.async ring; what
// bounds it and the design are noted there) and writes the result.  The
// fused iteration (kmeans_iter.cu) runs the same tile, so the two kernels'
// labels and distances agree bit for bit.
#include "kmeans_tile.cuh"

namespace {

using namespace kmeans_tile;

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ cn, int n, int k, int d,
                     float* __restrict__ out_min, int* __restrict__ out_idx) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  float v;
  int id;
  argmin_rows<VEC>(x, c, cn, n, k, d, row0, smem, v, id);
  if (tid < BM && row0 + tid < n) {
    out_min[row0 + tid] = v;
    out_idx[row0 + tid] = id;
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
  const bool wide = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(c) % 16) == 0;
  return (int)(wide ? launch_rows(kmeans_assign_kernel<4>, n, st, x, c, cn, n, k, d, out_min,
                                  out_idx)
                    : launch_rows(kmeans_assign_kernel<1>, n, st, x, c, cn, n, k, d, out_min,
                                  out_idx));
}
