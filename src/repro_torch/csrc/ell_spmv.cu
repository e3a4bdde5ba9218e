// Blocked-ELL SpMV for Hopper (sm_90a): the single-vector operator
// application y[r] = Σ_w vals[r, w] · x[cols[r, w]] of the Chebyshev
// solver's spectral-bounds Lanczos (BlockEllOperator.mv).
//
// Replaces the TPU kernel ell_spmv_pallas / _kernel in
// src/repro/kernels/ell_spmv/kernel.py (the COO tail stays in the wrapper,
// as in the reference).
//
// What bounds it on the H100: bytes.  Every stored slot is read once (a
// 4-byte column id and a 4-byte value) for one multiply-add; x [n] is read
// and y [R] written — about 47 MB and 14 µs at R = 142,544, W = 40.  The
// TPU kernel streamed [rows, W] tiles of cols/vals into VMEM with perfect
// stride and gathered from a VMEM-resident x.  On the card x (0.6 MB) stays
// in L2 by itself, so the design is about reading the slot stream
// coalesced:
//   * a group of kLanes = 8 neighbouring lanes owns one row; lane l reads
//     slots l, l + 8, l + 16, ... so the 8 lanes of a row read 32
//     contiguous bytes of cols and of vals per step, and the 4 rows of a
//     warp are neighbours in memory — every sector fetched is used;
//   * each lane sums its slots with fused multiply-adds, then the 8 lanes
//     combine with shuffles.  The plain version reduces in another order,
//     hence a stated tolerance rather than bit equality.  Padding slots
//     (col 0, val 0) add 0.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes per row

__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const float* __restrict__ x, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows, int w,
                float* __restrict__ y) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t / kLanes;
  const int lane = (int)(t % kLanes);
  float acc = 0.f;
  if (r < n_rows) {
    const int* cr = cols + r * w;
    const float* vr = vals + r * w;
    for (int s = lane; s < w; s += kLanes) acc = fmaf(vr[s], __ldg(x + cr[s]), acc);
  }
  // the 8 lanes of a row are one aligned eighth of the warp: xor 4..1 stays in it
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && lane == 0) y[r] = acc;
}

}  // namespace

// x [n], cols/vals [n_rows, w] row-major, y [n_rows]; all fp32 except cols
// (int32, every id in [0, n)).
extern "C" int ell_spmv_f32(const float* x, const int* cols, const float* vals,
                            int n, int n_rows, int w, float* y, void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const long long threads = (long long)n_rows * kLanes;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  ell_spmv_kernel<<<grid, kThreads, 0, st>>>(x, cols, vals, n_rows, w, y);
  return (int)cudaGetLastError();
}
