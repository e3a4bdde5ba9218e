// Random-hyperplane LSH hashing for Hopper (sm_90a): the compute core of
// the approximate Stage 1.  Per table t and point i, with
// proj[b] = Σ_j x[i, j] · planes[t, j, b]:
//   codes[t, i] = Σ_{b < n_bits} (proj[b] ≥ 0) · 2^b     (int32)
//   tie[t, i]   = proj[n_bits]                           (the tie-break)
//
// Replaces the TPU kernel hash_codes_pallas / _kernel in
// src/repro/kernels/lsh_candidates/kernel.py.
//
// What bounds it on the H100: bytes.  At the DTI shapes (n = 142,541 points
// in d = 3, T = 16 tables of 16 bits + 1 tie column) the outputs are
// 18 MB and the work 0.23 GFLOP — about 6 µs at 3.35 TB/s.  The TPU kernel
// ran one [block_n, d] × [d, 128] MXU product per (table, point block) and
// packed the signs with a masked power-of-two contraction.  With d this
// small a matrix unit has nothing to do, so on the card:
//   * one thread per (point, table): blockIdx.y is the table, neighbouring
//     threads take neighbouring points, so the codes and tie-breaks of a
//     table are written as coalesced rows;
//   * each thread computes the n_bits + 1 projections with fused
//     multiply-adds in order j = 0..d−1, setting bit b with a shift; the
//     table's planes (d·(n_bits + 1) floats) are read through the read-only
//     cache, the same addresses for every thread of a warp.
// The plain version sums the projections in another order, so a projection
// within rounding of 0 may take the other sign; the checks compare codes
// exactly only where every |proj| exceeds a stated margin.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_codes_kernel(const float* __restrict__ x, const float* __restrict__ planes, int n,
                  int d, int n_bits, int* __restrict__ codes, float* __restrict__ tie) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int t = blockIdx.y;
  if (i >= n) return;
  const int cols = n_bits + 1;
  const float* xi = x + (long long)i * d;
  const float* pt = planes + (long long)t * d * cols;
  int code = 0;
  for (int b = 0; b < n_bits; ++b) {
    float p = 0.f;
    for (int j = 0; j < d; ++j) p = fmaf(xi[j], __ldg(pt + j * cols + b), p);
    code |= (p >= 0.f ? 1 : 0) << b;
  }
  float p = 0.f;
  for (int j = 0; j < d; ++j) p = fmaf(xi[j], __ldg(pt + j * cols + n_bits), p);
  codes[(long long)t * n + i] = code;
  tie[(long long)t * n + i] = p;
}

}  // namespace

// x [n, d] fp32, planes [T, d, n_bits + 1] fp32 (row-major), 1 ≤ n_bits ≤ 24;
// codes [T, n] int32, tie [T, n] fp32.
extern "C" int hash_codes_f32(const float* x, const float* planes, int n, int d,
                              int n_tables, int n_bits, int* codes, float* tie,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)n_tables);
  hash_codes_kernel<<<grid, kThreads, 0, st>>>(x, planes, n, d, n_bits, codes, tie);
  return (int)cudaGetLastError();
}
