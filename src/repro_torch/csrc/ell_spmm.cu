// Blocked-ELL multi-vector SpMM for Hopper (sm_90a): the block-Lanczos
// operator application, y[r, :] = Σ_w vals[r, w] · x[cols[r, w], :], and
// the Chebyshev filter's fused three-term step (at the end of this file).
//
// Replaces the TPU kernel ell_spmm_pallas / _kernel in
// src/repro/kernels/ell_spmm/kernel.py (the COO tail stays in the wrapper,
// as in the reference).
//
// What bounds it on the H100: bytes.  Each stored slot is read once (a 4-byte
// column id and a 4-byte value) and feeds only 2·b flops; x [n, b] is read
// and y [R, b] written — about 50 MB and 15 µs at n = 142,541, W ≈ 40, b = 4.
// The TPU kernel kept all of x resident in VMEM and gathered from it with
// the vector unit.  On the card x (2.3 MB at b = 4) stays in the 50 MB L2
// by itself, so the design is about the gathers and the slot stream:
//   * one thread per (row, group of four right-hand sides); with b a
//     multiple of 4 each slot is one 16-byte float4 gather of x[col, 4g:4g+4],
//     so one load serves four columns and the slot stream is read once for
//     all b columns of the block;
//   * the thread walks its row's W slots in order with fused multiply-adds;
//     the plain version reduces in another order, hence a stated tolerance
//     rather than bit equality.  Padding slots (col 0, val 0) add 0;
//   * b must be a multiple of 4: the wrapper pads other blocks with zero
//     columns.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ell_spmm_vec4(const float4* __restrict__ x, const int* __restrict__ cols,
              const float* __restrict__ vals, int n_rows, int w, int groups,
              float4* __restrict__ y) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n_rows * groups) return;
  const int r = (int)(t / groups);
  const int g = (int)(t % groups);
  const int* cr = cols + (long long)r * w;
  const float* vr = vals + (long long)r * w;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < w; ++s) {
    const float v = vr[s];
    const float4 xv = x[(long long)cr[s] * groups + g];
    acc.x = fmaf(v, xv.x, acc.x);
    acc.y = fmaf(v, xv.y, acc.y);
    acc.z = fmaf(v, xv.z, acc.z);
    acc.w = fmaf(v, xv.w, acc.w);
  }
  y[t] = acc;
}

// The Chebyshev step: the same gather loop, then the epilogue
// y[r] = ca·acc + cb·x[r] − prev[r] with (ca, cb) read from device memory,
// so the filter never reads its scalars back to the host.
__global__ void __launch_bounds__(kThreads)
ell_spmm_cheb_vec4(const float4* __restrict__ x, const int* __restrict__ cols,
                   const float* __restrict__ vals, const float4* __restrict__ prev,
                   const float* __restrict__ coef, int n_out, int w, int groups,
                   float4* __restrict__ y) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n_out * groups) return;
  const int r = (int)(t / groups);
  const int g = (int)(t % groups);
  const int* cr = cols + (long long)r * w;
  const float* vr = vals + (long long)r * w;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < w; ++s) {
    const float v = vr[s];
    const float4 xv = x[(long long)cr[s] * groups + g];
    acc.x = fmaf(v, xv.x, acc.x);
    acc.y = fmaf(v, xv.y, acc.y);
    acc.z = fmaf(v, xv.z, acc.z);
    acc.w = fmaf(v, xv.w, acc.w);
  }
  const float ca = coef[0], cb = coef[1];
  const float4 xr = x[t], pr = prev[t];
  y[t] = make_float4(ca * acc.x + cb * xr.x - pr.x, ca * acc.y + cb * xr.y - pr.y,
                     ca * acc.z + cb * xr.z - pr.z, ca * acc.w + cb * xr.w - pr.w);
}

}  // namespace

// x [n, b], cols/vals [n_rows, w] row-major, y [n_rows, b]; all fp32 except
// cols (int32, every id in [0, n)).  b % 4 == 0; x and y 16-byte aligned.
extern "C" int ell_spmm_f32(const float* x, const int* cols, const float* vals,
                            int n, int n_rows, int w, int b, float* y,
                            void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const int groups = b / 4;
  const long long threads = (long long)n_rows * groups;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  ell_spmm_vec4<<<grid, kThreads, 0, st>>>(reinterpret_cast<const float4*>(x), cols,
                                           vals, n_rows, w, groups,
                                           reinterpret_cast<float4*>(y));
  return (int)cudaGetLastError();
}

// The fused Chebyshev step over the ELL body:
//   y[r, :] = ca·Σ_w vals[r, w]·x[cols[r, w], :] + cb·x[r, :] − prev[r, :]
// for the first n_out ≤ n rows only (rows ≥ n of the padded layout would
// see zero iterates and are never read, so they are not computed and x and
// prev need no padding).  Replaces ell_spmm_cheb_pallas / _cheb_kernel in
// src/repro/kernels/ell_spmm/kernel.py.  x, prev [n, b], y [n_out, b];
// coef = (ca, cb) in device memory; b % 4 == 0; x, prev, y 16-byte aligned.
//
// What bounds it: bytes.  At the Chebyshev filter's width (b = 508) the
// iterate x is 290 MB and no longer fits in the 50 MB L2, so the gathers
// of neighbour rows miss; each is a contiguous 2 KB row, read as 127
// coalesced float4 loads by neighbouring threads.  The epilogue saves the
// three elementwise passes (and their [n, b] temporaries) that an unfused
// step would stream through memory.
extern "C" int ell_spmm_cheb_f32(const float* x, const int* cols, const float* vals,
                                 const float* prev, const float* coef, int n,
                                 int n_out, int w, int b, float* y, void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const int groups = b / 4;
  const long long threads = (long long)n_out * groups;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  ell_spmm_cheb_vec4<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(x), cols, vals, reinterpret_cast<const float4*>(prev),
      coef, n_out, w, groups, reinterpret_cast<float4*>(y));
  return (int)cudaGetLastError();
}
