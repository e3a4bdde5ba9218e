// Blocked-ELL multi-vector SpMM for Hopper (sm_90a): the block-Lanczos
// operator application, y[r, :] = Σ_w vals[r, w] · x[cols[r, w], :].
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
