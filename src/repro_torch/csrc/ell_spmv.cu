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
// in L2 by itself, so the design is about keeping the slot stream moving:
//   * a block owns a run of whole rows, a multiple of 4 (so its run of
//     slots starts 16-byte aligned for any W), sized to about 2048 slots;
//     it reads that run as one flat, coalesced stream of int4 / float4 with
//     the streaming hint (ld.global.cs: the slots are read once);
//   * each thread loads all of its slots first, then issues all of their x
//     gathers, then multiplies: 8 gathers in flight a thread, not one;
//   * the products go to shared memory in slot order, and 8 lanes sum each
//     row's W products there and combine with shuffles.  The plain version
//     reduces in another order, hence a stated tolerance rather than bit
//     equality.  Padding slots (col 0, val 0) add 0; the ragged last block
//     and a run whose length is not a multiple of 4 are masked.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;   // 16-byte chunks of slots a thread loads per pass
constexpr int kLanes = 8;    // lanes per row in the row sums
constexpr int kTargetSlots = kThreads * 4 * kChunks;  // 2048 slots a block

__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const float* __restrict__ x, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows, int w, int rows_pb,
                float* __restrict__ y) {
  extern __shared__ __align__(16) float prod[];  // [rows_pb * w] products
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows_pb;
  const int rows = min(rows_pb, n_rows - row0);
  const int len = rows * w;
  const long long s0 = (long long)row0 * w;  // a multiple of 4
  const int4* c4 = reinterpret_cast<const int4*>(cols + s0);
  const float4* v4 = reinterpret_cast<const float4*>(vals + s0);
  const int full = len / 4;

  for (int base = 0; base < full; base += kThreads * kChunks) {
    int4 ci[kChunks];
    float4 vi[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int q = base + j * kThreads + tid;
      if (q < full) {
        ci[j] = __ldcs(c4 + q);
        vi[j] = __ldcs(v4 + q);
      } else {
        ci[j] = make_int4(0, 0, 0, 0);
        vi[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float xv[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const bool ok = base + j * kThreads + tid < full;
      xv[j][0] = ok ? __ldg(x + ci[j].x) : 0.f;
      xv[j][1] = ok ? __ldg(x + ci[j].y) : 0.f;
      xv[j][2] = ok ? __ldg(x + ci[j].z) : 0.f;
      xv[j][3] = ok ? __ldg(x + ci[j].w) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int q = base + j * kThreads + tid;
      if (q < full)
        reinterpret_cast<float4*>(prod)[q] = make_float4(
            vi[j].x * xv[j][0], vi[j].y * xv[j][1], vi[j].z * xv[j][2], vi[j].w * xv[j][3]);
    }
  }
  if (tid < len - 4 * full) {  // the last 1-3 slots of a ragged run
    const int s = 4 * full + tid;
    prod[s] = vals[s0 + s] * __ldg(x + cols[s0 + s]);
  }
  __syncthreads();

  // 8 lanes a row, 32 rows a pass; the 8 lanes of a row are one aligned
  // eighth of the warp, so xor 4..1 stays in it
  const int lane = tid % kLanes;
  for (int rb = 0; rb < rows; rb += kThreads / kLanes) {
    const int r = rb + tid / kLanes;
    float acc = 0.f;
    if (r < rows)
      for (int s = lane; s < w; s += kLanes) acc += prod[r * w + s];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < rows && lane == 0) y[row0 + r] = acc;
  }
}

}  // namespace

// x [n], cols/vals [n_rows, w] row-major, y [n_rows]; all fp32 except cols
// (int32, every id in [0, n)); cols and vals 16-byte aligned.
extern "C" int ell_spmv_f32(const float* x, const int* cols, const float* vals,
                            int n, int n_rows, int w, float* y, void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const int rows_pb = w >= kTargetSlots / 4 ? 4 : kTargetSlots / w / 4 * 4;
  const int smem = rows_pb * w * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(ell_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_rows + rows_pb - 1) / rows_pb));
  ell_spmv_kernel<<<grid, kThreads, smem, st>>>(x, cols, vals, n_rows, w, rows_pb, y);
  return (int)cudaGetLastError();
}
