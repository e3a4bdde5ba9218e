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
// 2·n·k·d flops; at fp32 accuracy on the tensor cores, three TF32 products:
// 3 × 7.1e10 flops / 495 TFLOP/s = 0.432 ms at n = 142,541, k = d = 500.
// Reading x once (285 MB) takes 0.085 ms; the accumulator is 1 MB.
//
// Design.  The TPU kernel found each row tile's labels with an online
// argmin on the MXU, then added the tile into a [k, d+1] accumulator
// resident in VMEM with a one-hot MXU contraction, visiting the grid in
// order.  On the card blocks run in no order, and the accumulator does not
// fit in the 227 KB of shared memory beside the argmin's ring, so:
//   * the labels come from the tensor-core tile of kmeans_tile.cuh, the one
//     the assignment kernel (kmeans_assign.cu) runs: the same 3xTF32
//     arithmetic, so the same labels and distances;
//   * once a block's 128 labels are final, its rows go into the global
//     accumulator with fire-and-forget atomics (RED).  At 255 registers the
//     tile runs one block per SM, so nothing hides this epilogue: it sits
//     between a block's last mma and the next block's first load.  The
//     block walks its rows in order, adds each run of equal labels in
//     registers and emits one RED per (run, column group): a 16-byte
//     red.global.add.v4.f32 of four columns where d % 4 == 0 and x is
//     16-byte aligned, else one column.  The accumulator's rows are padded
//     to a multiple of 4 floats (ldacc) for the 16-byte REDs; the counts
//     ride in column d.
//     Measured on an H100 80GB HBM3 at 700 W (tools/kmeans_iter_variants.py,
//     n = 142,541, k = d = 500; the exposed epilogue is this kernel's time
//     minus the assignment's and the accumulator's zero fill): 0.14 ms on
//     blobs (random labels, 128 runs in a 128-row block) and 0.10 ms on the
//     first path's embedding (voxel order, 27 runs).  One scalar RED per
//     (row, column), the scheme of the SIMT kernel this replaced, took 0.38
//     and 0.37 ms; four scalar REDs per run 0.41 and 0.14 ms.  Sorting the
//     block's rows by label first (113 and 13 runs) gained nothing (0.15,
//     0.12 ms), nor, in development runs, did more loads in flight.  What
//     is left is most likely the re-read of the block's 256 KB of x, which
//     every SM of a wave makes at once (not measured apart).
//   * Counts are exact (sums of 1.0 below 2^24); the order of the float sums
//     varies from run to run.  Any n, k and d: ragged tiles are masked, and
//     nothing depends on a shared-memory budget for the accumulator.
#include "kmeans_tile.cuh"

namespace {

using namespace kmeans_tile;

constexpr int kBatch = 8;     // epilogue loads in flight a thread
constexpr int kMaxParts = 16; // a block's rows split into at most this many parts

template <int VEC>
struct Cols;  // VEC columns of a row, as one value
template <>
struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T one() { return make_float4(1.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ void red(float* p, const T& v) {
    atomicAdd(reinterpret_cast<float4*>(p), v);  // result unused: one RED.128
  }
};
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T one() { return 1.f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ void red(float* p, const T& v) { atomicAdd(p, v); }
};

// Add rows [row0, row0 + rows) of x into acc[lab[r]] (sums in columns
// [0, d), the count in column d); lab [BM] in shared memory holds the
// block's labels.  Work item (u, p) takes column group u (the last one is
// the count) over the p-th run of rows: it adds each run of equal labels in
// registers and emits one RED per run, and neighbouring threads read
// neighbouring columns of one row, so their loads and REDs coalesce.
template <int VEC>
__device__ __forceinline__ void accumulate_rows(const float* __restrict__ x, int d, int row0,
                                                int rows, const int* lab,
                                                float* __restrict__ acc, int ldacc) {
  using C = Cols<VEC>;
  const int units = (d + VEC - 1) / VEC + 1;
  const int parts = max(1, min(kMaxParts, kThreads / units));
  const int len = (rows + parts - 1) / parts;
  for (int w = threadIdx.x; w < units * parts; w += kThreads) {
    const int u = w % units, beg = (w / units) * len;
    const int end = min(rows, beg + len);
    if (beg >= end) continue;
    const bool count = u == units - 1;
    const int col = count ? d : u * VEC;
    typename C::T sum = C::zero();
    int cur = lab[beg];
    for (int p0 = beg; p0 < end; p0 += kBatch) {
      typename C::T buf[kBatch];
      int lb[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {  // all loads first; past end, a repeat
        const int r = min(p0 + i, end - 1);
        lb[i] = lab[r];
        buf[i] = count ? C::one() : C::load(x + (long long)(row0 + r) * d + col);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (p0 + i < end) {
          if (lb[i] != cur) {
            C::red(acc + (long long)cur * ldacc + col, sum);
            sum = C::zero();
            cur = lb[i];
          }
          C::add(sum, buf[i]);
        }
      }
    }
    C::red(acc + (long long)cur * ldacc + col, sum);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_iter_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ cn, int n, int k, int d,
                   float* __restrict__ out_min, int* __restrict__ out_idx,
                   float* __restrict__ acc, int ldacc) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  float v;
  int id;
  argmin_rows<VEC>(x, c, cn, n, k, d, row0, smem, v, id);
  __syncthreads();  // every thread is done with the tile's scratch
  int* lab = reinterpret_cast<int*>(smem);
  if (tid < BM && row0 + tid < n) {
    lab[tid] = id;
    out_min[row0 + tid] = v;
    out_idx[row0 + tid] = id;
  }
  __syncthreads();
  accumulate_rows<VEC>(x, d, row0, min(BM, n - row0), lab, acc, ldacc);
}

}  // namespace

// x [n, d], c [k, d] row-major fp32; cn [k] = ‖c_j‖²; out_min [n] fp32,
// out_idx [n] int32; acc [k, ldacc] fp32, zeroed by the caller, 16-byte
// aligned, ldacc ≥ d + 1 a multiple of 4 (sums in columns [0, d), counts in
// column d).
extern "C" int kmeans_iter_f32(const float* x, const float* c, const float* cn,
                               int n, int k, int d, float* out_min, int* out_idx,
                               float* acc, int ldacc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (ldacc < d + 1 || ldacc % 4 || reinterpret_cast<uintptr_t>(acc) % 16)
    return (int)cudaErrorInvalidValue;
  const bool wide = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(c) % 16) == 0;
  return (int)(wide ? launch_rows(kmeans_iter_kernel<4>, n, st, x, c, cn, n, k, d, out_min,
                                  out_idx, acc, ldacc)
                    : launch_rows(kmeans_iter_kernel<1>, n, st, x, c, cn, n, k, d, out_min,
                                  out_idx, acc, ldacc));
}
