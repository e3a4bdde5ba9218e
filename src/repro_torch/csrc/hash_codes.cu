// Random-hyperplane LSH hashing for Hopper (sm_90a): the compute core of
// the approximate Stage 1, and the hash of a query batch on the serving
// path.  Per table t and point i, with
// proj[b] = Σ_j x[i, j] · planes[t, j, b]:
//   codes[t, i] = Σ_{b < n_bits} (proj[b] ≥ 0) · 2^b     (int32)
//   tie[t, i]   = proj[n_bits]                           (the tie-break)
//
// Replaces the TPU kernel hash_codes_pallas / _kernel in
// src/repro/kernels/lsh_candidates/kernel.py.
//
// What bounds it on the H100: bytes.  At the DTI shapes (n = 142,541 points
// in d = 3, T = 16 tables of 16 bits + 1 tie column) the outputs are
// 18 MB and the work 0.23 GFLOP — about 6 µs at 3.35 TB/s; a serving batch
// ([256 × 16]) is a few µs of launch.  The TPU kernel ran one
// [block_n, d] × [d, 128] MXU product per (table, point block) and packed
// the signs with a masked power-of-two contraction.  With d this small a
// matrix unit has nothing to do, so on the card:
//   * one thread per point takes every table of its block's group of
//     kTablesABlock = 8 (5 % faster at the lattice shape than all 16 in
//     one group, with twice the warps in flight; groups of 4, 2 and 1 were
//     slower, 64 threads a block slower and 256 no faster:
//     tools/hash_codes_variants.py); its x row is read once, into registers
//     when d ≤ 16 (d a template parameter, the loops unrolled; a runtime-d
//     instantiation reads the row through L1 above that);
//   * when those blocks would leave SMs idle (a batch of a few hundred
//     points makes 4), a block of one warp takes one table instead:
//     [256 × 16] with 16 tables makes 128 blocks.  Both mappings are
//     compile-time constants of the kernel (the tables a block and the
//     threads): with both runtime values the lattice shape ran 7 % slower;
//   * each block stages its group's planes in shared memory once, as
//     [t][j][column] rows padded to a multiple of 4 columns (1.9 KB here;
//     wider shapes in chunks of tables), so one 16-byte broadcast load
//     feeds four projections of every thread of a warp;
//   * each projection is a chain of fused multiply-adds in order
//     j = 0..d−1 from +0, and bit b is set with a shift in registers;
//   * a table's codes and tie-breaks are written as coalesced rows of the
//     [T, n] outputs.
// The summation order is that of the thread-per-(point, table) kernel it
// replaced, whatever the grid, so codes and tie-breaks are bitwise equal to
// that kernel's.  The plain version sums in another order, so a projection
// within rounding of 0 may take the other sign there; the checks compare
// codes exactly only where every |proj| exceeds a stated margin.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTablesABlock = 8;  // tables a block takes; blockIdx.y picks the group
constexpr int kSmallThreads = 32;  // a block of a small batch: one warp, one table
constexpr int kMaxUnrolledD = 16;
constexpr int kChunkBytes = 48 * 1024;  // planes staged a pass, above one table

// The projections of one point onto four consecutive plane columns.
template <int D>
__device__ __forceinline__ float4 project4(const float* xr, const float* __restrict__ xi,
                                           const float4* pt, int d, int groups, int g) {
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  const int dd = D > 0 ? D : d;
#pragma unroll
  for (int j = 0; j < dd; ++j) {
    const float xj = D > 0 ? xr[j] : __ldg(xi + j);
    const float4 w = pt[j * groups + g];
    p.x = fmaf(xj, w.x, p.x);
    p.y = fmaf(xj, w.y, p.y);
    p.z = fmaf(xj, w.z, p.z);
    p.w = fmaf(xj, w.w, p.w);
  }
  return p;
}

// TB tables and NT threads a block
template <int D, int TB, int NT>
__global__ void __launch_bounds__(NT)
hash_codes_kernel(const float* __restrict__ x, const float* __restrict__ planes, int n,
                  int d, int n_tables, int n_bits, int chunk, int* __restrict__ codes,
                  float* __restrict__ tie) {
  extern __shared__ float4 staged[];  // [chunk][d][groups] float4
  float* sp = reinterpret_cast<float*>(staged);
  const int cols = n_bits + 1;
  const int groups = (cols + 3) / 4;
  const int stride = 4 * groups;
  const int full = n_bits / 4;  // column groups that hold four sign bits
  const int rest = n_bits % 4;  // sign bits in group `full`, then the tie column
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < n;
  const float* xi = x + (long long)(live ? i : 0) * d;
  float xr[D > 0 ? D : 1];
#pragma unroll
  for (int j = 0; j < (D > 0 ? D : 0); ++j) xr[j] = live ? __ldg(xi + j) : 0.f;

  const int t_end = min(n_tables, (int)(blockIdx.y + 1) * TB);
  for (int t0 = blockIdx.y * TB; t0 < t_end; t0 += chunk) {
    const int tc = min(chunk, t_end - t0);
    __syncthreads();  // the previous chunk's readers are done
    const float* src = planes + (long long)t0 * d * cols;
    for (int e = threadIdx.x; e < tc * d * stride; e += NT) {
      const int row = e / stride, b = e - row * stride;  // row = table·d + j
      sp[e] = b < cols ? __ldg(src + (long long)row * cols + b) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int tl = 0; tl < tc; ++tl) {
      const float4* pt = staged + tl * d * groups;
      int code = 0;
      for (int g = 0; g < full; ++g) {
        const float4 p = project4<D>(xr, xi, pt, d, groups, g);
        const int b = 4 * g;
        code |= (p.x >= 0.f ? 1 : 0) << b;
        code |= (p.y >= 0.f ? 1 : 0) << (b + 1);
        code |= (p.z >= 0.f ? 1 : 0) << (b + 2);
        code |= (p.w >= 0.f ? 1 : 0) << (b + 3);
      }
      const float4 p = project4<D>(xr, xi, pt, d, groups, full);
      const int b = 4 * full;
      if (rest > 0) code |= (p.x >= 0.f ? 1 : 0) << b;
      if (rest > 1) code |= (p.y >= 0.f ? 1 : 0) << (b + 1);
      if (rest > 2) code |= (p.z >= 0.f ? 1 : 0) << (b + 2);
      const float t = rest == 0 ? p.x : rest == 1 ? p.y : rest == 2 ? p.z : p.w;
      const long long out = (long long)(t0 + tl) * n + i;
      codes[out] = code;
      tie[out] = t;
    }
  }
}

template <int D, int TB, int NT>
int launch_grid(const float* x, const float* planes, int n, int d, int n_tables, int n_bits,
                int* codes, float* tie, cudaStream_t st) {
  const int table_bytes = d * 4 * ((n_bits + 4) / 4) * (int)sizeof(float);
  const int group = n_tables < TB ? n_tables : TB;
  int chunk = table_bytes > 0 ? kChunkBytes / table_bytes : group;
  chunk = chunk < 1 ? 1 : chunk > group ? group : chunk;
  const int smem = chunk * table_bytes;
  if (smem > kChunkBytes &&
      cudaFuncSetAttribute(hash_codes_kernel<D, TB, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + NT - 1) / NT), (unsigned)((n_tables + TB - 1) / TB));
  hash_codes_kernel<D, TB, NT><<<grid, NT, smem, st>>>(x, planes, n, d, n_tables, n_bits,
                                                       chunk, codes, tie);
  return (int)cudaGetLastError();
}

// kTablesABlock tables and kThreads threads a block, or, where that grid
// has fewer blocks than the card has SMs, a table and a warp a block
template <int D>
int launch(const float* x, const float* planes, int n, int d, int n_tables, int n_bits,
           int* codes, float* tie, cudaStream_t st) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long blocks = (long long)((n + kThreads - 1) / kThreads) *
                           ((n_tables + kTablesABlock - 1) / kTablesABlock);
  if (blocks >= sms)
    return launch_grid<D, kTablesABlock, kThreads>(x, planes, n, d, n_tables, n_bits, codes,
                                                   tie, st);
  return launch_grid<D, 1, kSmallThreads>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
}

}  // namespace

// x [n, d] fp32, planes [T, d, n_bits + 1] fp32 (row-major), 1 ≤ n_bits ≤ 24,
// one table's padded planes (d · 4⌈(n_bits + 1)/4⌉ floats) at most 227 KB;
// codes [T, n] int32, tie [T, n] fp32.
extern "C" int hash_codes_f32(const float* x, const float* planes, int n, int d,
                              int n_tables, int n_bits, int* codes, float* tie,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  switch (d) {
    case 1: return launch<1>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 2: return launch<2>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 3: return launch<3>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 4: return launch<4>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 5: return launch<5>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 6: return launch<6>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 7: return launch<7>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 8: return launch<8>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 9: return launch<9>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 10: return launch<10>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 11: return launch<11>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 12: return launch<12>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 13: return launch<13>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 14: return launch<14>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case 15: return launch<15>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    case kMaxUnrolledD: return launch<16>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
    default: return launch<0>(x, planes, n, d, n_tables, n_bits, codes, tie, st);
  }
}
