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
// and y [R, b] written — about 50 MB and 15 µs at n = 142,541, W ≈ 40, b = 4,
// of which the slot stream is 45.6 MB.  The TPU kernel kept all of x
// resident in VMEM and gathered from it with the vector unit, streaming
// [rows, W] tiles of slots with perfect stride.  On the card x (2.3 MB at
// b = 4) stays in the 50 MB L2 by itself, so the design is about the slot
// stream and the gathers.  b must be a multiple of 4 (the wrapper pads
// other blocks with zero columns): every gather is one 16-byte float4 of
// x[col, 4g:4g+4], one load for four columns.  Two mappings:
//   * the streamed slot pass (ell_spmm_stream, b <= 8): a block owns a run
//     of whole rows, a multiple of 4 (so its run of slots starts 16-byte
//     aligned for any W), sized to about 2048 slots, and reads that run as
//     one flat, coalesced stream of int4 / float4 with the streaming hint
//     (ld.global.cs: the slots are read once), as ell_spmv.cu does at b = 1.
//     Each thread loads all of its slots first, then issues all of their
//     gathers of one column group before it multiplies (8 float4 in flight a
//     thread).  The products go to shared memory — where W % 4 == 0, as the
//     BlockELL layout makes it, each thread's 4 slots lie in one row and go
//     as their sum — and 8 lanes sum each (row, column group) there.
//   * the row-band × column-slab pass (ell_spmm_band, wider b, and the
//     Chebyshev step below): a block of 1024 threads owns a band of 128
//     consecutive rows, stages their slots in shared memory with cp.async,
//     and walks the column groups in slabs of 16 (64 columns), a lane a
//     (row, column group), 64 rows at a time, each lane summing over the
//     row's slots in slot order with fused multiply-adds.  The neighbours of
//     a band of consecutive voxels fall in a few narrow windows of ids, so
//     the band's rows gather the same neighbour rows within one slab, from
//     L1 after the first; a thread per (row, column group) gathered a 2 KB
//     row of x from L2 for every slot at b = 508.  One block an SM
//     (registers for 64 a thread) leaves L1 the most room for that reuse.
// The C entry takes the streamed pass for b <= kStreamMaxB and the band
// pass above it (and for rows too wide for the streamed pass's shared
// memory).  The plain version reduces in another order, hence a stated
// tolerance rather than bit equality.  Padding slots (col 0, val 0) add 0.
// Times (tools/ell_spmm_variants.py, tools/ell_spmm_cheb_variants.py) are
// in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;   // 16-byte chunks of slots a thread loads per pass
constexpr int kLanes = 8;    // lanes per (row, column group) in the row sums
constexpr int kTargetSlots = kThreads * 4 * kChunks;  // 2048 slots a block
constexpr int kStreamMaxB = 8;            // widest b the streamed pass takes
constexpr int kStreamSmem = 96 * 1024;    // most shared memory its products take
// the band pass's shape: rows a band, lanes a row (a slab of that many
// column groups), threads a block, blocks an SM its registers must allow,
// and slots a lane unrolls
constexpr int kBandRows = 128, kBandLanes = 16, kBandThreads = 1024, kBandBlocks = 1,
              kSlotUnroll = 8;
constexpr int kStageSmem = 64 * 1024;     // most shared memory a band's staged slots take

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// The streamed slot pass.  kWhole: W % 4 == 0, so a thread's 4 slots lie in
// one row and part holds their sum, [rows_pb·W/4][groups]; else part holds
// every slot's product, [rows_pb·W][groups].
template <bool kWhole>
__global__ void __launch_bounds__(kThreads)
ell_spmm_stream(const float4* __restrict__ x, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows, int w, int groups, int rows_pb,
                float4* __restrict__ y) {
  extern __shared__ __align__(16) float4 part[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows_pb;
  const int rows = min(rows_pb, n_rows - row0);
  const int len = rows * w;
  const long long s0 = (long long)row0 * w;  // a multiple of 4
  const int4* c4 = reinterpret_cast<const int4*>(cols + s0);
  const float4* v4 = reinterpret_cast<const float4*>(vals + s0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
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
        vi[j] = zero;
      }
    }
    for (int g = 0; g < groups; ++g) {
      float4 xv[kChunks][4];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const bool ok = base + j * kThreads + tid < full;
        xv[j][0] = ok ? __ldg(x + (long long)ci[j].x * groups + g) : zero;
        xv[j][1] = ok ? __ldg(x + (long long)ci[j].y * groups + g) : zero;
        xv[j][2] = ok ? __ldg(x + (long long)ci[j].z * groups + g) : zero;
        xv[j][3] = ok ? __ldg(x + (long long)ci[j].w * groups + g) : zero;
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int q = base + j * kThreads + tid;
        if (q >= full) continue;
        if constexpr (kWhole) {
          part[q * groups + g] = axpy4(vi[j].w, xv[j][3],
                                       axpy4(vi[j].z, xv[j][2],
                                             axpy4(vi[j].y, xv[j][1],
                                                   axpy4(vi[j].x, xv[j][0], zero))));
        } else {
          part[(4 * q) * groups + g] = axpy4(vi[j].x, xv[j][0], zero);
          part[(4 * q + 1) * groups + g] = axpy4(vi[j].y, xv[j][1], zero);
          part[(4 * q + 2) * groups + g] = axpy4(vi[j].z, xv[j][2], zero);
          part[(4 * q + 3) * groups + g] = axpy4(vi[j].w, xv[j][3], zero);
        }
      }
    }
  }
  if constexpr (!kWhole) {  // the last 1-3 slots of a ragged run
    for (int e = tid; e < (len - 4 * full) * groups; e += kThreads) {
      const int s = 4 * full + e / groups, g = e % groups;
      part[s * groups + g] =
          axpy4(vals[s0 + s], __ldg(x + (long long)cols[s0 + s] * groups + g), zero);
    }
  }
  __syncthreads();

  // 8 lanes an item (row, column group), 32 items a pass; the 8 lanes of an
  // item are one aligned eighth of the warp, so xor 4..1 stays in it
  const int per_row = kWhole ? w / 4 : w;
  const int lane = tid % kLanes;
  const int items = rows * groups;
  for (int ib = 0; ib < items; ib += kThreads / kLanes) {
    const int item = ib + tid / kLanes;
    float4 acc = zero;
    if (item < items) {
      const int r = item / groups, g = item % groups;
      for (int s = lane; s < per_row; s += kLanes) {
        const float4 p = part[(r * per_row + s) * groups + g];
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    if (item < items && lane == 0) y[(long long)row0 * groups + item] = acc;
  }
}

// Rows a block of the streamed pass takes: a multiple of 4 near
// kTargetSlots slots whose partials fit in kStreamSmem; 0 if 4 rows do not.
int stream_rows(int w, int groups) {
  const long long row_bytes = (long long)(w % 4 == 0 ? w / 4 : w) * groups * 16;
  const int target = w >= kTargetSlots / 4 ? 4 : kTargetSlots / w / 4 * 4;
  const long long fit = kStreamSmem / row_bytes / 4 * 4;
  return (int)(fit < target ? fit : target);
}

template <bool kWhole>
cudaError_t launch_stream(const float* x, const int* cols, const float* vals, int n_rows,
                          int w, int groups, int rows_pb, float* y, cudaStream_t st) {
  const int smem = (int)((long long)rows_pb * (kWhole ? w / 4 : w) * groups * 16);
  const cudaError_t err = cudaFuncSetAttribute(
      ell_spmm_stream<kWhole>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_rows + rows_pb - 1) / rows_pb));
  ell_spmm_stream<kWhole><<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const float4*>(x), cols, vals, n_rows, w, groups, rows_pb,
      reinterpret_cast<float4*>(y));
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage a band's run of slots, [rows·W] column ids then [rows·W] values, into
// shared memory with cp.async: 16-byte copies where W % 4 == 0 and the run
// starts 16-byte aligned (the BlockELL layout), else 4-byte ones.
__device__ __forceinline__ void stage_slots(const int* cols, const float* vals, int len,
                                            int w, int* sc, float* sv) {
  const bool wide = w % 4 == 0 && reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (wide) {
    for (int q = threadIdx.x; q < len / 4; q += kBandThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(sc + 4 * q)),
                   "l"(cols + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(sv + 4 * q)),
                   "l"(vals + 4 * q));
    }
  } else {
    for (int e = threadIdx.x; e < len; e += kBandThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(sc + e)),
                   "l"(cols + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(sv + e)),
                   "l"(vals + e));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The row-band × column-slab pass, for the Chebyshev step (kCheb: the
// epilogue y = ca·acc + cb·x[r] − prev[r]) and for b above kStreamMaxB.
// A block owns a band of `band` consecutive rows (kStaged: its
// slots in shared memory; else read from device memory, for rows too wide
// to stage) and walks the column groups in slabs of `lanes`: a lane a
// (row, column group), summing it over the row's slots in slot order with
// fused multiply-adds.  A neighbour row that several rows of the band name
// is gathered from L2 once a slab and from L1 after that.
template <bool kCheb, bool kStaged>
__global__ void __launch_bounds__(kBandThreads, kBandBlocks)
ell_spmm_band(const float4* __restrict__ x, const int* __restrict__ cols,
              const float* __restrict__ vals, const float4* __restrict__ prev,
              const float* __restrict__ coef, int n_out, int w, int groups, int band,
              int lanes, float4* __restrict__ y) {
  extern __shared__ __align__(16) int slots[];
  const int row0 = blockIdx.x * band;
  const int rows = min(band, n_out - row0);
  const long long s0 = (long long)row0 * w;
  const int* sc = cols + s0;
  const float* sv = vals + s0;
  if constexpr (kStaged) {
    int* c_sh = slots;
    float* v_sh = reinterpret_cast<float*>(slots + band * w);
    stage_slots(sc, sv, rows * w, w, c_sh, v_sh);
    sc = c_sh;
    sv = v_sh;
  }
  float ca = 0.f, cb = 0.f;
  if constexpr (kCheb) {
    ca = coef[0];
    cb = coef[1];
  }
  const int lane = threadIdx.x % lanes;
  const int step = kBandThreads / lanes;  // rows at a time
  if ((int)threadIdx.x >= step * lanes) return;
  for (int g = lane; g - lane < groups; g += lanes) {  // one slab per pass
    if (g >= groups) continue;                          // the last slab's spare lanes
    for (int r = threadIdx.x / lanes; r < rows; r += step) {
      const int* cr = sc + r * w;
      const float* vr = sv + r * w;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll kSlotUnroll
      for (int s = 0; s < w; ++s)
        acc = axpy4(vr[s], __ldg(x + (long long)cr[s] * groups + g), acc);
      const long long t = (long long)(row0 + r) * groups + g;
      if constexpr (kCheb) {
        const float4 xr = __ldg(x + t), pr = __ldcs(prev + t);
        y[t] = make_float4(ca * acc.x + cb * xr.x - pr.x, ca * acc.y + cb * xr.y - pr.y,
                           ca * acc.z + cb * xr.z - pr.z, ca * acc.w + cb * xr.w - pr.w);
      } else {
        y[t] = acc;
      }
    }
  }
}

// Launch the band pass over the first n_out rows: lanes = min(kBandLanes,
// groups) lanes a row; the band is kBandRows rounded up to a whole number of
// row passes (so a small b still fills the block), its slots staged when
// they fit kStageSmem, else read from device memory (a mapping any W can
// take).
template <bool kCheb>
cudaError_t launch_band(const float* x, const int* cols, const float* vals, const float* prev,
                        const float* coef, int n_out, int w, int groups, float* y,
                        cudaStream_t st) {
  if (n_out <= 0 || groups <= 0) return cudaSuccess;
  const int lanes = min(kBandLanes, groups);
  const int step = kBandThreads / lanes;
  const int band = (kBandRows + step - 1) / step * step;
  const long long stage = (long long)band * w * 8;
  const dim3 grid((unsigned)((n_out + band - 1) / band));
  const auto* x4 = reinterpret_cast<const float4*>(x);
  const auto* p4 = reinterpret_cast<const float4*>(prev);
  auto* y4 = reinterpret_cast<float4*>(y);
  if (stage <= kStageSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_spmm_band<kCheb, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stage);
    if (err != cudaSuccess) return err;
    ell_spmm_band<kCheb, true><<<grid, kBandThreads, (size_t)stage, st>>>(
        x4, cols, vals, p4, coef, n_out, w, groups, band, lanes, y4);
  } else {
    ell_spmm_band<kCheb, false><<<grid, kBandThreads, 0, st>>>(
        x4, cols, vals, p4, coef, n_out, w, groups, band, lanes, y4);
  }
  return cudaGetLastError();
}

}  // namespace

// x [n, b], cols/vals [n_rows, w] row-major, y [n_rows, b]; all fp32 except
// cols (int32, every id in [0, n)).  b % 4 == 0; x, y, cols and vals 16-byte
// aligned.
extern "C" int ell_spmm_f32(const float* x, const int* cols, const float* vals,
                            int n, int n_rows, int w, int b, float* y, void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const int groups = b / 4;
  const int rows_pb = w > 0 ? stream_rows(w, groups) : 0;
  if (b <= kStreamMaxB && rows_pb >= 4) {
    if (reinterpret_cast<uintptr_t>(cols) % 16 || reinterpret_cast<uintptr_t>(vals) % 16)
      return (int)cudaErrorInvalidValue;
    return (int)(w % 4 == 0
                     ? launch_stream<true>(x, cols, vals, n_rows, w, groups, rows_pb, y, st)
                     : launch_stream<false>(x, cols, vals, n_rows, w, groups, rows_pb, y, st));
  }
  return (int)launch_band<false>(x, cols, vals, nullptr, nullptr, n_rows, w, groups, y, st);
}

// The fused Chebyshev step over the ELL body:
//   y[r, :] = ca·Σ_w vals[r, w]·x[cols[r, w], :] + cb·x[r, :] − prev[r, :]
// for the first n_out ≤ n rows only (rows ≥ n of the padded layout would
// see zero iterates and are never read, so they are not computed and x and
// prev need no padding).  Replaces ell_spmm_cheb_pallas / _cheb_kernel in
// src/repro/kernels/ell_spmm/kernel.py.  x [n, b], prev and y [n_out, b];
// coef = (ca, cb) in device memory; b % 4 == 0; x, prev, y 16-byte aligned.
//
// What bounds it: bytes, and where they come from.  At the Chebyshev
// filter's width (b = 508) the iterate x is 290 MB and no longer fits in the
// 50 MB L2.  Gathered a row at a time, each slot pulls a 2 KB row of x
// through L2 (about 5 GB a step on the DTI graph); in the band pass the rows
// of a band of consecutive voxels, which name neighbours in a few narrow
// windows of ids, share each neighbour row's slab in L1.  The epilogue saves
// the three elementwise passes (and their [n, b] temporaries) that an
// unfused step would stream through memory.
extern "C" int ell_spmm_cheb_f32(const float* x, const int* cols, const float* vals,
                                 const float* prev, const float* coef, int n,
                                 int n_out, int w, int b, float* y, void* stream) {
  (void)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  return (int)launch_band<true>(x, cols, vals, prev, coef, n_out, w, b / 4, y, st);
}
