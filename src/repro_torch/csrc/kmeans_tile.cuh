// The tensor-core (min, argmin) tile shared by the k-means assignment
// (kmeans_assign.cu) and the fused k-means iteration (kmeans_iter.cu): for
// the BM point rows of a block,
//   min_j (‖c_j‖² − 2 x_i·c_j)   and the lowest j attaining it.
//
// What bounds it on the H100: arithmetic.  The distance products are
// 2·n·k·d flops (7.1e10 at n = 142,541, k = d = 500); done at fp32 accuracy
// on the tensor cores they are three TF32 products, 3 × 7.1e10 flops over
// 495 TFLOP/s = 0.43 ms.  x is read once (285 MB, 0.085 ms at 3.35 TB/s).
//
// Design.  A block of 8 warps owns BM = 128 rows and sweeps the centroids
// in tiles of BN = 128, each warp a 64 × 32 tile of sums:
//   * Tensor cores at fp32 accuracy ("3xTF32"): each operand is split into
//     hi = tf32(a) and lo = tf32(a − hi) (round to nearest, ties away, as
//     cvt.rna does, but with an integer add and mask), and mma.sync
//     m16n8k8 accumulates lo·hi + hi·lo + hi·hi, small terms first.  The
//     dropped lo·lo term is ~2⁻²² relative.  Plain TF32 (≈ 3 digits) would
//     not do: labels are held to fp32 distances.  Both operands are split in
//     registers as the fragments are read from shared memory.
//   * Each 32-deep slice's products go to a fresh partial that is then added
//     to the running sum in fp32.  The tensor cores truncate as they
//     accumulate: fed straight into the growing sum, every product would
//     cost up to an ulp of the sum, an error that grows as d².  On an H100
//     80GB HBM3 at 700 W, at d = 500 on blobs, straight accumulation erred
//     5× as much as the SIMT fp32 kernel (69 % of chip_smoke.py's gate);
//     the partials err half as much as that kernel, for 11 % more time
//     (tools/kmeans_assign_variants.py).
//   * A 3-stage cp.async ring in dynamic shared memory (BK = 32 deep, 36 KB
//     a stage with rows padded to 36 floats so that fragment reads hit 32
//     distinct banks), one barrier per slice.  The ring runs straight on
//     across centroid tiles.  Rows are copied 16 bytes at a time where d % 4
//     == 0 and both operands are 16-byte aligned (VEC = 4), else 4 bytes at
//     a time (VEC = 1); ragged rows, centroids and depth are zero-filled, so
//     any n, k and d work without padding.  The sums and the slice's split
//     centroid fragments take the registers of one block per SM.
//   * The fold stays in registers: S = ‖c‖² − 2·acc per fragment element
//     folds into a running (min, argmin) per row and thread; at the end the
//     4 threads of a quad combine with shuffles and the 4 warps that share
//     rows through shared memory.  Ties go to the lowest index at every
//     step.  Identical centroids give identical sums wherever they sit
//     (every column sees the same k-loop order), so a centroid duplicated in
//     another tile still loses to the lower index.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace kmeans_tile {

constexpr int BM = 128;      // rows per block
constexpr int BN = 128;      // centroids per tile
constexpr int BK = 32;       // depth per ring slice
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kWarpsM = 2;   // warps along rows
constexpr int kWarpsN = 4;   // warps along centroids
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int WM = BM / kWarpsM;  // 64 rows per warp
constexpr int WN = BN / kWarpsN;  // 32 centroids per warp
constexpr int MT = WM / 16;       // m16 fragments per warp
constexpr int NT = WN / 8;        // n8 fragments per warp
constexpr int KS = BK / 8;        // k8 steps per slice
constexpr int LDS = BK + 4;       // padded shared row, floats
constexpr int kStageFloats = (BM + BN) * LDS;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 110,592

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo with hi, lo TF32: round to nearest, ties away from zero (what
// cvt.rna.tf32.f32 does) as an integer add and mask, which took 10 % off the
// kernel's time against cvt on an H100 80GB HBM3 at 700 W
// (tools/kmeans_assign_variants.py); a − hi is exact in fp32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float r = a - __uint_as_float(h);
  hi = h;
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (v, i) beats (bv, bi): smaller value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Copy rows [r0, r0 + R) × depth [k0, k0 + BK) of the row-major [rows, d]
// matrix a into the padded tile dst, zero-filling past rows and d.
template <int R, int VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ a, int rows,
                                          int d, int r0, int k0, int tid) {
  constexpr int kPerRow = BK / VEC;
#pragma unroll
  for (int i = 0; i < R * kPerRow / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int r = id / kPerRow, q = (id % kPerRow) * VEC;
    const int gr = r0 + r, gk = k0 + q;
    const bool ok = gr < rows && gk < d;
    const float* src = ok ? a + (long long)gr * d + gk : a;
    if constexpr (VEC == 4)
      cp_async16(dst + r * LDS + q, src, ok);
    else
      cp_async4(dst + r * LDS + q, src, ok);
  }
}

// The sweep of one block (256 threads, kSmemBytes of dynamic shared memory
// at smem) over every centroid for rows [row0, row0 + BM).  On return
// thread tid < BM holds in (v, id) the final (min, argmin) of row row0 + tid
// (rows past n included, on zero rows), the ring is drained, and smem is
// free once the block has passed a barrier.
template <int VEC>
__device__ __forceinline__ void argmin_rows(const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            const float* __restrict__ cn, int n, int k, int d,
                                            int row0, float* smem, float& v, int& id) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int n_tiles = (k + BN - 1) / BN;
  const int n_slices = (d + BK - 1) / BK;
  const int total = n_tiles * n_slices;

  auto issue = [&](int it) {  // copy slice it of the sweep into its ring slot
    const int k0 = (it % n_slices) * BK;
    float* st = smem + (it % kStages) * kStageFloats;
    load_tile<BM, VEC>(st, x, n, d, row0, k0, tid);
    load_tile<BN, VEC>(st + BM * LDS, c, k, d, (it / n_slices) * BN, k0, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  float acc[MT][NT][4];
  float best[MT][2];
  int bidx[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    best[i][0] = best[i][1] = CUDART_INF_F;
    bidx[i][0] = bidx[i][1] = 0;
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice it landed; every warp is done with slot it − 1
    if (it + kStages - 1 < total) issue(it + kStages - 1);
    cp_async_commit();

    const float* xs = smem + (it % kStages) * kStageFloats + (wm * WM) * LDS;
    const float* cs = smem + (it % kStages) * kStageFloats + (BM + wn * WN) * LDS;
    // the whole slice's fragments of the warp's centroids, split once
    uint32_t bh[KS][NT][2], bl[KS][NT][2];
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = cs + (j * 8 + g) * LDS + 8 * s + t;
        split_tf32(p[0], bh[s][j][0], bl[s][j][0]);
        split_tf32(p[4], bh[s][j][1], bl[s][j][1]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[KS][4], al[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float* p = xs + (i * 16 + g) * LDS + 8 * s + t;
        split_tf32(p[0], ah[s][0], al[s][0]);
        split_tf32(p[8 * LDS], ah[s][1], al[s][1]);
        split_tf32(p[4], ah[s][2], al[s][2]);
        split_tf32(p[8 * LDS + 4], ah[s][3], al[s][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // the slice's fresh partial
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          mma_tf32(part, al[s], bh[s][j]);
          mma_tf32(part, ah[s], bl[s][j]);
          mma_tf32(part, ah[s], bh[s][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
    }

    if ((it + 1) % n_slices == 0) {  // a centroid tile is complete: fold it
      const int tile = it / n_slices;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = tile * BN + wn * WN + j * 8 + 2 * t + e;
          if (col < k) {
            const float cnj = __ldg(cn + col);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float s = cnj - 2.f * acc[i][j][2 * h + e];
                if (better(s, col, best[i][h], bidx[i][h])) {
                  best[i][h] = s;
                  bidx[i][h] = col;
                }
              }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  // the 4 threads of a quad hold the same rows: xor 1, 2 stays in the quad
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[i][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i][h], off);
        if (better(ov, oi, best[i][h], bidx[i][h])) {
          best[i][h] = ov;
          bidx[i][h] = oi;
        }
      }

  // the kWarpsN warps that share rows, through the (drained) ring
  cp_async_wait<0>();
  __syncthreads();
  float* red_v = smem;                                  // [BM][kWarpsN]
  int* red_i = reinterpret_cast<int*>(smem + BM * kWarpsN);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * WM + i * 16 + h * 8 + g;
        red_v[r * kWarpsN + wn] = best[i][h];
        red_i[r * kWarpsN + wn] = bidx[i][h];
      }
  }
  __syncthreads();
  if (tid < BM) {
    v = red_v[tid * kWarpsN];
    id = red_i[tid * kWarpsN];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) {
      const float ov = red_v[tid * kWarpsN + w];
      const int oi = red_i[tid * kWarpsN + w];
      if (better(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
  }
}

// Set the dynamic shared memory of a kernel built on the tile, then launch
// it on one block of kThreads per BM rows.
template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int n, cudaStream_t st, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmemBytes, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace kmeans_tile
