// kNN top-k for Hopper (sm_90a): the Stage-1 neighbour search.
//
// Replaces the TPU kernel knn_topk_pallas / _kernel in
// src/repro/kernels/knn_topk/kernel.py.  For every query row: the k nearest
// candidate rows by squared Euclidean distance, self excluded (global query
// id = query_offset + row), ascending, ties to the lowest candidate id,
// unfilled slots (+inf, -1).
//
// What bounds it on the H100: arithmetic.  All pairs are visited, ~2·nq·nc·d
// fp32 operations (1.2e11 at n = 142,541, d = 3); the bytes (inputs read
// once, [nq, k] written once) are a few MB.  The TPU kernel formed the
// distance tile on the MXU as ‖c‖² − 2x·cᵀ and folded it into the running
// top-k with k min-extract passes over the tile.  On the card the data
// decide the design instead: d is tiny on the main path (3-D voxel
// positions), so a GEMM formulation would run at d/8 of the tensor-core
// tile, and k min-extract passes per candidate would cost k times the
// distance work.  Here:
//   * one thread owns one query; its coordinates sit in registers for d <= 4
//     (padded to 4 with zeros, which add exactly 0), or are read through L1
//     for wider d;
//   * a block of 128 queries stages tiles of candidates in shared memory;
//     every thread reads the same candidate at the same time (a broadcast,
//     no bank conflicts) and forms Σ (q_j − c_j)² directly — exact on
//     integer lattices and free of the cancellation of the norm expansion;
//   * the running top-k is a sorted register array; a candidate is compared
//     with the current k-th distance and, rarely, inserted by a fully
//     unrolled shift (k·ln(n/k) insertions per query on average), so the
//     sweep costs about one compare per pair beyond the distance.
// Candidates are visited in ascending id and an insertion goes after equal
// distances, so ties keep the lowest id, as the reference's contract says.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemFloats = 12288;  // 48 KB of candidate tile

template <int KP, int DQ>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ xq, const float* __restrict__ xc,
                int nq, int nc, int dp, int tc, int k, long long query_offset,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  const long long self = query_offset + qi;

  float q[DQ > 0 ? DQ : 4];
#pragma unroll
  for (int j = 0; j < (DQ > 0 ? DQ : 4); ++j)
    q[j] = (DQ > 0 && active) ? xq[(long long)qi * dp + j] : 0.f;
  const float* qrow = xq + (long long)(active ? qi : 0) * dp;

  float bd[KP];
  int bi[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }

  for (int c0 = 0; c0 < nc; c0 += tc) {
    const int cnt = min(tc, nc - c0);
    __syncthreads();  // previous tile fully consumed
    const float* src = xc + (long long)c0 * dp;
    for (int e = threadIdx.x; e < cnt * dp; e += kThreads) tile[e] = src[e];
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < cnt; ++c) {
      float acc = 0.f;
      if (DQ > 0) {
#pragma unroll
        for (int j4 = 0; j4 < (DQ > 0 ? DQ : 4) / 4; ++j4) {
          const float4 cv = smem4[c * (DQ / 4) + j4];
          float t;
          t = q[4 * j4 + 0] - cv.x; acc = fmaf(t, t, acc);
          t = q[4 * j4 + 1] - cv.y; acc = fmaf(t, t, acc);
          t = q[4 * j4 + 2] - cv.z; acc = fmaf(t, t, acc);
          t = q[4 * j4 + 3] - cv.w; acc = fmaf(t, t, acc);
        }
      } else {
        const float* cr = tile + c * dp;
        for (int j = 0; j < dp; ++j) {
          const float t = qrow[j] - cr[j];
          acc = fmaf(t, t, acc);
        }
      }
      const int cid = c0 + c;
      if (acc < bd[KP - 1] && (long long)cid != self) {
        // insert at p = #{s : bd[s] <= acc}; entries after p shift down one
#pragma unroll
        for (int s = KP - 1; s > 0; --s) {
          if (bd[s - 1] > acc) {
            bd[s] = bd[s - 1];
            bi[s] = bi[s - 1];
          } else if (bd[s] > acc) {
            bd[s] = acc;
            bi[s] = cid;
          }
        }
        if (bd[0] > acc) {
          bd[0] = acc;
          bi[0] = cid;
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    if (s < k) {
      out_d[(long long)qi * k + s] = bd[s];
      out_i[(long long)qi * k + s] = bi[s];
    }
  }
}

template <int KP>
cudaError_t launch_kp(const float* xq, const float* xc, int nq, int nc, int dp,
                      int k, long long off, float* od, int* oi, cudaStream_t st) {
  const int tc = max(1, min(1024, kSmemFloats / dp));
  const size_t smem = (size_t)tc * dp * sizeof(float);
  const dim3 grid((nq + kThreads - 1) / kThreads);
  if (dp == 4)
    knn_topk_kernel<KP, 4><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi);
  else
    knn_topk_kernel<KP, 0><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi);
  return cudaGetLastError();
}

}  // namespace

// xq [nq, dp], xc [nc, dp] row-major fp32 (dp a multiple of 4, zero-padded);
// out_d [nq, k] fp32 squared distances, out_i [nq, k] int32; 1 <= k <= 128.
extern "C" int knn_topk_f32(const float* xq, const float* xc, int nq, int nc,
                            int dp, int k, long long query_offset, float* out_d,
                            int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (k <= 8) return launch_kp<8>(xq, xc, nq, nc, dp, k, query_offset, out_d, out_i, st);
  if (k <= 16) return launch_kp<16>(xq, xc, nq, nc, dp, k, query_offset, out_d, out_i, st);
  if (k <= 32) return launch_kp<32>(xq, xc, nq, nc, dp, k, query_offset, out_d, out_i, st);
  if (k <= 64) return launch_kp<64>(xq, xc, nq, nc, dp, k, query_offset, out_d, out_i, st);
  return launch_kp<128>(xq, xc, nq, nc, dp, k, query_offset, out_d, out_i, st);
}
