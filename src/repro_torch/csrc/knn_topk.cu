// kNN top-k for Hopper (sm_90a): the Stage-1 neighbour search.
//
// Replaces the TPU kernel knn_topk_pallas / _kernel in
// src/repro/kernels/knn_topk/kernel.py.  For every query row: the k nearest
// candidate rows by squared Euclidean distance, self excluded (global query
// id = query_offset + row), ascending, ties to the lowest candidate id,
// unfilled slots (+inf, -1).  The order is that of a stable sort of the
// distances, the plain version's: the query itself counts as a candidate at
// +inf, a NaN distance ranks after +inf and keeps its id, and a slot at
// +inf is written (+inf, -1).  So a query or candidate with a NaN coordinate
// gives the plain version's rows, NaN distances included.
//
// What bounds it on the H100: issue slots.  All pairs are visited.  The
// function needs d multiply-adds a pair (‖c‖² − 2q·c, with ‖c‖² in the
// padding lane and −2q formed once), so the floor is nq·nc·d lane
// operations over 132 SMs × 128 lanes a clock; the bytes (inputs read once,
// [nq, k] written once) are a few MB.  This kernel keeps the direct form,
// d subtracts and d multiply-adds a pair, exact on integer lattices
// (below), at twice that floor.  The TPU kernel formed the distance tile on the MXU as
// ‖c‖² − 2x·cᵀ and folded it into the running top-k with k min-extract
// passes over the tile.  On the card the data decide the design instead: d
// is tiny on the main path (3-D voxel positions), so a GEMM formulation
// would run at d/8 of the tensor-core tile, and k min-extract passes per
// candidate would cost k times the distance work.  Here:
//   * one thread owns one query (several a thread, sharing each candidate
//     load, were tried and were slower); its coordinates sit in registers
//     for d <= 4, and only the d real ones are computed (the zero padding
//     of the rows to 4 is only for the float4 loads); wider d is read
//     through L1;
//   * a block of 128 threads stages tiles of candidates in shared memory;
//     every thread reads the same candidate at the same time (a broadcast,
//     no bank conflicts) and forms Σ (q_j − c_j)² directly — exact on
//     integer lattices and free of the cancellation of the norm expansion;
//   * the hot loop takes kGroup candidates a step: their distances, then one
//     branch for the group, so that the insertion code (rarely run) lies
//     outside it;
//   * near-first sweep: a block starts at the tile that holds its own
//     queries' ids and then visits the others outward (−1, +1, −2, +2, …).
//     On a point set in raster order (the voxel lattice) the neighbours lie
//     in the first few tiles, so a query's top-k is final early and the
//     other tiles only compare; swept in ascending id, every slice of the
//     lattice was nearer than the one before and rebuilt the top-k, and the
//     warp ran each lane's insertion shift;
//   * the running top-k is a sorted register array ordered by (key, id),
//     the key a distance's bits as an unsigned word (monotone for
//     distances >= 0, +inf above every finite one, every NaN one word
//     above +inf, empty slots above all): the visit order no longer gives
//     the lowest-id tie rule, so a candidate enters when (key, id) <
//     (bk[K−1], bi[K−1]) and the fully unrolled shift orders the same way.
//     The result is the first k pairs in that order, whatever the order of
//     the visit.  The hot loop's filter stays one float compare, !(d >
//     worst), which lets a NaN through, and through everything while the
//     worst slot is empty, +inf or NaN.
// Measured on an H100 80GB HBM3 at 700 W (tools/knn_topk_variants.py,
// k = 16): 8.7 ms on the 142,541-voxel lattice against 27.5 for the
// ascending sweep it replaced (insertions a query 136 against 1,545), and
// 12.4 against 21.3 on as many random points in the same box.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemFloats = 12288;  // 48 KB of candidate tile
constexpr int kTile = 1024;         // most candidates a tile holds
constexpr int kGroup = 8;           // candidates a hot-loop step compares
constexpr unsigned kInfKey = 0x7f800000u;  // +inf's bits
constexpr unsigned kNanKey = 0x7fffffffu;  // every NaN distance
constexpr unsigned kEmpty = 0xffffffffu;   // a slot no candidate has taken

// a distance (>= 0, +inf or NaN) as a key in the order of a stable sort
__device__ __forceinline__ unsigned key_of(float d) {
  return d != d ? kNanKey : __float_as_uint(d);
}

// (k0, i0) after (k1, i1) in the order (key, id)
__device__ __forceinline__ bool after(unsigned k0, int i0, unsigned k1, int i1) {
  return k0 > k1 || (k0 == k1 && i0 > i1);
}

// Insert (kd, id) into the sorted (bk, bi): position s takes its left
// neighbour where that comes after (kd, id), else (kd, id) where the old
// entry does; one pass from the right, every index fixed at compile time.
template <int KP>
__device__ __forceinline__ void insert(unsigned (&bk)[KP], int (&bi)[KP], unsigned kd, int id) {
#pragma unroll
  for (int s = KP - 1; s > 0; --s) {
    if (after(bk[s - 1], bi[s - 1], kd, id)) {
      bk[s] = bk[s - 1];
      bi[s] = bi[s - 1];
    } else if (after(bk[s], bi[s], kd, id)) {
      bk[s] = kd;
      bi[s] = id;
    }
  }
  if (after(bk[0], bi[0], kd, id)) {
    bk[0] = kd;
    bi[0] = id;
  }
}

// D = 1..4: coordinates from one float4 a row (dp == 4), D of them computed;
// D = 0: any dp, the query read through L1.
template <int KP, int D>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ xq, const float* __restrict__ xc,
                int nq, int nc, int dp, int tc, int k, long long query_offset,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const float* tile = reinterpret_cast<const float*>(smem4);
  const int q0 = blockIdx.x * kThreads + threadIdx.x;
  // a spare thread of the last block repeats the last query and writes nothing
  const float* qrow = xq + (long long)min(q0, nq - 1) * dp;
  const long long self = query_offset + q0;

  float q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = (D > 0 && c < D) ? qrow[c] : 0.f;
  unsigned bk[KP];
  int bi[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    bk[s] = kEmpty;
    bi[s] = -1;
  }

  // near-first: the tile of the block's first query id, clamped, then
  // outward; j even steps right, odd steps left, until every tile is seen
  const int nt = (nc + tc - 1) / tc;
  const long long first = query_offset + (long long)blockIdx.x * kThreads;
  const int t0 = (int)min(max(first / tc, 0ll), (long long)nt - 1);
  for (int j = 0, seen = 0; seen < nt; ++j) {
    const int t = (j & 1) ? t0 - (j + 1) / 2 : t0 + j / 2;
    if (t < 0 || t >= nt) continue;
    ++seen;
    const int c0 = t * tc;
    const int cnt = min(tc, nc - c0);
    __syncthreads();  // previous tile fully consumed
    const float4* src = reinterpret_cast<const float4*>(xc + (long long)c0 * dp);
    for (int e = threadIdx.x; e < cnt * dp / 4; e += kThreads) smem4[e] = src[e];
    // a ragged tile's last group: candidates at +inf, which no query keeps
    for (int e = cnt * dp / 4 + threadIdx.x; e < tc * dp / 4 && e < (cnt + kGroup) * dp / 4;
         e += kThreads)
      smem4[e] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    __syncthreads();
    // G candidates at a time: their distances, then one branch for the
    // group, so that the hot loop stays short and the insertion code
    // (rarely run) lies outside it
    constexpr int G = KP <= 16 ? kGroup : 1;  // the shift's code is large above 16
    for (int c = 0; c < cnt; c += G) {
      float dist[G];
      bool near = false;
      const float worst = __uint_as_float(bk[KP - 1]);  // NaN while empty
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float acc;
        if (D > 0) {
          const float4 cv = smem4[c + u];
          const float e0 = q[0] - cv.x;
          acc = e0 * e0;
          if (D > 1) { const float e1 = q[1] - cv.y; acc = fmaf(e1, e1, acc); }
          if (D > 2) { const float e2 = q[2] - cv.z; acc = fmaf(e2, e2, acc); }
          if (D > 3) { const float e3 = q[3] - cv.w; acc = fmaf(e3, e3, acc); }
        } else {
          const float* cr = tile + min(c + u, cnt - 1) * dp;
          acc = 0.f;
          for (int jd = 0; jd < dp; ++jd) {
            const float e = qrow[jd] - cr[jd];
            acc = fmaf(e, e, acc);
          }
        }
        dist[u] = acc;
        near |= !(acc > worst);
      }
      if (!near) continue;
      // ties at the k-th key go on to the id order; the query itself is a
      // candidate at +inf
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int cid = c0 + c + u;
        const unsigned kd = (long long)cid == self ? kInfKey : key_of(dist[u]);
        if (c + u < cnt && (kd < bk[KP - 1] || (kd == bk[KP - 1] && cid < bi[KP - 1])))
          insert(bk, bi, kd, cid);
      }
    }
  }
  if (q0 >= nq) return;
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    if (s < k) {
      const bool none = bk[s] == kInfKey || bk[s] == kEmpty;
      out_d[(long long)q0 * k + s] = bk[s] == kEmpty ? CUDART_INF_F : __uint_as_float(bk[s]);
      out_i[(long long)q0 * k + s] = none ? -1 : bi[s];
    }
  }
}

template <int KP>
cudaError_t launch_kp(const float* xq, const float* xc, int nq, int nc, int dp, int d,
                      int k, long long off, float* od, int* oi, cudaStream_t st) {
  const int tc = max(1, min(kTile, kSmemFloats / dp));
  const size_t smem = (size_t)tc * dp * sizeof(float);
  const dim3 grid((nq + kThreads - 1) / kThreads);
  if (dp != 4)  // wide rows, read through L1
    knn_topk_kernel<KP, 0><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi);
  else if (d == 3)
    knn_topk_kernel<KP, 3><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi);
  else  // d <= 2 computes the zero padding too: it adds exactly 0
    knn_topk_kernel<KP, 4><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi);
  return cudaGetLastError();
}

}  // namespace

// xq [nq, dp], xc [nc, dp] row-major fp32, 16-byte aligned (dp a multiple of
// 4, zero-padded from d real coordinates, 1 <= d <= dp); out_d [nq, k] fp32
// squared distances, out_i [nq, k] int32; 1 <= k <= 128.
extern "C" int knn_topk_f32(const float* xq, const float* xc, int nq, int nc, int dp, int d,
                            int k, long long query_offset, float* out_d, int* out_i,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (k <= 8) return launch_kp<8>(xq, xc, nq, nc, dp, d, k, query_offset, out_d, out_i, st);
  if (k <= 16) return launch_kp<16>(xq, xc, nq, nc, dp, d, k, query_offset, out_d, out_i, st);
  if (k <= 32) return launch_kp<32>(xq, xc, nq, nc, dp, d, k, query_offset, out_d, out_i, st);
  if (k <= 64) return launch_kp<64>(xq, xc, nq, nc, dp, d, k, query_offset, out_d, out_i, st);
  return launch_kp<128>(xq, xc, nq, nc, dp, d, k, query_offset, out_d, out_i, st);
}
