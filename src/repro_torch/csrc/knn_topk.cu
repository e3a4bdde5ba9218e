// kNN top-k for Hopper (sm_90a): the Stage-1 neighbour search, and the
// out-of-sample search of the serving path.
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
// d subtracts and d multiply-adds a pair in order j = 0..d−1, exact on
// integer lattices (below), at twice that floor.  The TPU kernel formed the
// distance tile on the MXU as ‖c‖² − 2x·cᵀ and folded it into the running
// top-k with k min-extract passes over the tile.  On the card the data
// decide the design instead: d is tiny on the main path (3-D voxel
// positions, 16 on the serving path), so a GEMM formulation would run at a
// fraction of the tensor-core tile, and k min-extract passes per candidate
// would cost k times the distance work.  Here:
//   * one thread owns one query (several a thread, sharing each candidate
//     load, were tried and were slower); its coordinates sit in registers
//     for d <= 4, and for d <= 16 when k <= 16, and only the d real ones
//     are computed (the zero padding of the rows to a multiple of 4 is only
//     for the float4 loads); wider d is read through L1 (at the serving
//     pool's d = 16 that route takes 891 ms for the all-pairs search, the
//     registers 43);
//   * a block of 128 threads stages tiles of candidates in shared memory;
//     every thread reads the same candidate at the same time (float4
//     broadcasts, no bank conflicts) and forms Σ (q_j − c_j)² directly —
//     exact on integer lattices and free of the cancellation of the norm
//     expansion;
//   * the hot loop takes kGroup = 16 candidates a step: their distances,
//     then one branch for the group, so that the insertion code (rarely
//     run) lies outside it; there the group's candidates that enter are
//     inserted one at a time from a mask, so that a warp runs the insertion
//     as often as its busiest lane, not once for each candidate some lane
//     keeps (a fresh list, as each slice of a split sweep starts with,
//     keeps many).  The list holds 8, 12, 16, … slots, the fewest that hold
//     k: at k = 10 twelve slots fill and shift faster than sixteen;
//   * near-first sweep: a block starts at the tile that holds its own
//     queries' ids and then visits the others outward (−1, +1, −2, +2, …).
//     On a point set in raster order (the voxel lattice) the neighbours lie
//     in the first few tiles, so a query's top-k is final early and the
//     other tiles only compare;
//   * the running top-k is a sorted register array ordered by (key, id),
//     the key a distance's bits as an unsigned word (monotone for
//     distances >= 0, +inf above every finite one, every NaN one word
//     above +inf, empty slots above all): a candidate enters when (key, id)
//     < (bk[K−1], bi[K−1]) and the fully unrolled shift orders the same
//     way.  The result is the first k pairs in that order, whatever the
//     order of the visit.  The hot loop's filter stays one float compare,
//     !(d > worst), which lets a NaN through, and through everything while
//     the worst slot is empty, +inf or NaN.
// Split of the candidate axis.  A grid of one block per 128 queries fills
// the card only when there are many queries: the lattice's all-pairs
// search has 1,114 blocks, but a serving batch of 256 queries has 2 for
// 132 SMs, each thread sweeping all 160,000 pool rows alone.  So the grid
// is (query block, candidate slice): the binding picks S slices of whole
// tiles (kernels/knn_topk/kernel.py, choose_splits) so that the blocks
// fill the card, and S = 1 where the query blocks alone do.  Each block
// runs the sweep above over its slice only — near-first within the slice,
// the same register top-k, self-exclusion, NaN keys and empty slots — and
// writes its first k (key, id) pairs to scratch [S, k, nq] (the binding's
// torch.empty; [slot][query] so that both passes touch it coalesced).  A
// second kernel merges each query's S sorted lists, a warp a query: each
// lane folds its lists into a register top-k (a list is read only while
// its pairs still enter), then k rounds of a warp-wide minimum over the
// lanes' heads give the first k pairs, written as the sweep writes them.
// The order is total (ids are unique), so the first k pairs of the union
// of the slices' first k are the single sweep's, whatever S is: outputs
// are bitwise those of S = 1.  With S = 1 the sweep writes the output
// itself and no merge runs: the lattice's all-pairs search keeps S = 1,
// since its query blocks already fill the card several times over and a
// split would only add fresh lists to fill and a merge.
// Measured on an H100 80GB HBM3 at 700 W: PERF.md §6 (chip_smoke.py,
// tools/knn_topk_variants.py).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemFloats = 12288;  // 48 KB of candidate tile
constexpr int kTile = 1024;         // most candidates a tile holds
constexpr int kGroup = 16;          // candidates a hot-loop step compares
constexpr int kMergeChunk = 4;      // pairs of a list the merge loads at once
constexpr int kMaxRegD = 16;        // widest rows held in registers above d = 4 …
constexpr int kMaxRegK = 16;        // … for k up to this (the build stays short)
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

// A slot's key and id as the output writes them: an empty slot +inf, an
// empty or +inf slot id −1.
__device__ __forceinline__ void write_slot(unsigned key, int id, float* od, int* oi) {
  *od = key == kEmpty ? CUDART_INF_F : __uint_as_float(key);
  *oi = (key == kInfKey || key == kEmpty) ? -1 : id;
}

// D = 1..16: D real coordinates computed, rows of DP = 4⌈D/4⌉ floats
// (dp == DP), the query in registers; D = 0: any dp, the query read
// through L1.  gridDim.y = S slices of the candidate tiles; with S = 1 the
// block writes the output, else its first k pairs to part_k / part_i.
template <int KP, int D>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ xq, const float* __restrict__ xc,
                int nq, int nc, int dp, int tc, int k, long long query_offset,
                float* __restrict__ out_d, int* __restrict__ out_i,
                unsigned* __restrict__ part_k, int* __restrict__ part_i) {
  constexpr int DP = D > 0 ? (D + 3) / 4 * 4 : 4;
  extern __shared__ float4 smem4[];
  const float* tile = reinterpret_cast<const float*>(smem4);
  const int q0 = blockIdx.x * kThreads + threadIdx.x;
  // a spare thread of the last block repeats the last query and writes nothing
  const float* qrow = xq + (long long)min(q0, nq - 1) * dp;
  const long long self = query_offset + q0;

  float q[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) q[c] = (D > 0 && c < D) ? qrow[c] : 0.f;
  unsigned bk[KP];
  int bi[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    bk[s] = kEmpty;
    bi[s] = -1;
  }

  // this block's slice of tiles [lo, hi); near-first: the tile of the
  // block's first query id, clamped into the slice, then outward; j even
  // steps right, odd steps left, until every tile of the slice is seen
  const int nt = (nc + tc - 1) / tc;
  const int lo = (int)((long long)blockIdx.y * nt / gridDim.y);
  const int hi = (int)((long long)(blockIdx.y + 1) * nt / gridDim.y);
  const long long first = query_offset + (long long)blockIdx.x * kThreads;
  const int t0 = (int)min(max(first / tc, (long long)lo), (long long)hi - 1);
  for (int j = 0, seen = 0; seen < hi - lo; ++j) {
    const int t = (j & 1) ? t0 - (j + 1) / 2 : t0 + j / 2;
    if (t < lo || t >= hi) continue;
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
    constexpr int G = KP <= 16 ? kGroup : 1;  // one candidate a step above 16 slots
    for (int c = 0; c < cnt; c += G) {
      float dist[G];
      bool near = false;
      const float worst = __uint_as_float(bk[KP - 1]);  // NaN while empty
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float acc = 0.f;
        if (D > 0) {
          // e0·e0, then fmaf for j >= 1: bitwise fmaf(e0, e0, 0) and on
          const float4* cr = smem4 + (c + u) * (DP / 4);
#pragma unroll
          for (int c4 = 0; c4 < DP / 4; ++c4) {
            const float4 cv = cr[c4];
            const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int jd = 4 * c4 + l;
              if (jd < D) {
                const float e = q[jd] - cc[l];
                acc = jd == 0 ? e * e : fmaf(e, e, acc);
              }
            }
          }
        } else {
          const float* cr = tile + min(c + u, cnt - 1) * dp;
          for (int jd = 0; jd < dp; ++jd) {
            const float e = qrow[jd] - cr[jd];
            acc = fmaf(e, e, acc);
          }
        }
        dist[u] = acc;
        near |= !(acc > worst);
      }
      if (!near) continue;
      // the group's candidates that may enter, one at a time in order: the
      // warp runs the insertion as often as its busiest lane, not once for
      // every candidate that some lane keeps.  Ties at the k-th key go on to
      // the id order; the query itself is a candidate at +inf
      unsigned keep = 0, kds[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int cid = c0 + c + u;
        kds[u] = (long long)cid == self ? kInfKey : key_of(dist[u]);
        if (c + u < cnt && (kds[u] < bk[KP - 1] || (kds[u] == bk[KP - 1] && cid < bi[KP - 1])))
          keep |= 1u << u;
      }
      while (keep) {  // the list may have moved since the mask: test again
        const int u = __ffs(keep) - 1;
        keep &= keep - 1;
        unsigned kd = kds[0];
#pragma unroll
        for (int v = 1; v < G; ++v) kd = u == v ? kds[v] : kd;
        const int cid = c0 + c + u;
        if (kd < bk[KP - 1] || (kd == bk[KP - 1] && cid < bi[KP - 1])) insert(bk, bi, kd, cid);
      }
    }
  }
  if (q0 >= nq) return;
  if (gridDim.y == 1) {
#pragma unroll
    for (int s = 0; s < KP; ++s)
      if (s < k) write_slot(bk[s], bi[s], out_d + (long long)q0 * k + s,
                            out_i + (long long)q0 * k + s);
  } else {
#pragma unroll
    for (int s = 0; s < KP; ++s)
      if (s < k) {
        const long long at = ((long long)blockIdx.y * k + s) * nq + q0;
        part_k[at] = bk[s];
        part_i[at] = bi[s];
      }
  }
}

// The S sorted lists of k pairs of each query, [S, k, nq], merged into the
// first k pairs in (key, id) order; a warp a query.
template <int KP>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const unsigned* __restrict__ part_k, const int* __restrict__ part_i, int nq,
                 int k, int splits, float* __restrict__ out_d, int* __restrict__ out_i) {
  const int qi = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // the whole warp: one query a warp
  unsigned bk[KP];
  int bi[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    bk[s] = kEmpty;
    bi[s] = -1;
  }
  // each lane folds lists lane, lane + 32, …; a sorted list is read, a
  // chunk of pairs at a time, while its pairs still enter
  for (int sl = lane; sl < splits; sl += 32) {
    bool more = true;
    for (int r0 = 0; r0 < k && more; r0 += kMergeChunk) {
      unsigned ck[kMergeChunk];
      int ci[kMergeChunk];
#pragma unroll
      for (int r = 0; r < kMergeChunk; ++r) {
        const long long at = ((long long)sl * k + r0 + r) * nq + qi;
        ck[r] = r0 + r < k ? part_k[at] : kEmpty;
        ci[r] = r0 + r < k ? part_i[at] : -1;
      }
#pragma unroll
      for (int r = 0; r < kMergeChunk; ++r) {
        more = more && (ck[r] < bk[KP - 1] || (ck[r] == bk[KP - 1] && ci[r] < bi[KP - 1]));
        if (more) insert(bk, bi, ck[r], ci[r]);
      }
    }
  }
  // k rounds: the least head over the lanes (ids >= 0 but an empty slot's
  // −1, whose key is above every other, so (key, id) packs as one unsigned
  // word in the same order), written out and popped from its lane
  for (int r = 0; r < k; ++r) {
    const unsigned long long head = ((unsigned long long)bk[0] << 32) | (unsigned)bi[0];
    unsigned long long m = head;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
      m = other < m ? other : m;
    }
    const unsigned winners = __ballot_sync(0xffffffffu, head == m);
    if (lane == __ffs(winners) - 1) {
#pragma unroll
      for (int s = 0; s < KP - 1; ++s) {
        bk[s] = bk[s + 1];
        bi[s] = bi[s + 1];
      }
      bk[KP - 1] = kEmpty;
      bi[KP - 1] = -1;
    }
    if (lane == 0)
      write_slot((unsigned)(m >> 32), (int)(unsigned)m, out_d + (long long)qi * k + r,
                 out_i + (long long)qi * k + r);
  }
}

template <int KP, int D>
void launch_sweep(dim3 grid, size_t smem, cudaStream_t st, const float* xq, const float* xc,
                  int nq, int nc, int dp, int tc, int k, long long off, float* od, int* oi,
                  unsigned* pk, int* pi) {
  knn_topk_kernel<KP, D><<<grid, kThreads, smem, st>>>(xq, xc, nq, nc, dp, tc, k, off, od, oi,
                                                       pk, pi);
}

template <int KP>
cudaError_t launch_kp(const float* xq, const float* xc, int nq, int nc, int dp, int d,
                      int k, long long off, int splits, unsigned* pk, int* pi, float* od,
                      int* oi, cudaStream_t st) {
  const int tc = max(1, min(kTile, kSmemFloats / dp));
  const size_t smem = (size_t)tc * dp * sizeof(float);
  const dim3 grid((nq + kThreads - 1) / kThreads, splits);
  // rows in registers where dp is d padded to a multiple of 4; d <= 2
  // computes the zero padding too (it adds exactly 0)
  const int reg_d = dp > kMaxRegD || dp != (d + 3) / 4 * 4 ? 0 : dp == 4 && d != 3 ? 4 : d;
#define KNN_SWEEP(DD) \
  launch_sweep<KP, DD>(grid, smem, st, xq, xc, nq, nc, dp, tc, k, off, od, oi, pk, pi)
  if (reg_d == 3) {
    KNN_SWEEP(3);
  } else if (reg_d == 4) {
    KNN_SWEEP(4);
  } else if constexpr (KP <= kMaxRegK) {
    switch (reg_d) {
      case 5: KNN_SWEEP(5); break;
      case 6: KNN_SWEEP(6); break;
      case 7: KNN_SWEEP(7); break;
      case 8: KNN_SWEEP(8); break;
      case 9: KNN_SWEEP(9); break;
      case 10: KNN_SWEEP(10); break;
      case 11: KNN_SWEEP(11); break;
      case 12: KNN_SWEEP(12); break;
      case 13: KNN_SWEEP(13); break;
      case 14: KNN_SWEEP(14); break;
      case 15: KNN_SWEEP(15); break;
      case 16: KNN_SWEEP(16); break;
      default: KNN_SWEEP(0); break;  // wide rows, read through L1
    }
  } else {
    KNN_SWEEP(0);
  }
#undef KNN_SWEEP
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)(((long long)nq * 32 + kThreads - 1) / kThreads);
    knn_merge_kernel<KP><<<blocks, kThreads, 0, st>>>(pk, pi, nq, k, splits, od, oi);
  }
  return cudaGetLastError();
}

}  // namespace

// xq [nq, dp], xc [nc, dp] row-major fp32, 16-byte aligned (dp a multiple of
// 4, zero-padded from d real coordinates, 1 <= d <= dp); out_d [nq, k] fp32
// squared distances, out_i [nq, k] int32; 1 <= k <= 128; splits >= 1
// slices of the candidate tiles, and for splits > 1 scratch part_k, part_i
// of splits·k·nq words each (unused, may be null, for splits == 1).
extern "C" int knn_topk_f32(const float* xq, const float* xc, int nq, int nc, int dp, int d,
                            int k, long long query_offset, int splits, unsigned* part_k,
                            int* part_i, float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear a stale error so the return value is ours
#define KNN_KP(P) \
  launch_kp<P>(xq, xc, nq, nc, dp, d, k, query_offset, splits, part_k, part_i, out_d, out_i, st)
  if (k <= 8) return KNN_KP(8);
  if (k <= 12) return KNN_KP(12);
  if (k <= 16) return KNN_KP(16);
  if (k <= 32) return KNN_KP(32);
  if (k <= 64) return KNN_KP(64);
  return KNN_KP(128);
#undef KNN_KP
}
