// k nearest neighbours by squared L2 distance, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel K7, tpu3dssf/kernels/knn.py:40 (`_knn_kernel`,
// called by `knn_pallas`): for every query, the k <= 8 nearest valid refs,
// as (B, Q, k) f32 squared distances and (B, Q, k) int32 indices. It serves
// the two k-NN parity modes of tpu3dssf_torch/voxel/voxelize.py: the 5-NN
// intensity transfer (queries = voxel centroids, refs = points) and the
// nearest-centroid devoxelization (queries = points, refs = centroids, k=1).
//
// What bounds it. Every (query, ref) pair costs 8 f32 operations for the
// distance and one compare; bytes are a few MB per call. At the parity
// path's 34,816 x 34,816 pairs per sample it is bound by operations. Only
// one multiply and subtraction of them fuse into a multiply-add with the
// same bits (see Semantics), so a pair takes at least 8 instructions (7 for
// the distance, the compare), and the least time is set by instruction
// issue: one warp instruction per clock on each of the SM's 4 schedulers.
//
// What the design does about it, two or three kernels a call:
// * knn_pack_kernel writes every ref once as a float4 (x, y, z, |r|^2),
//   (0, 0, 0, kBad) for a masked ref, so no block reads the mask or
//   computes a norm again, and flags each run of 256 refs that holds a
//   coordinate too large for the folded arithmetic below;
// * knn_kernel<K, G>: a block of 128 threads owns a unit of 128 G queries,
//   G a thread, each with its sorted top-k in registers, so one
//   shared-memory read of a ref serves G pairs, and one branch covers the
//   compares of 2 refs (k = 1: one compare a group of 4 refs, on the least
//   of their distances). The block streams the packed refs through a ring
//   of kStages shared-memory stages with cp.async.bulk copies that complete
//   on mbarriers, issued kStages - 1 tiles ahead of the arithmetic;
// * even work: the (unit, ref tile) pairs of the whole call are cut into as
//   many equal runs as the card holds blocks at once (stream-K), so every
//   SM gets the same number of tiles to within one, whatever B, Q and R.
//   A run that crosses units gives each of its segments its own top-k;
//   where a unit is cut into several segments, knn_merge_kernel merges
//   their lists. Each unit is cut at most a few times, so the queries
//   restart their top-k (whose first tiles insert often) rarely.
//
// Semantics (those of the JAX package's `_tiled_topk_neighbors`, which the
// plain version `topk_neighbors_reference` repeats):
// * d = (|q|^2 - 2 (q.r)) + |r|^2 with q.r = (qx rx + qy ry) + qz rz and
//   |v|^2 = (x x + y y) + z z, every product and sum rounded in f32 in that
//   order: the __fmul_rn / __fadd_rn intrinsics keep nvcc from fusing any
//   multiply-add, so the kernel and the plain version are bit-identical.
//   One exception, which gives the same bits: fl(qn - fl(2 dot)) is
//   computed as fma(-2, dot, qn). Doubling is exact in f32 (subnormals
//   included) unless it overflows, so fl(2 dot) = 2 dot and both round the
//   same exact qn - 2 dot once. It overflows only for |dot| >= 2^127, which
//   needs a coordinate above 2^62; a block whose queries or ref slice hold
//   one (or a NaN) runs the literal sequence instead (kFold = false);
// * within a segment refs are visited in increasing index and a candidate
//   enters only if strictly nearer than the current k-th, so ties go to the
//   lower index and the neighbours come in (distance, index) order. A
//   segment's top-k holds every ref of the whole top-k that lies in it, and
//   the merge inserts the segments' lists in ref order by the same rule, so
//   the split gives exactly the result of one scan. At k = 1 the least
//   distance of a group of refs enters only if strictly below the best, so
//   the group kept is the first to hold the least distance, and its first
//   ref at that distance is the plain version's argmin;
// * the k slots start as (kBad, 0); a masked ref has distance >= kBad and
//   never enters, so a query with fewer than k valid refs keeps (kBad, 0)
//   in the slots left over. kBad is never squared (1e30^2 overflows f32);
// * query and ref tails are masked here: any Q and R.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;      // threads of a main-kernel block
constexpr int kTile = 512;         // refs per ring stage (8 KB)
constexpr int kStages = 3;         // ring stages
constexpr int kPackThreads = 256;  // refs per pack block and flag
constexpr int kMergeThreads = 256;
constexpr float kBad = 1e30f;      // == voxelize.KNN_BAD_DIST
// fma(-2, dot, qn) equals fl(qn - fl(2 dot)) while |coordinates| <= 2^62
constexpr float kFoldMax = 4.611686018427388e18f;

// queries a thread holds (G), each with 2 k + 4 registers of state; refs
// a step takes (U) before one branch (k > 1) or one group compare (k = 1)
__host__ __device__ constexpr int queries_per_thread(int k) {
  return k == 1 ? 8 : 4;
}
__host__ __device__ constexpr int refs_per_step(int k) {
  return k == 1 ? 4 : 2;
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ bool foldable(float x, float y, float z) {
  return fabsf(x) <= kFoldMax && fabsf(y) <= kFoldMax &&
         fabsf(z) <= kFoldMax;
}

// the squared distance of the plain version, bit for bit (see Semantics)
template <bool kFold>
__device__ __forceinline__ float dist(float qx, float qy, float qz, float qn,
                                      float4 v) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, v.x), __fmul_rn(qy, v.y)),
                              __fmul_rn(qz, v.z));
  const float e = kFold ? __fmaf_rn(-2.f, dot, qn)
                        : __fsub_rn(qn, __fmul_rn(2.f, dot));
  return __fadd_rn(e, v.w);
}

// insert (d, id) after every kept entry with distance <= d (the caller has
// checked d < best_d[K-1]): slot s takes slot s-1's entry if that one is
// farther than d, else d if its own entry is farther, else keeps its entry
template <int K>
__device__ __forceinline__ void insert(float (&best_d)[K], int (&best_i)[K],
                                       float d, int id) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool prev_after = best_d[s - 1] > d;
    const bool self_after = best_d[s] > d;
    best_i[s] = prev_after ? best_i[s - 1] : (self_after ? id : best_i[s]);
    best_d[s] = prev_after ? best_d[s - 1] : (self_after ? d : best_d[s]);
  }
  if (best_d[0] > d) {
    best_d[0] = d;
    best_i[0] = id;
  }
}

// one cp.async.bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm90::smem_u32(bar)) : "memory");
}

__global__ void __launch_bounds__(kPackThreads)
knn_pack_kernel(const float* __restrict__ refs,
                const uint8_t* __restrict__ ref_mask,
                float4* __restrict__ packed, uint8_t* __restrict__ unfoldable,
                int R) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * kPackThreads + threadIdx.x;
  bool big = false;
  if (r < R) {
    const size_t i = static_cast<size_t>(b) * R + r;
    float4 v = make_float4(0.f, 0.f, 0.f, kBad);  // masked ref
    if (ref_mask[i]) {
      const float x = refs[3 * i], y = refs[3 * i + 1], z = refs[3 * i + 2];
      v = make_float4(x, y, z, sq_norm(x, y, z));
      big = !foldable(x, y, z);
    }
    packed[i] = v;
  }
  big = __syncthreads_or(big);
  if (threadIdx.x == 0) unfoldable[b * gridDim.x + blockIdx.x] = big;
}

// The work of a call: units (a sample's block of 128 G queries) times
// tiles (kTile refs), numbered unit-major, tau = unit * tiles + tile. Block
// p of P takes tau in [floor(p T / P), floor((p + 1) T / P)), T = units *
// tiles: the same number of tiles to within one, whatever the shape. Where
// its range crosses a unit, each part is a segment with its own top-k.
struct Work {
  int B, Q, R, nqb, tiles, blocks, maxseg;
  long long total;  // T
  __host__ __device__ long long start(long long p) const {
    return p * total / blocks;
  }
  // the block whose range holds tile tau
  __host__ __device__ int block_of(long long tau) const {
    return static_cast<int>(((tau + 1) * blocks + total - 1) / total - 1);
  }
};

// U refs of a full tile against the thread's G queries. k > 1: U * G
// distances, one branch for all their compares (against thresholds that
// can only have fallen since, so no entrant is missed), and inside it the
// inserts in ref order. k = 1: the least of the U distances of each query,
// and where it is below the best so far, that and the group's first ref
// (the ref itself is found at the end of the segment, by `resolve`).
template <int K, int G, int U, bool kFold>
__device__ __forceinline__ void step(const float4* tile, int id,
                                     const float (&qx)[G],
                                     const float (&qy)[G],
                                     const float (&qz)[G],
                                     const float (&qn)[G],
                                     float (&best_d)[G][K],
                                     int (&best_i)[G][K]) {
  float d[U][G];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 v = tile[u];
#pragma unroll
    for (int g = 0; g < G; ++g)
      d[u][g] = dist<kFold>(qx[g], qy[g], qz[g], qn[g], v);
  }
  if (K == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m = d[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) m = fminf(m, d[u][g]);
      if (m < best_d[g][0]) {
        best_d[g][0] = m;
        best_i[g][0] = id;
      }
    }
  } else {
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) any |= d[u][g] < best_d[g][K - 1];
    if (any) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (d[u][g] < best_d[g][K - 1])
            insert<K>(best_d[g], best_i[g], d[u][g], id + u);
    }
  }
}

// k = 1: the first ref of the group best_i that has the least distance
// (none where the distance is still kBad: index 0). Distances are never
// -0 (|r|^2 >= +0 and x + +0 = +0 for x = -0), so fminf and < agree on
// them, and the group found is the one of the first least distance.
template <int G, int U, bool kFold>
__device__ __forceinline__ void resolve(const float4* refs, int R,
                                        const float (&qx)[G],
                                        const float (&qy)[G],
                                        const float (&qz)[G],
                                        const float (&qn)[G],
                                        float (&best_d)[G][1],
                                        int (&best_i)[G][1]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int first = best_i[g][0];
    int found = 0;
    if (best_d[g][0] < kBad) {
      found = first;
      for (int u = U - 1; u >= 0; --u)
        if (first + u < R &&
            dist<kFold>(qx[g], qy[g], qz[g], qn[g], refs[first + u]) ==
                best_d[g][0])
          found = first + u;
    }
    best_i[g][0] = found;
  }
}

// grid (P blocks of the Work); writes each segment's top-k of its queries
// to out (B, Q, K) where every unit is one segment (maxseg = 1), else to
// the partial lists (units, maxseg, 128 G, K) that knn_merge_kernel reads
template <int K, int G>
__global__ void __launch_bounds__(kThreads, 4)
knn_kernel(const float4* __restrict__ packed,
           const uint8_t* __restrict__ unfoldable,
           const float* __restrict__ queries, float* __restrict__ out_d,
           int* __restrict__ out_i, Work w) {
  constexpr int U = refs_per_step(K);
  constexpr int kQB = kThreads * G;
  __shared__ __align__(128) float4 ring[kStages][kTile];
  __shared__ __align__(8) uint64_t full[kStages];
  const int p = blockIdx.x;
  const long long tau0 = w.start(p), tau1 = w.start(p + 1);
  const int nflags = (w.R + kPackThreads - 1) / kPackThreads;

  // tile tau's refs: the sample of its unit, from ref tile * kTile
  auto tile_src = [&](long long tau, uint32_t* bytes) {
    const int unit = static_cast<int>(tau / w.tiles);
    const int r0 = static_cast<int>(tau % w.tiles) * kTile;
    *bytes = min(kTile, w.R - r0) * sizeof(float4);
    return packed + static_cast<size_t>(unit / w.nqb) * w.R + r0;
  };
  auto issue = [&](long long tau) {
    const int st = static_cast<int>((tau - tau0) % kStages);
    uint32_t bytes;
    const float4* src = tile_src(tau, &bytes);
    sm90::mbar_arrive_expect_tx(&full[st], bytes);
    bulk_load(ring[st], src, bytes, &full[st]);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) sm90::mbar_init(&full[st], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (long long tau = tau0; tau < min(tau1, tau0 + kStages); ++tau)
      issue(tau);

  for (long long tau = tau0; tau < tau1;) {
    // one segment: tiles t0 .. t1 - 1 of one unit
    const int unit = static_cast<int>(tau / w.tiles);
    const int t0 = static_cast<int>(tau % w.tiles);
    const long long left = tau1 - tau;
    const int t1 = left < w.tiles - t0 ? t0 + static_cast<int>(left) : w.tiles;
    const int b = unit / w.nqb, qb = unit - b * w.nqb;
    const int q0 = qb * kQB + threadIdx.x;
    float qx[G], qy[G], qz[G], qn[G];
    bool big = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int qi = q0 + g * kThreads;
      qx[g] = qy[g] = qz[g] = 0.f;
      if (qi < w.Q) {
        const float* q = queries + (static_cast<size_t>(b) * w.Q + qi) * 3;
        qx[g] = q[0];
        qy[g] = q[1];
        qz[g] = q[2];
      }
      qn[g] = sq_norm(qx[g], qy[g], qz[g]);
      big |= !foldable(qx[g], qy[g], qz[g]);
    }
    const int r_end = min(w.R, t1 * kTile);
    for (int f = t0 * kTile / kPackThreads + threadIdx.x;
         f < (r_end + kPackThreads - 1) / kPackThreads; f += kThreads)
      big |= unfoldable[b * nflags + f] != 0;
    const bool literal = __syncthreads_or(big);

    float best_d[G][K];
    int best_i[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        best_d[g][j] = kBad;
        best_i[g][j] = 0;
      }

    for (int t = t0; t < t1; ++t, ++tau) {
      const int st = static_cast<int>((tau - tau0) % kStages);
      sm90::mbar_wait(&full[st], ((tau - tau0) / kStages) & 1);
      const int base = t * kTile;
      const int n = min(kTile, w.R - base);
      const float4* tile = ring[st];
      if (n == kTile) {
        if (literal) {
#pragma unroll 2
          for (int j = 0; j < kTile; j += U)
            step<K, G, U, false>(tile + j, base + j, qx, qy, qz, qn, best_d,
                                 best_i);
        } else {
#pragma unroll 2
          for (int j = 0; j < kTile; j += U)
            step<K, G, U, true>(tile + j, base + j, qx, qy, qz, qn, best_d,
                                 best_i);
        }
      } else {
        for (int j = 0; j < n; ++j) {
          if (literal)
            step<K, G, 1, false>(tile + j, base + j, qx, qy, qz, qn, best_d,
                                 best_i);
          else
            step<K, G, 1, true>(tile + j, base + j, qx, qy, qz, qn, best_d,
                                 best_i);
        }
      }
      __syncthreads();  // every thread is done with stage st
      if (threadIdx.x == 0 && tau + kStages < tau1) issue(tau + kStages);
    }

    if constexpr (K == 1) {
      const float4* refs = packed + static_cast<size_t>(b) * w.R;
      if (literal)
        resolve<G, U, false>(refs, w.R, qx, qy, qz, qn, best_d, best_i);
      else
        resolve<G, U, true>(refs, w.R, qx, qy, qz, qn, best_d, best_i);
    }
    const int seg = p - w.block_of(static_cast<long long>(unit) * w.tiles);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int qi = q0 + g * kThreads;
      if (qi < w.Q) {
        const size_t o =
            w.maxseg == 1
                ? (static_cast<size_t>(b) * w.Q + qi) * K
                : ((static_cast<size_t>(unit) * w.maxseg + seg) * kQB +
                   qi - qb * kQB) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          out_d[o + j] = best_d[g][j];
          out_i[o + j] = best_i[g][j];
        }
      }
    }
  }
}

// one thread a query: the segments of its unit, inserted in block order
// (which is ref order) by the scan's rule, into (B, Q, K)
template <int K, int G>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, Work w) {
  constexpr int kQB = kThreads * G;
  const int t = blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= w.B * w.Q) return;
  const int b = t / w.Q, qi = t - b * w.Q;
  const int qb = qi / kQB, unit = b * w.nqb + qb;
  const long long first = static_cast<long long>(unit) * w.tiles;
  const int nseg = w.block_of(first + w.tiles - 1) - w.block_of(first) + 1;
  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = kBad;
    best_i[j] = 0;
  }
  for (int s = 0; s < nseg; ++s) {
    const size_t o =
        ((static_cast<size_t>(unit) * w.maxseg + s) * kQB + qi - qb * kQB) *
        K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = part_d[o + j];
      if (d < best_d[K - 1]) insert<K>(best_d, best_i, d, part_i[o + j]);
    }
  }
  const size_t o = static_cast<size_t>(t) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d[o + j] = best_d[j];
    out_i[o + j] = best_i[j];
  }
}

// the blocks of the main kernel<K> the current device holds at once
template <int K>
cudaError_t resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_kernel<K, queries_per_thread(K)>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return cudaSuccess;
}

// the Work of a call cut into `blocks` runs (never more than there are
// tiles), with the most segments a unit is cut into
Work make_work(int B, int Q, int R, int k, int blocks) {
  Work w;
  w.B = B;
  w.Q = Q;
  w.R = R;
  w.nqb = (Q + kThreads * queries_per_thread(k) - 1) /
          (kThreads * queries_per_thread(k));
  w.tiles = (R + kTile - 1) / kTile;
  w.total = static_cast<long long>(B) * w.nqb * w.tiles;
  w.blocks = static_cast<int>(std::min<long long>(w.total, blocks));
  w.maxseg = 1;
  for (long long unit = 0; unit < static_cast<long long>(B) * w.nqb; ++unit)
    w.maxseg = std::max(w.maxseg,
                        w.block_of((unit + 1) * w.tiles - 1) -
                            w.block_of(unit * w.tiles) + 1);
  return w;
}

// entries of each partial list (f32 distances, int32 indices); 0 where
// every unit is one segment and no merge runs
long long partial_entries(const Work& w, int k) {
  return w.maxseg > 1 ? static_cast<long long>(w.B) * w.nqb * w.maxseg *
                            kThreads * queries_per_thread(k) * k
                      : 0;
}

// bytes of the pack kernel's flags: one a run of kPackThreads refs
long long flag_bytes(int B, int R) {
  return static_cast<long long>(B) * ((R + kPackThreads - 1) / kPackThreads);
}

template <int K>
cudaError_t launch(const float* q, const float4* packed,
                   const uint8_t* unfoldable, float* od, int* oi, float* pd,
                   int* pi, const Work& w, cudaStream_t stream) {
  constexpr int G = queries_per_thread(K);
  const bool merge = w.maxseg > 1;
  knn_kernel<K, G><<<w.blocks, kThreads, 0, stream>>>(
      packed, unfoldable, q, merge ? pd : od, merge ? pi : oi, w);
  if (merge) {
    const int blocks = (w.B * w.Q + kMergeThreads - 1) / kMergeThreads;
    knn_merge_kernel<K, G><<<blocks, kMergeThreads, 0, stream>>>(pd, pi, od,
                                                                 oi, w);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The split of a call on the current device, into plan[0..3]: the main
// kernel's blocks (as many as the device holds at once, at most the
// call's tiles), the most segments a unit is cut into (1: no merge
// kernel), the entries of each partial list (f32 distances and int32
// indices) and the bytes of the pack kernel's flags, the last two being
// the scratch the caller allocates for knn_f32. Returns the cudaError_t.
int knn_plan(int B, int Q, int R, int k, long long* out) {
  if (B < 1 || Q < 1 || R < 1 || B > 65535) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err;
  switch (k) {
    case 1: err = resident_blocks<1>(&blocks); break;
    case 2: err = resident_blocks<2>(&blocks); break;
    case 3: err = resident_blocks<3>(&blocks); break;
    case 4: err = resident_blocks<4>(&blocks); break;
    case 5: err = resident_blocks<5>(&blocks); break;
    case 6: err = resident_blocks<6>(&blocks); break;
    case 7: err = resident_blocks<7>(&blocks); break;
    case 8: err = resident_blocks<8>(&blocks); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const Work w = make_work(B, Q, R, k, blocks);
  out[0] = w.blocks;
  out[1] = w.maxseg;
  out[2] = partial_entries(w, k);
  out[3] = flag_bytes(B, R);
  return cudaSuccess;
}

// queries (B, Q, 3) f32, refs (B, R, 3) f32, ref_mask (B, R) uint8, all
// contiguous on the device; writes out_d (B, Q, k) f32 and out_i (B, Q, k)
// int32. `blocks` and `partial` are knn_plan's plan[0] and plan[2];
// scratch from the caller: packed (B, R) float4, unfoldable of plan[3]
// bytes, and part_d and part_i of `partial` entries each (unused where
// that is 0). Returns the launches' cudaError_t (cudaErrorInvalidValue for
// a k outside 1..8, an empty shape, or a `partial` that is not the plan's
// for these blocks).
int knn_f32(const void* queries, const void* refs, const void* ref_mask,
            void* out_d, void* out_i, void* packed, void* unfoldable,
            void* part_d, void* part_i, int B, int Q, int R, int k,
            int blocks, long long partial, void* stream) {
  if (B < 1 || Q < 1 || R < 1 || B > 65535 || k < 1 || k > 8 || blocks < 1)
    return cudaErrorInvalidValue;
  const Work w = make_work(B, Q, R, k, blocks);
  if (w.blocks != blocks || partial_entries(w, k) != partial)
    return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  float4* pk = static_cast<float4*>(packed);
  uint8_t* uf = static_cast<uint8_t*>(unfoldable);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_pack_kernel<<<dim3((R + kPackThreads - 1) / kPackThreads, B),
                    kPackThreads, 0, s>>>(
      static_cast<const float*>(refs), static_cast<const uint8_t*>(ref_mask),
      pk, uf, R);
  switch (k) {
    case 1: return launch<1>(q, pk, uf, od, oi, pd, pi, w, s);
    case 2: return launch<2>(q, pk, uf, od, oi, pd, pi, w, s);
    case 3: return launch<3>(q, pk, uf, od, oi, pd, pi, w, s);
    case 4: return launch<4>(q, pk, uf, od, oi, pd, pi, w, s);
    case 5: return launch<5>(q, pk, uf, od, oi, pd, pi, w, s);
    case 6: return launch<6>(q, pk, uf, od, oi, pd, pi, w, s);
    case 7: return launch<7>(q, pk, uf, od, oi, pd, pi, w, s);
    default: return launch<8>(q, pk, uf, od, oi, pd, pi, w, s);
  }
}

}  // extern "C"
