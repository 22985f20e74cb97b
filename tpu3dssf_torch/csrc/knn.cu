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
// distance and one compare; bytes are a few MB per call. At the slice's
// 34,816 x 34,816 pairs per sample it is bound by operations (about 0.16 ms
// per sample and call at the card's 67 TFLOP/s f32 rate), never by memory.
//
// What the design does about it. The TPU kernel kept the whole ref set in
// VMEM (34,816 refs x 8 lanes x 4 B = 1.1 MB), far above a block's 227 KB
// of shared memory, so here each block streams the refs through shared
// memory in tiles of kTile (x, y, z, |r|^2) float4s; one thread owns one
// query and keeps its sorted top-k in registers; a candidate costs the
// distance and one compare against the current k-th distance, and only a
// rare win runs the insertion. There is no (Q, R) matrix anywhere.
//
// Semantics (those of the JAX package's `_tiled_topk_neighbors`, which the
// plain version `topk_neighbors_reference` repeats):
// * d = (|q|^2 - 2 (q.r)) + |r|^2 with q.r = (qx rx + qy ry) + qz rz and
//   |v|^2 = (x x + y y) + z z, every product and sum rounded in f32 in that
//   order: the __fmul_rn / __fadd_rn intrinsics keep nvcc from fusing any
//   multiply-add, so the kernel and the plain version are bit-identical;
// * refs are visited in increasing index and a candidate enters only if
//   strictly nearer than the current k-th, so ties go to the lower index
//   and the neighbours come in (distance, index) order;
// * the k slots start as (kBad, 0); a masked ref has distance >= kBad and
//   never enters, so a query with fewer than k valid refs keeps (kBad, 0)
//   in the slots left over. kBad is never squared (1e30^2 overflows f32);
// * query and ref tails are masked here: any Q and R.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // queries per block
constexpr int kTile = 1024;     // refs per shared-memory tile (16 KB)
constexpr float kBad = 1e30f;   // == voxelize.KNN_BAD_DIST

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
           const uint8_t* __restrict__ ref_mask, float* __restrict__ out_d,
           int* __restrict__ out_i, int Q, int R) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* q = queries + (static_cast<size_t>(b) * Q + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qn = sq_norm(qx, qy, qz);

  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = kBad;
    best_i[j] = 0;
  }

  const float* r_b = refs + static_cast<size_t>(b) * R * 3;
  const uint8_t* m_b = ref_mask + static_cast<size_t>(b) * R;
  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, kBad);  // masked ref
      if (m_b[base + t]) {
        const float* r = r_b + static_cast<size_t>(base + t) * 3;
        v = make_float4(r[0], r[1], r[2], sq_norm(r[0], r[1], r[2]));
      }
      tile[t] = v;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float4 v = tile[t];
      const float dot = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, v.x), __fmul_rn(qy, v.y)),
          __fmul_rn(qz, v.z));
      const float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, dot)), v.w);
      if (d < best_d[K - 1]) {
        // insert (d, id) after every kept entry with distance <= d: slot s
        // takes slot s-1's entry if that one is farther than d, else d if
        // its own entry is farther, else keeps its entry
        const int id = base + t;
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
    }
  }

  if (live) {
    const size_t o = (static_cast<size_t>(b) * Q + qi) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[o + j] = best_d[j];
      out_i[o + j] = best_i[j];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* r, const uint8_t* m,
                   float* od, int* oi, int B, int Q, int R,
                   cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(q, r, m, od, oi, Q, R);
  return cudaGetLastError();
}

}  // namespace

// queries (B, Q, 3) f32, refs (B, R, 3) f32, ref_mask (B, R) uint8, all
// contiguous on the device; writes out_d (B, Q, k) f32 and out_i (B, Q, k)
// int32. Returns the launch's cudaError_t (cudaErrorInvalidValue for a k
// outside 1..8 or an empty shape).
extern "C" int knn_f32(const void* queries, const void* refs,
                       const void* ref_mask, void* out_d, void* out_i, int B,
                       int Q, int R, int k, void* stream) {
  if (B < 1 || Q < 1 || R < 1 || B > 65535) return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  const float* r = static_cast<const float*>(refs);
  const uint8_t* m = static_cast<const uint8_t*>(ref_mask);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(q, r, m, od, oi, B, Q, R, s);
    case 2: return launch<2>(q, r, m, od, oi, B, Q, R, s);
    case 3: return launch<3>(q, r, m, od, oi, B, Q, R, s);
    case 4: return launch<4>(q, r, m, od, oi, B, Q, R, s);
    case 5: return launch<5>(q, r, m, od, oi, B, Q, R, s);
    case 6: return launch<6>(q, r, m, od, oi, B, Q, R, s);
    case 7: return launch<7>(q, r, m, od, oi, B, Q, R, s);
    case 8: return launch<8>(q, r, m, od, oi, B, Q, R, s);
    default: return cudaErrorInvalidValue;
  }
}
