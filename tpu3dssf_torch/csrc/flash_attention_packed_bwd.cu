// Strided flash attention backward for Hopper (sm_90a), bf16 in/out.
//
// Replaces three TPU kernels that compute the same gradient and differ in
// layout, Mosaic block rules and where their statistics come from:
//   * tpu3dssf/kernels/flash_attention.py::_packed_bwd_kernel with
//     use_stats=True (K3, the training backward of the PTv3 stages with
//     C % 128 == 0);
//   * tpu3dssf/kernels/window_attention.py::_attn_bwd_kernel (K5, the
//     (W, K, H, D) window backward);
//   * tpu3dssf/kernels/flash_attention.py::_flash_bwd_kernel (K9, the
//     (B, H, N, D) backward of the ViT's many-head route). The TPU kernel
//     rebuilds p from a full-row max and sum and takes rowsum(dp * p) itself;
//     here it is fed the forward's LSE and delta = rowsum(do * o) like K3 and
//     K5, which is the same gradient.
// For every (batch row b, head h), from lse (B, H, N) and delta (B, H, N),
// both f32 and computed outside:
//
//     q_s = bf16(q * bf16(q_scale))           (the forward's scaled q)
//     s   = q_s k^T + bias[b]                 p  = exp(s - lse)
//     dv  = p^T do                            dp = do v^T
//     ds  = p * (dp - delta)
//     dq  = (ds k) * q_scale                  dk = ds^T q_s
//
// q, k, v, do, dq, dk and dv are separate pointers, each with its own
// (batch, token, head) strides in elements and a head's D channels
// contiguous: the packed qkv (B, N, 3C) and its packed gradient are one
// stride set, (B, N, H, D) tensors another. As in the TPU kernels, p is
// rounded to bf16 for the dv product and ds for the dq and dk products; every
// product accumulates in f32.
//
// Two designs, chosen by the head dimension D at the C entry point.
//
// D = 16 (the PTv3 stages: K3, K5): two passes, no atomics, so the
// gradients are deterministic:
//   * fap_bwd_dkdv_kernel: one CTA of four warps per (64-key tile, head,
//     batch row); each warp owns 16 keys and keeps their K and V fragments
//     and the dk, dv accumulators in registers while the CTA walks all query
//     tiles of 64. It computes the transposed scores s^T = k q_s^T (keys as
//     rows), so the accumulator fragments of p^T and ds^T are directly the A
//     operands of dv = p^T do and dk = ds^T q_s, and neither ever touches
//     shared memory.
//   * fap_bwd_dq_kernel: one CTA per (64-query tile, head, batch row); each
//     warp owns 16 queries, keeps q_s, do, lse and delta of its rows in
//     registers and walks all key tiles, accumulating dq = ds k.
// Both run mma.sync m16n8k16 bf16 with f32 accumulation; operands read as
// B with the reduction along the tile's rows are stored transposed in
// shared memory. Every score costs one exp in each pass against 4 x 16
// multiply-adds a pass: the exp on the special-function units and latency
// bound it, not bytes.
//
// D = 64 (K9, the ViT-L route's gradient): one pass, fap_bwd_d64_kernel,
// then fap_bwd_d64_dq_kernel. A score costs 5 products of 128 flops (s, dp,
// dv, dk, dq) and one exp, so the tensor cores bound it (ViT-L, B = 12:
// products 1.01 ms, exps 0.37 ms), and two passes would take 7 products and
// two exps. The design:
//   * one CTA per (128-key tile, head, batch row) of three warpgroups: two
//     consumers of 64 keys each and a producer; K and V stay in shared
//     memory (TMA, 128-byte swizzle), and the producer streams the (q, do)
//     tiles of 64 queries through a three-stage ring with TMA, its lanes
//     staging lse (+inf past N, so p = 0 there) and delta beside them;
//   * per tile and warpgroup: s^T = k q^T and dp^T = v do^T by wgmma from
//     shared memory (keys as rows), so p^T and ds^T come out in the
//     accumulator layout, which re-packs in registers as the A operand of
//     dv += p^T do and dk += ds^T q (do and q read MN-major: the transpose
//     flag); ds^T also goes to a swizzled shared tile, the MN-major A
//     operand of this warpgroup's share of dq = ds k;
//   * the two warpgroups' shares of a tile's dq meet in shared memory, each
//     warpgroup adding up half of the tile's queries, and dq is summed over
//     the key tiles in an f32 (B, H, N, 64) scratch by atomic adds (float2,
//     sm_90), one per value and tile, so its summation order, and its last
//     bits, vary from run to run; fap_bwd_d64_dq_kernel then scales it by
//     q_scale and casts it into the strided bf16 dq view. The caller hands
//     in the scratch, zeroed (PyTorch's allocator owns it);
//   * q is used as loaded and bf16(q_scale) is folded into the f32 products:
//     s = (q k^T) bf16(q_scale) and dk = (ds^T q) bf16(q_scale). Where
//     q_scale is a power of two (the ViT's 1/8, or 1 with q pre-scaled) this
//     is q_s k^T and ds^T q_s exactly; otherwise it skips the forward's
//     rounding of q_s, about 2^-9 of a value.
// In both designs ragged N is masked in the kernels: keys past N get a
// -inf bias, query rows past N a +inf lse (so p = 0 there), and rows past N
// are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlock = 64;  // query rows (dq pass) or keys (dk/dv pass) per CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

enum { kQ, kK, kV, kDo, kDq, kDk, kDv, kTensors };

// Pointers and (batch, token, head) strides in elements of one launch.
struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* bias;   // (B, 1, N)
  const float* lse;    // (B, H, N)
  const float* delta;  // (B, H, N)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t s[kTensors][3];
  int N;
  float q_scale;
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the (b, h) slice of tensor `i`
template <typename T>
__device__ __forceinline__ T* slice(T* base, const BwdArgs& a, int i, int b,
                                    int h) {
  return base + b * a.s[i][0] + h * a.s[i][2];
}

// A fragment (16 rows x 16) of a row-major shared-memory tile
template <int kStride>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row,
                                       int col, int g, int t) {
  const __nv_bfloat16* p0 = tile + (row + g) * kStride + col + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * kStride;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// Copy kBlock rows of D channels at `src` (row stride `stride`) into a
// row-major tile and/or its transpose; rows past `rows` are zero. Values are
// multiplied by `scale` in bf16 when scale != 1 (the forward's q * bf16(s)).
template <int D, bool kRow, bool kTrans>
__device__ __forceinline__ void stage(__nv_bfloat16* tile, __nv_bfloat16* tile_t,
                                      const __nv_bfloat16* src, int64_t stride,
                                      int rows, float scale) {
  constexpr int kStride = D + 8;
  constexpr int kTStride = kBlock + 8;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlock * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + r * stride + col);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
    if (scale != 1.0f) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    }
    if constexpr (kRow)
      *reinterpret_cast<uint4*>(&tile[r * kStride + col]) = v;
    if constexpr (kTrans) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tile_t[(col + i) * kTStride + r] = e[i];
    }
  }
}

// dk and dv for one 64-key tile of one (head, batch row).
template <int D>
__global__ void __launch_bounds__(kThreads) fap_bwd_dkdv_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;
  constexpr int kTStride = kBlock + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 sQt[D * kTStride];
  __shared__ __align__(16) __nv_bfloat16 sDo[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 sDot[D * kTStride];
  __shared__ float sLse[kBlock];
  __shared__ float sDelta[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int N = a.N;
  const __nv_bfloat16* qb = slice(a.q, a, kQ, b, h);
  const __nv_bfloat16* dob = slice(a.dout, a, kDo, b, h);
  const float* lse_bh = a.lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = a.delta + ((int64_t)b * H + h) * N;
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));

  // this tile's K and V, staged through the query-side buffers
  stage<D, true, false>(sQ, nullptr,
                        slice(a.k, a, kK, b, h) + k0 * a.s[kK][1],
                        a.s[kK][1], N - k0, 1.0f);
  stage<D, true, false>(sDo, nullptr,
                        slice(a.v, a, kV, b, h) + k0 * a.s[kV][1],
                        a.s[kV][1], N - k0, 1.0f);
  __syncthreads();

  const int kr = warp * 16;  // this warp's 16 keys within the tile
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<kStride>(kf[kk], sQ, kr, kk * 16, g, t);
    load_a<kStride>(vf[kk], sDo, kr, kk * 16, g, t);
  }
  const int key0 = k0 + kr + g;  // keys of accumulator rows g and g + 8
  const int key1 = key0 + 8;
  const float kb0 = key0 < N ? a.bias[(int64_t)b * N + key0] : -INFINITY;
  const float kb1 = key1 < N ? a.bias[(int64_t)b * N + key1] : -INFINITY;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile's buffers
    stage<D, true, true>(sQ, sQt, qb + q0 * a.s[kQ][1], a.s[kQ][1], N - q0,
                         qs);
    stage<D, true, true>(sDo, sDot, dob + q0 * a.s[kDo][1], a.s[kDo][1],
                         N - q0, 1.0f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int n = q0 + r;
      sLse[r] = n < N ? lse_bh[n] : INFINITY;
      sDelta[r] = n < N ? delta_bh[n] : 0.0f;
    }
    __syncthreads();

    // 16 queries at a time: p^T and ds^T for this warp's 16 keys, then
    // dv += p^T do and dk += ds^T q_s (two n8 fragments form one k16 A
    // operand)
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      float p[2][4], ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const __nv_bfloat16* qp = &sQ[(j * 8 + g) * kStride + dd * 16 + 2 * t];
          mma_16816(s, kf[dd], ld32(qp), ld32(qp + 8));
          const __nv_bfloat16* op = &sDo[(j * 8 + g) * kStride + dd * 16 + 2 * t];
          mma_16816(dp, vf[dd], ld32(op), ld32(op + 8));
        }
        const int c0 = j * 8 + 2 * t;  // the query columns of this thread
        const float l0 = sLse[c0], l1 = sLse[c0 + 1];
        const float e0 = sDelta[c0], e1 = sDelta[c0 + 1];
        p[jj][0] = exp2f((s[0] + kb0 - l0) * kLog2e);
        p[jj][1] = exp2f((s[1] + kb0 - l1) * kLog2e);
        p[jj][2] = exp2f((s[2] + kb1 - l0) * kLog2e);
        p[jj][3] = exp2f((s[3] + kb1 - l1) * kLog2e);
        ds[jj][0] = p[jj][0] * (dp[0] - e0);
        ds[jj][1] = p[jj][1] * (dp[1] - e1);
        ds[jj][2] = p[jj][2] * (dp[2] - e0);
        ds[jj][3] = p[jj][3] * (dp[3] - e1);
      }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]),
                              pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]),
                              pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* op = &sDot[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dv[n], pa, ld32(op), ld32(op + 8));
        const __nv_bfloat16* qp = &sQt[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dk[n], da, ld32(qp), ld32(qp + 8));
      }
    }
  }

  __nv_bfloat16* dkb = slice(a.dk, a, kDk, b, h);
  __nv_bfloat16* dvb = slice(a.dv, a, kDv, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < N) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * a.s[kDk][1] + col) =
          pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + key0 * a.s[kDv][1] + col) =
          pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key1 < N) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * a.s[kDk][1] + col) =
          pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + key1 * a.s[kDv][1] + col) =
          pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// dq for one 64-query tile of one (head, batch row).
template <int D>
__global__ void __launch_bounds__(kThreads) fap_bwd_dq_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;
  constexpr int kTStride = kBlock + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 sKt[D * kTStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlock * kStride];
  __shared__ float sBias[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int N = a.N;
  const __nv_bfloat16* kb = slice(a.k, a, kK, b, h);
  const __nv_bfloat16* vb = slice(a.v, a, kV, b, h);
  const float* bias_b = a.bias + (int64_t)b * N;
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));

  // this tile's q_s and do, staged through the key-side buffers
  stage<D, true, false>(sK, nullptr,
                        slice(a.q, a, kQ, b, h) + q0 * a.s[kQ][1],
                        a.s[kQ][1], N - q0, qs);
  stage<D, true, false>(sV, nullptr,
                        slice(a.dout, a, kDo, b, h) + q0 * a.s[kDo][1],
                        a.s[kDo][1], N - q0, 1.0f);
  __syncthreads();

  const int qr = warp * 16;
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<kStride>(qf[kk], sK, qr, kk * 16, g, t);
    load_a<kStride>(of[kk], sV, qr, kk * 16, g, t);
  }
  const int r0 = q0 + qr + g;  // query rows of accumulator rows g, g + 8
  const int r1 = r0 + 8;
  const float* lse_bh = a.lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = a.delta + ((int64_t)b * H + h) * N;
  const float l0 = r0 < N ? lse_bh[r0] : INFINITY;
  const float l1 = r1 < N ? lse_bh[r1] : INFINITY;
  const float e0 = r0 < N ? delta_bh[r0] : 0.0f;
  const float e1 = r1 < N ? delta_bh[r1] : 0.0f;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile's buffers
    stage<D, true, true>(sK, sKt, kb + k0 * a.s[kK][1], a.s[kK][1], N - k0,
                         1.0f);
    stage<D, true, false>(sV, nullptr, vb + k0 * a.s[kV][1], a.s[kV][1],
                          N - k0, 1.0f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int n = k0 + r;
      sBias[r] = n < N ? bias_b[n] : -INFINITY;
    }
    __syncthreads();

    // 16 keys at a time: ds for this warp's 16 queries, then dq += ds k
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const __nv_bfloat16* kp = &sK[(j * 8 + g) * kStride + dd * 16 + 2 * t];
          mma_16816(s, qf[dd], ld32(kp), ld32(kp + 8));
          const __nv_bfloat16* vp = &sV[(j * 8 + g) * kStride + dd * 16 + 2 * t];
          mma_16816(dp, of[dd], ld32(vp), ld32(vp + 8));
        }
        const float b0 = sBias[j * 8 + 2 * t];
        const float b1 = sBias[j * 8 + 2 * t + 1];
        ds[jj][0] = exp2f((s[0] + b0 - l0) * kLog2e) * (dp[0] - e0);
        ds[jj][1] = exp2f((s[1] + b1 - l0) * kLog2e) * (dp[1] - e0);
        ds[jj][2] = exp2f((s[2] + b0 - l1) * kLog2e) * (dp[2] - e1);
        ds[jj][3] = exp2f((s[3] + b1 - l1) * kLog2e) * (dp[3] - e1);
      }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]),
                              pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]),
                              pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* kp = &sKt[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dq[n], da, ld32(kp), ld32(kp + 8));
      }
    }
  }

  __nv_bfloat16* dqb = slice(a.dq, a, kDq, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dqb + r0 * a.s[kDq][1] + col) =
          pack_bf16(dq[n][0] * a.q_scale, dq[n][1] * a.q_scale);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dqb + r1 * a.s[kDq][1] + col) =
          pack_bf16(dq[n][2] * a.q_scale, dq[n][3] * a.q_scale);
  }
}

template <int D>
int launch(const BwdArgs& a, int B, int H, cudaStream_t s) {
  const dim3 grid((a.N + kBlock - 1) / kBlock, H, B);
  fap_bwd_dkdv_kernel<D><<<grid, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fap_bwd_dq_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- D = 64: one pass with wgmma and a TMA ring (see the head of the file)

namespace d64 {

constexpr int kKeys = 128;     // keys per CTA, 64 per consumer warpgroup
constexpr int kQueries = 64;   // queries per ring tile
constexpr int kStages = 3;     // (q, do) ring depth
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kHalf = 64 * 128;        // bytes of 64 rows of 64 bf16
// dynamic shared memory from a 1024-byte-aligned base: K, V (128 rows
// each), the ring's q and do tiles, each warpgroup's ds^T tile, the ring's
// lse and delta rows, the dq exchange (two tiles' parity x four warps x
// 32 lanes x 32 floats), then the barriers
constexpr int kRingOff = 4 * kHalf;
constexpr int kDsOff = kRingOff + kStages * 2 * kHalf;
constexpr int kStatOff = kDsOff + 2 * kHalf;
constexpr int kXOff = kStatOff + kStages * 2 * kQueries * 4;
constexpr int kBarOff = kXOff + 2 * 4 * 32 * 32 * 4;
constexpr int kSmemBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
    fap_bwd_d64_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const BwdArgs a, float* dq_acc, int n_pad) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + 2 * kHalf;
  auto sQ = [&](int s) { return smem + kRingOff + 2 * kHalf * s; };
  auto sDo = [&](int s) { return smem + kRingOff + 2 * kHalf * s + kHalf; };
  float* sLse = reinterpret_cast<float*>(smem + kStatOff);
  float* sDelta = sLse + kStages * kQueries;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int N = a.N;
  const int tiles = (N + kQueries - 1) / kQueries;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp; lane 0 issues the TMA loads, every lane stages
    // two rows of lse (+inf past N, so p = 0 there) and delta
    reg_dealloc<40>();
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 4 * kHalf);
      tma_load_4d(sK, &tk, kv_full, 0, h, k0, b);
      tma_load_4d(sV, &tv, kv_full, 0, h, k0, b);
    }
    const float* lse_bh = a.lse + ((int64_t)b * H + h) * N;
    const float* delta_bh = a.delta + ((int64_t)b * H + h) * N;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
      for (int r = lane; r < kQueries; r += 32) {
        const int n = i * kQueries + r;
        sLse[s * kQueries + r] = n < N ? lse_bh[n] : INFINITY;
        sDelta[s * kQueries + r] = n < N ? delta_bh[n] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kHalf);
        tma_load_4d(sQ(s), &tq, &full[s], 0, h, i * kQueries, b);
        tma_load_4d(sDo(s), &tdo, &full[s], 0, h, i * kQueries, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  reg_alloc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sf = __bfloat162float(__float2bfloat16(a.q_scale));
  const int key0 = k0 + 64 * wg + 16 * warp + g;  // accumulator rows
  const int key1 = key0 + 8;
  const float kb0 = key0 < N ? a.bias[(int64_t)b * N + key0] : -INFINITY;
  const float kb1 = key1 < N ? a.bias[(int64_t)b * N + key1] : -INFINITY;
  const uint64_t dk_desc = desc_sw128(sK + wg * kHalf);
  const uint64_t dv_desc = desc_sw128(sV + wg * kHalf);
  uint8_t* sDs = smem + kDsOff + wg * kHalf;
  const uint64_t ds_desc = desc_sw128(sDs);
  float* acc_bh = dq_acc + ((int64_t)b * H + h) * n_pad * 64;

  float dk[32], dv[32], st[32], dp[32], dqp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = st[i] = dp[i] = dqp[i] = 0.0f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint64_t q_desc = desc_sw128(sQ(s));
    const uint64_t do_desc = desc_sw128(sDo(s));
    // this thread's query columns' lse and delta, read before the products
    // (the wait below orders shared memory, so later reads would stall on
    // their latency after it)
    float2 l2[8], d2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l2[j] = *reinterpret_cast<const float2*>(sLse + s * kQueries + 8 * j +
                                               2 * t);
      d2[j] = *reinterpret_cast<const float2*>(sDelta + s * kQueries +
                                               8 * j + 2 * t);
    }
    // s^T = k q^T and dp^T = v do^T: keys as rows, this tile's queries as
    // columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<0, 0>(st, desc_add(dk_desc, 32 * kk),
                         desc_add(q_desc, 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<0, 0>(dp, desc_add(dv_desc, 32 * kk),
                         desc_add(do_desc, 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);

    // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), per query column;
    // s + bias - lse in that order, as the TPU kernels: exact 0 for a row
    // of equal -1e9 scores (p = 1 there)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2_approx((fmaf(st[4 * j], sf, kb0) - l2[j].x) *
                                   kLog2e);
      const float p1 = exp2_approx((fmaf(st[4 * j + 1], sf, kb0) - l2[j].y) *
                                   kLog2e);
      const float p2 = exp2_approx((fmaf(st[4 * j + 2], sf, kb1) - l2[j].x) *
                                   kLog2e);
      const float p3 = exp2_approx((fmaf(st[4 * j + 3], sf, kb1) - l2[j].y) *
                                   kLog2e);
      dp[4 * j] = p0 * (dp[4 * j] - d2[j].x);
      dp[4 * j + 1] = p1 * (dp[4 * j + 1] - d2[j].y);
      dp[4 * j + 2] = p2 * (dp[4 * j + 2] - d2[j].x);
      dp[4 * j + 3] = p3 * (dp[4 * j + 3] - d2[j].y);
      st[4 * j] = p0;
      st[4 * j + 1] = p1;
      st[4 * j + 2] = p2;
      st[4 * j + 3] = p3;
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
        da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }
    }
    // ds^T into this warpgroup's swizzled tile, the A operand of dq = ds k
    // (queries as rows: MN-major); rows g and g + 8 of a warp share the
    // swizzle phase g
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = ((j ^ g) << 4) + 4 * t;
      const int r0 = 16 * warp + g;
      *reinterpret_cast<uint32_t*>(sDs + r0 * 128 + chunk) =
          da[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(sDs + (r0 + 8) * 128 + chunk) =
          da[j >> 1][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    // dv += p^T do, dk += ds^T q, dq_part = ds k (do, q and k MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dv, pa[kk], desc_add(do_desc, 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dk, da[kk], desc_add(q_desc, 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<1, 1>(dqp, desc_add(ds_desc, 2048 * kk),
                         desc_add(dk_desc, 2048 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dqp);
    if (lane == 0) mbar_arrive(&empty[s]);

    // the two warpgroups' dq shares meet in shared memory: warpgroup w adds
    // query rows 32 w .. 32 w + 31 (its warps 2w and 2w + 1) of both and
    // sums them into the scratch (unscaled; the dq kernel scales them), so
    // each dq value of a tile takes one atomic add, not two. The buffer
    // alternates with the tile's parity: a warpgroup writes it again only
    // after the other has passed the next tile's barrier.
    const bool mine = (warp >> 1) == wg;
    float4* xb = reinterpret_cast<float4*>(smem + kXOff) +
                 ((i & 1) * 4 + warp) * 8 * 32 + lane;
    if (!mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xb[32 * j] = make_float4(dqp[4 * j], dqp[4 * j + 1], dqp[4 * j + 2],
                                 dqp[4 * j + 3]);
    }
    named_barrier(3, 256);
    if (mine) {
      float* acc = acc_bh + (int64_t)(i * kQueries + 16 * warp + g) * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = xb[32 * j];
        atomicAdd(reinterpret_cast<float2*>(acc + 8 * j + 2 * t),
                  make_float2(dqp[4 * j] + x.x, dqp[4 * j + 1] + x.y));
        atomicAdd(reinterpret_cast<float2*>(acc + 8 * 64 + 8 * j + 2 * t),
                  make_float2(dqp[4 * j + 2] + x.z, dqp[4 * j + 3] + x.w));
      }
    }
  }

  __nv_bfloat16* dkb = slice(a.dk, a, kDk, b, h);
  __nv_bfloat16* dvb = slice(a.dv, a, kDv, b, h);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (key0 < N) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * a.s[kDk][1] + col) =
          pack_bf16(dk[4 * j] * sf, dk[4 * j + 1] * sf);
      *reinterpret_cast<uint32_t*>(dvb + key0 * a.s[kDv][1] + col) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (key1 < N) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * a.s[kDk][1] + col) =
          pack_bf16(dk[4 * j + 2] * sf, dk[4 * j + 3] * sf);
      *reinterpret_cast<uint32_t*>(dvb + key1 * a.s[kDv][1] + col) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// dq[b, n, h, :] = bf16(dq_acc[b, h, n, :] * q_scale), 8 channels a thread
__global__ void fap_bwd_d64_dq_kernel(const float* dq_acc, BwdArgs a, int H,
                                      int n_pad, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % 8) * 8;
  const int64_t row = i / 8;  // (b, h, n)
  const int n = (int)(row % a.N);
  const int64_t bh = row / a.N;
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + (bh * n_pad + n) * 64 + c);
  const float4 x = src[0], y = src[1];
  const float f = a.q_scale;
  uint4 out;
  out.x = pack_bf16(x.x * f, x.y * f);
  out.y = pack_bf16(x.z * f, x.w * f);
  out.z = pack_bf16(y.x * f, y.y * f);
  out.w = pack_bf16(y.z * f, y.w * f);
  *reinterpret_cast<uint4*>(slice(a.dq, a, kDq, b, h) + n * a.s[kDq][1] + c) =
      out;
}

// dq_acc: the zeroed f32 (B, H, n_pad, 64) scratch, n_pad = N rounded up
// to kQueries
int launch(const BwdArgs& a, int B, int H, float* dq_acc,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (dq_acc == nullptr ||
      !sm90::make_head_map(&tq, a.q, a.s[kQ], B, a.N, H, kQueries) ||
      !sm90::make_head_map(&tk, a.k, a.s[kK], B, a.N, H, kKeys) ||
      !sm90::make_head_map(&tv, a.v, a.s[kV], B, a.N, H, kKeys) ||
      !sm90::make_head_map(&tdo, a.dout, a.s[kDo], B, a.N, H, kQueries))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory on the current device
  cudaError_t err = cudaFuncSetAttribute(
      fap_bwd_d64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_pad = (a.N + kQueries - 1) / kQueries * kQueries;
  const dim3 grid((a.N + kKeys - 1) / kKeys, H, B);
  fap_bwd_d64_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, tdo, a, dq_acc, n_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * H * a.N * 8;
  fap_bwd_d64_dq_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                          stream>>>(dq_acc, a, H, n_pad, total);
  return (int)cudaGetLastError();
}

}  // namespace d64

}  // namespace

// C entry point (bound with ctypes). q, k, v, dout, dq, dk and dv are
// (B, N, H, D) bf16 views given by their data pointers and `strides`, 21
// int64 in elements: the (batch, token, head) strides of q, k, v, dout, dq,
// dk, dv in that order, each a multiple of 8, with every pointer 16-byte
// aligned and the D channels of a head contiguous. bias (B, 1, N), lse and
// delta (B, H, N) f32 contiguous. dq_scratch: at D = 64 a zeroed f32
// (B, H, N rounded up to 64, 64) tensor in which the one-pass kernel sums
// dq; unused (may be null) at D = 16. Launches on `stream` the dk/dv pass,
// then the dq pass (D = 16), or the one-pass kernel and the dq cast
// (D = 64). Returns the first failing launch's cudaError_t;
// cudaErrorInvalidValue for a head dimension other than 16 or 64, an empty
// shape, or (D = 64) no scratch or a view that cuTensorMapEncodeTiled
// refuses.
extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* bias,
                                const void* lse, const void* delta, void* dq,
                                void* dk, void* dv, void* dq_scratch,
                                const long long* strides, int B, int N, int H,
                                int D, float q_scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || (D != 16 && D != 64))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  a.N = N;
  a.q_scale = q_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return D == 16 ? launch<16>(a, B, H, s)
                 : d64::launch(a, B, H, static_cast<float*>(dq_scratch), s);
}

// Dynamic shared memory of the D = 64 kernel in bytes (for build reports).
extern "C" int fa_backward_d64_smem_bytes() { return d64::kSmemBytes; }
