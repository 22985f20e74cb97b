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
// D = 16 (the PTv3 stages: K3, K5): one pass, one exp a score, and no
// atomics, so two launches on the same inputs give the same bits. A score
// costs 5 products of 32 flops (s, dp, dv, dk, dq) and one exp, so the exp
// on the special-function units (16 per clock per SM) bounds it, about 1.5
// times the products at window 1024; two passes spent two exps a score.
//   * fap_bwd_d16_kernel (N > 64): one CTA of 8 warps per (256 keys, head,
//     batch row); each warp keeps its 32 keys' K and V fragments, K^T (by
//     movmatrix) and the dk, dv accumulators in registers, while the
//     (q_s, do, lse, delta) tiles of 64 queries stream through a three-stage
//     cp.async ring (zeros past N, lse +inf, delta 0; each thread scales the
//     q chunk it copied, q * bf16(q_scale) rounded once). Per 16 queries:
//     s^T = k q_s^T and dp^T = v do^T with the keys as rows (q_s and do read
//     by ldmatrix), so p^T and ds^T are accumulator fragments that re-pack
//     in registers as the A operands of dv += p^T do and dk += ds^T q_s (q_s
//     and do by ldmatrix.trans); movmatrix turns ds^T into the A operand of
//     the warp's share of dq = ds k, summed over its key groups in
//     registers. The 8 shares of a tile meet in shared memory and are added
//     in warp order. A CTA that holds all N keys (N <= 256) writes dq times
//     q_scale; otherwise each writes an f32 partial (B, H, blocks, N, 16)
//     into a torch.empty scratch and fap_bwd_d16_dq_kernel adds the blocks'
//     partials in block order, scales and casts. The key block trades CTAs
//     (W H is only 136-272 at the train step's shapes) against the
//     partials' bytes, written and read once: per train step (about 3,600
//     (window, head) pairs at N = 1024) 3.7 GB (1.1 ms at 3.35 TB/s) at 128
//     keys, 1.8 GB (0.55 ms) at 256, 0.9 GB (0.28 ms) at 512; 512 would
//     leave 272-544 CTAs and double each warp's key registers, so 256.
//   * fap_bwd_d16_small_kernel<kG> (N <= 64, windows of 48): one warp per
//     (batch row, head), 8 a CTA, owning all 16 kG >= N keys (N rounded up
//     to 16: no idle warp, no exp on a padding slot); it stages its q_s,
//     do, lse and delta rows and writes dq per tile of 16 queries.
// Both run mma.sync m16n8k16 bf16 with f32 accumulation; the tiles use
// the swizzled 32-byte rows of mma16.cuh.
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

#include "mma16.cuh"
#include "sm90.cuh"

namespace {

using mma16::pack_bf16;
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

// the (b, h) slice of tensor `i`
template <typename T>
__device__ __forceinline__ T* slice(T* base, const BwdArgs& a, int i, int b,
                                    int h) {
  return base + b * a.s[i][0] + h * a.s[i][2];
}

// ---- D = 16: one pass, one exp a score, dq summed in a fixed order -------

namespace d16 {

using namespace mma16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = 32;                  // keys a warp owns (ring kernel)
constexpr int kBlockKeys = kWarps * kWarpKeys;  // keys per CTA (ring kernel)
constexpr int kQueries = 64;                   // queries per ring tile
constexpr int kStages = 3;                     // ring depth
constexpr int kSmallN = 64;  // up to here: one warp per (batch row, head)
constexpr int kSmallWarps = 8;  // warps, so (batch row, head) pairs, a CTA

// One warp's 16 kG keys: K and V as A operands (keys as rows), K^T as the
// B operands of dq = ds k, the key biases of accumulator rows g and g + 8
// of each group in log2 units (-inf past N), and the dk, dv accumulators.
template <int kG>
struct Keys {
  uint32_t kf[kG][4], vf[kG][4], kt[kG][4];
  float kb[kG][2];
  float dk[kG][2][4], dv[kG][2][4];
};

// keys key0 .. key0 + 16 kG - 1 of (b, h)
template <int kG>
__device__ __forceinline__ void load_keys(Keys<kG>& K, const BwdArgs& a,
                                          int b, int h, int key0, int lane) {
  const int N = a.N;
  const float* bias_b = a.bias + (int64_t)b * N;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int k0 = key0 + 16 * i;
    load_a(K.kf[i], slice(a.k, a, kK, b, h), a.s[kK][1], k0, N, lane);
    load_a(K.vf[i], slice(a.v, a, kV, b, h), a.s[kV][1], k0, N, lane);
    // K^T: the transposed 8 x 8 blocks of K, in B-operand order (channels
    // 0-7: keys 0-7, then 8-15; channels 8-15 likewise)
#pragma unroll
    for (int x = 0; x < 4; ++x) K.kt[i][x] = movmatrix_trans(K.kf[i][x]);
    const int r0 = k0 + (lane >> 2), r1 = r0 + 8;
    K.kb[i][0] = r0 < N ? bias_b[r0] * kLog2e : -INFINITY;
    K.kb[i][1] = r1 < N ? bias_b[r1] * kLog2e : -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) K.dk[i][n][x] = K.dv[i][n][x] = 0.0f;
  }
}

// Queries 16c .. 16c + 15 of a staged tile (q_s and do rows at sQ, sDo in
// the row_off layout; lse in log2 units, +inf past N; delta, 0 past N)
// against the warp's keys:
// s^T = k q_s^T and dp^T = v do^T with the keys as rows, so p^T and ds^T
// come out in the accumulator layout and re-pack in registers as the A
// operands of dv += p^T do and dk += ds^T q_s; movmatrix turns ds^T into
// the A operand of this warp's share of dq = ds k, summed over its key
// groups in order into dq (queries as rows, the 16 channels as columns).
// p = exp2(s log2(e) + bias log2(e) - lse log2(e)), one FMA and one
// subtraction: where every bias of a row is -1e9 the forward's LSE is
// -1e9 exactly (f32 cannot hold -1e9 + log N apart), both products round
// alike and p = 1, as in the TPU kernels. p is rounded to bf16 for dv, ds
// for dk and dq.
template <int kG>
__device__ __forceinline__ void chunk(Keys<kG>& K, uint32_t sQ, uint32_t sDo,
                                      const float* lse, const float* delta,
                                      int c, int lane, float (&dq)[2][4]) {
  const int t = lane & 3;
  uint32_t qb[4], ob[4], qt[4], ot[4];
  load_b_rows(qb, sQ, c, lane);
  load_b_rows(ob, sDo, c, lane);
  load_b_cols(qt, sQ, c, lane);
  load_b_cols(ot, sDo, c, lane);
  float2 l2[2], d2[2];  // this thread's query columns 16c + 8n + 2t, + 1
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    l2[n] = *reinterpret_cast<const float2*>(lse + 16 * c + 8 * n + 2 * t);
    d2[n] = *reinterpret_cast<const float2*>(delta + 16 * c + 8 * n + 2 * t);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dq[n][x] = 0.0f;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] = dp[n][x] = 0.0f;
    mma(s[0], K.kf[i], qb[0], qb[1]);
    mma(s[1], K.kf[i], qb[2], qb[3]);
    mma(dp[0], K.vf[i], ob[0], ob[1]);
    mma(dp[1], K.vf[i], ob[2], ob[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float kb = K.kb[i][x >> 1];
        const float l = (x & 1) ? l2[n].y : l2[n].x;
        const float e = (x & 1) ? d2[n].y : d2[n].x;
        const float p = exp2_approx(fmaf(s[n][x], kLog2e, kb) - l);
        dp[n][x] = p * (dp[n][x] - e);
        s[n][x] = p;
      }
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]),
                            pack_bf16(dp[0][2], dp[0][3]),
                            pack_bf16(dp[1][0], dp[1][1]),
                            pack_bf16(dp[1][2], dp[1][3])};
    mma(K.dv[i][0], pa, ot[0], ot[1]);
    mma(K.dv[i][1], pa, ot[2], ot[3]);
    mma(K.dk[i][0], da, qt[0], qt[1]);
    mma(K.dk[i][1], da, qt[2], qt[3]);
    // ds (queries as rows): the transposed blocks of ds^T
    const uint32_t dsa[4] = {movmatrix_trans(da[0]), movmatrix_trans(da[2]),
                             movmatrix_trans(da[1]), movmatrix_trans(da[3])};
    mma(dq[0], dsa, K.kt[i][0], K.kt[i][1]);
    mma(dq[1], dsa, K.kt[i][2], K.kt[i][3]);
  }
}

// dk and dv of the warp's keys into the strided views
template <int kG>
__device__ __forceinline__ void store_keys(const Keys<kG>& K,
                                           const BwdArgs& a, int b, int h,
                                           int key0, int lane) {
  __nv_bfloat16* dkb = slice(a.dk, a, kDk, b, h);
  __nv_bfloat16* dvb = slice(a.dv, a, kDv, b, h);
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int r0 = key0 + 16 * i + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      if (r0 < a.N) {
        *reinterpret_cast<uint32_t*>(dkb + r0 * a.s[kDk][1] + col) =
            pack_bf16(K.dk[i][n][0], K.dk[i][n][1]);
        *reinterpret_cast<uint32_t*>(dvb + r0 * a.s[kDv][1] + col) =
            pack_bf16(K.dv[i][n][0], K.dv[i][n][1]);
      }
      if (r1 < a.N) {
        *reinterpret_cast<uint32_t*>(dkb + r1 * a.s[kDk][1] + col) =
            pack_bf16(K.dk[i][n][2], K.dk[i][n][3]);
        *reinterpret_cast<uint32_t*>(dvb + r1 * a.s[kDv][1] + col) =
            pack_bf16(K.dv[i][n][2], K.dv[i][n][3]);
      }
    }
  }
}

// N > kSmallN: one CTA of 8 warps per (256 keys, head, batch row), each
// warp 32 keys; the (q_s, do, lse, delta) tiles of 64 queries stream
// through a ring of kStages by cp.async (zeros past N; lse +inf, delta 0),
// each thread scaling the q chunk it copied once it has landed. Per tile
// the warps' dq shares meet in shared memory and are summed in warp order;
// a CTA that holds all N keys writes dq (times q_scale), otherwise its
// f32 partial goes to dq_part (B, H, blocks, N, 16) for fap_bwd_d16_dq_kernel
__global__ void __launch_bounds__(kThreads)
    fap_bwd_d16_kernel(const BwdArgs a, float* dq_part) {
  __shared__ __align__(128) uint8_t sQD[kStages][2][kQueries * 32];
  __shared__ __align__(16) float sStat[kStages][2][kQueries];
  __shared__ float4 sX[kWarps][kQueries / 16][2][32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int blk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int blocks = gridDim.x;
  const int N = a.N;
  const int tiles = (N + kQueries - 1) / kQueries;
  const float* lse_bh = a.lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = a.delta + ((int64_t)b * H + h) * N;
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  const __nv_bfloat16* qb = slice(a.q, a, kQ, b, h);
  const __nv_bfloat16* ob = slice(a.dout, a, kDo, b, h);

  // tile j into stage j % kStages: for i = tid, tid + kThreads, ... chunk
  // i & 1 of query row (i / 2) % kQueries of q (i < 2 kQueries) or do, and
  // row i % kQueries of lse (i < kQueries) or delta (i < 2 kQueries)
  auto load = [&](int j) {
    const int st = j % kStages;
    for (int i = tid; i < 4 * kQueries; i += kThreads) {
      const int which = i / (2 * kQueries), r = (i >> 1) % kQueries;
      const int c = i & 1, n = j * kQueries + r;
      cp_async16(smem_u32(sQD[st][which]) + row_off(r, c),
                 (which ? ob : qb) + (n < N ? n : 0) * a.s[which ? kDo : kQ][1]
                     + 8 * c, n < N ? 16 : 0);
    }
    for (int i = tid; i < 2 * kQueries; i += kThreads) {
      const int r = i % kQueries, m = j * kQueries + r;
      float* dst = &sStat[st][i / kQueries][r];
      if (m < N)
        cp_async4(smem_u32(dst), (i < kQueries ? lse_bh : delta_bh) + m);
      else
        *dst = i < kQueries ? INFINITY : 0.0f;
    }
  };

  const int key0 = blk * kBlockKeys + kWarpKeys * warp;
  const bool live = key0 < N;  // a warp with keys below N does the math
  Keys<kWarpKeys / 16> K;
  load_keys(K, a, b, h, key0, lane);

  load(0);
  cp_async_commit();
  if (tiles > 1) load(1);
  cp_async_commit();
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j
    // the lse and the q chunks this thread copied: lse in log2 units, q
    // times bf16(q_scale) rounded once
    for (int i = tid; i < kQueries && j * kQueries + i < N; i += kThreads)
      sStat[st][0][i] *= kLog2e;
    for (int i = tid; qs != 1.0f && i < 2 * kQueries; i += kThreads) {
      uint4* p = reinterpret_cast<uint4*>(&sQD[st][0][row_off(i >> 1, i & 1)]);
      uint4 v = *p;
      v.x = scale_bf16x2(v.x, qs);
      v.y = scale_bf16x2(v.y, qs);
      v.z = scale_bf16x2(v.z, qs);
      v.w = scale_bf16x2(v.w, qs);
      *p = v;
    }
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int c = 0; c < kQueries / 16; ++c) {
      float dq[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      if (live)
        chunk(K, smem_u32(sQD[st][0]), smem_u32(sQD[st][1]), sStat[st][0],
              sStat[st][1], c, lane, dq);
      sX[warp][c][0][lane] = make_float4(dq[0][0], dq[0][1], dq[0][2], dq[0][3]);
      sX[warp][c][1][lane] = make_float4(dq[1][0], dq[1][1], dq[1][2], dq[1][3]);
    }
    __syncthreads();
    // fragment f = (c, n, l), for f = tid, tid + kThreads, ..., summed over
    // the warps in order: queries 16c + l / 4 and + 8, channels 8n +
    // 2 (l % 4) and + 1
    for (int f = tid; f < kQueries / 16 * 64; f += kThreads) {
      const int c = f >> 6, n = (f >> 5) & 1, l = f & 31;
      float4 x = sX[0][c][n][l];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 y = sX[w][c][n][l];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      const int q0 = j * kQueries + 16 * c + (l >> 2), q1 = q0 + 8;
      const int col = 8 * n + 2 * (l & 3);
      if (blocks == 1) {
        __nv_bfloat16* dqb = slice(a.dq, a, kDq, b, h);
        const float s = a.q_scale;
        if (q0 < N)
          *reinterpret_cast<uint32_t*>(dqb + q0 * a.s[kDq][1] + col) =
              pack_bf16(x.x * s, x.y * s);
        if (q1 < N)
          *reinterpret_cast<uint32_t*>(dqb + q1 * a.s[kDq][1] + col) =
              pack_bf16(x.z * s, x.w * s);
      } else {
        float* part = dq_part + (((int64_t)b * H + h) * blocks + blk) * N * 16;
        if (q0 < N)
          *reinterpret_cast<float2*>(part + q0 * 16 + col) =
              make_float2(x.x, x.y);
        if (q1 < N)
          *reinterpret_cast<float2*>(part + q1 * 16 + col) =
              make_float2(x.z, x.w);
      }
    }
  }
  store_keys(K, a, b, h, key0, lane);
}

// dq[b, n, h, :] = bf16(q_scale * sum over the key blocks, in block order,
// of dq_part[b, h, block, n, :]), 8 channels a thread
__global__ void __launch_bounds__(256)
    fap_bwd_d16_dq_kernel(const float* dq_part, BwdArgs a, int H, int blocks,
                          int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i & 1) * 8;
  const int64_t row = i >> 1;  // (b, h, n)
  const int n = (int)(row % a.N);
  const int64_t bh = row / a.N;
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  const float* p = dq_part + (bh * blocks * a.N + n) * 16 + c;
  float4 x = reinterpret_cast<const float4*>(p)[0];
  float4 y = reinterpret_cast<const float4*>(p)[1];
  for (int k = 1; k < blocks; ++k) {
    const float4* q = reinterpret_cast<const float4*>(p + (int64_t)k * a.N * 16);
    const float4 u = q[0], v = q[1];
    x.x += u.x; x.y += u.y; x.z += u.z; x.w += u.w;
    y.x += v.x; y.y += v.y; y.z += v.z; y.w += v.w;
  }
  const float f = a.q_scale;
  uint4 out;
  out.x = pack_bf16(x.x * f, x.y * f);
  out.y = pack_bf16(x.z * f, x.w * f);
  out.z = pack_bf16(y.x * f, y.y * f);
  out.w = pack_bf16(y.z * f, y.w * f);
  *reinterpret_cast<uint4*>(slice(a.dq, a, kDq, b, h) + n * a.s[kDq][1] + c) =
      out;
}

// N <= kSmallN: one warp per (batch row, head), 8 of them a CTA; the warp
// owns all 16 kG >= N keys (N rounded up to 16) and stages its q_s, do,
// lse and delta, then walks its query tiles of 16: dq of a tile is summed
// over the key groups in registers and written at once. Two CTAs an SM
// (at most 128 registers a thread; ptxas gives kG = 3 170 unbounded)
// measured faster on an H100 at window 48.
template <int kG>
__global__ void __launch_bounds__(32 * kSmallWarps, 2)
    fap_bwd_d16_small_kernel(const BwdArgs a, int H, int pairs) {
  constexpr int kN = 16 * kG;
  __shared__ __align__(128) uint8_t sQD[kSmallWarps][2][kN * 32];
  __shared__ __align__(16) float sStat[kSmallWarps][2][kN];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kSmallWarps + warp;
  if (pair >= pairs) return;
  const int h = pair % H;
  const int b = pair / H;
  const int N = a.N;
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  const __nv_bfloat16* qb = slice(a.q, a, kQ, b, h);
  const __nv_bfloat16* ob = slice(a.dout, a, kDo, b, h);
  for (int i = lane; i < 2 * kN; i += 32) {
    const int r = i >> 1, c = i & 1;
    uint4 q = make_uint4(0u, 0u, 0u, 0u), o = q;
    if (r < N) {
      q = *reinterpret_cast<const uint4*>(qb + r * a.s[kQ][1] + 8 * c);
      o = *reinterpret_cast<const uint4*>(ob + r * a.s[kDo][1] + 8 * c);
      if (qs != 1.0f) {  // q * bf16(q_scale), rounded once
        q.x = scale_bf16x2(q.x, qs);
        q.y = scale_bf16x2(q.y, qs);
        q.z = scale_bf16x2(q.z, qs);
        q.w = scale_bf16x2(q.w, qs);
      }
    }
    *reinterpret_cast<uint4*>(&sQD[warp][0][row_off(r, c)]) = q;
    *reinterpret_cast<uint4*>(&sQD[warp][1][row_off(r, c)]) = o;
  }
  const float* lse_bh = a.lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = a.delta + ((int64_t)b * H + h) * N;
  for (int i = lane; i < kN; i += 32) {
    sStat[warp][0][i] = i < N ? lse_bh[i] * kLog2e : INFINITY;
    sStat[warp][1][i] = i < N ? delta_bh[i] : 0.0f;
  }
  Keys<kG> K;
  load_keys(K, a, b, h, 0, lane);
  __syncwarp();

  __nv_bfloat16* dqb = slice(a.dq, a, kDq, b, h);
  const float f = a.q_scale;
  const int g = lane >> 2, col = 2 * (lane & 3);
#pragma unroll 1
  for (int c = 0; 16 * c < N; ++c) {
    float dq[2][4];
    chunk(K, smem_u32(sQD[warp][0]), smem_u32(sQD[warp][1]), sStat[warp][0],
          sStat[warp][1], c, lane, dq);
    const int q0 = 16 * c + g, q1 = q0 + 8;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (q0 < N)
        *reinterpret_cast<uint32_t*>(dqb + q0 * a.s[kDq][1] + 8 * n + col) =
            pack_bf16(dq[n][0] * f, dq[n][1] * f);
      if (q1 < N)
        *reinterpret_cast<uint32_t*>(dqb + q1 * a.s[kDq][1] + 8 * n + col) =
            pack_bf16(dq[n][2] * f, dq[n][3] * f);
    }
  }
  store_keys(K, a, b, h, 0, lane);
}

// the key blocks of the ring kernel; dq_part is needed when there are two
// or more
int key_blocks(int N) { return N > kSmallN ? (N + kBlockKeys - 1) / kBlockKeys : 1; }

int launch(const BwdArgs& a, int B, int H, float* dq_part, cudaStream_t s) {
  if (a.N <= kSmallN) {
    const int pairs = B * H;
    const dim3 grid((pairs + kSmallWarps - 1) / kSmallWarps);
    const int threads = 32 * kSmallWarps;
    switch ((a.N + 15) / 16) {
      case 1: fap_bwd_d16_small_kernel<1><<<grid, threads, 0, s>>>(a, H, pairs); break;
      case 2: fap_bwd_d16_small_kernel<2><<<grid, threads, 0, s>>>(a, H, pairs); break;
      case 3: fap_bwd_d16_small_kernel<3><<<grid, threads, 0, s>>>(a, H, pairs); break;
      default: fap_bwd_d16_small_kernel<4><<<grid, threads, 0, s>>>(a, H, pairs); break;
    }
    return (int)cudaGetLastError();
  }
  const int nb = key_blocks(a.N);
  if (nb > 1 && dq_part == nullptr) return (int)cudaErrorInvalidValue;
  fap_bwd_d16_kernel<<<dim3(nb, H, B), kThreads, 0, s>>>(a, dq_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return (int)err;
  const int64_t total = (int64_t)B * H * a.N * 2;
  fap_bwd_d16_dq_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      dq_part, a, H, nb, total);
  return (int)cudaGetLastError();
}

}  // namespace d16

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
// dq; at D = 16 an f32 (B, H, blocks, N, 16) tensor of per-key-block dq
// partials, its contents unused on entry, where N > 64 takes blocks =
// ceil(N / fa_backward_d16_block_keys()) >= 2, and null otherwise.
// Launches on `stream` one kernel (D = 16 up to 256 keys), or the one-pass
// kernel and then the kernel that sums, scales and casts dq. Returns the
// first failing launch's cudaError_t; cudaErrorInvalidValue for a head
// dimension other than 16 or 64, an empty shape, a missing scratch, or
// (D = 64) a view that cuTensorMapEncodeTiled refuses.
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
  float* scratch = static_cast<float*>(dq_scratch);
  return D == 16 ? d16::launch(a, B, H, scratch, s)
                 : d64::launch(a, B, H, scratch, s);
}

// Dynamic shared memory of the D = 64 kernel in bytes (for build reports).
extern "C" int fa_backward_d64_smem_bytes() { return d64::kSmemBytes; }

// Keys per CTA of the D = 16 one-pass kernel (the wrapper sizes dq_scratch
// by it).
extern "C" int fa_backward_d16_block_keys() { return d16::kBlockKeys; }
