// Strided flash attention backward for Hopper (sm_90a), bf16 in/out.
//
// One backward replaces three TPU kernels that compute the same gradient and
// differ in layout, Mosaic block rules and where their statistics come from:
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
// Design. Two passes, no atomics, so the gradients are deterministic:
//   * fap_bwd_dkdv_kernel: one CTA of four warps per (64-key tile, head,
//     batch row); each warp owns 16 keys and keeps their K and V fragments
//     and the dk, dv accumulators in registers while the CTA walks all query
//     tiles of 64. It computes the transposed scores s^T = k q_s^T (keys as
//     rows), so the accumulator fragments of p^T and ds^T are directly the A
//     operands of dv = p^T do and dk = ds^T q_s (the re-pack trick of the
//     forward kernel), and neither ever touches shared memory.
//   * fap_bwd_dq_kernel: one CTA per (64-query tile, head, batch row); each
//     warp owns 16 queries, keeps q_s, do, lse and delta of its rows in
//     registers and walks all key tiles, accumulating dq = ds k.
// Both products per tile run on the tensor cores as mma.sync m16n8k16 bf16
// with f32 accumulation. Operands read as B with the reduction along the
// tile's rows (do and q_s for dv/dk, k for dq) are stored transposed in
// shared memory, so every B fragment is two 32-bit loads. Each 16-wide slice
// of a tile's scores is turned into p and ds and consumed by the products
// before the next slice is computed, so at D = 64 a warp holds only the dk
// and dv accumulators (64 floats a thread) and two score fragments, not a
// 16 x 64 block of p and ds beside them. The operands staged only once (K
// and V in the dk/dv pass, q_s and do in the dq pass) go through the shared
// buffers of the loop, which keeps D = 64 inside 48 KB of static shared
// memory. Ragged N is masked in the kernels: keys past N get a -inf bias,
// query rows past N a +inf lse (so p = 0 there), and rows past N are not
// stored.
//
// What bounds it. At D = 16 every score costs one exp and a few f32 ops on
// the CUDA cores against 4 x 16 multiply-adds on the tensor cores: like the
// forward, the kernel is bound by latency and the exp of each score
// (recomputed once in each pass), not by bytes. At D = 64 the five products
// per score block dominate and the bound is the mma.sync issue rate. wgmma,
// TMA and one fused pass (dq by atomics or a split reduction) are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// C entry point (bound with ctypes). q, k, v, dout, dq, dk and dv are
// (B, N, H, D) bf16 views given by their data pointers and `strides`, 21
// int64 in elements: the (batch, token, head) strides of q, k, v, dout, dq,
// dk, dv in that order, each a multiple of 8, with every pointer 16-byte
// aligned and the D channels of a head contiguous. bias (B, 1, N), lse and
// delta (B, H, N) f32 contiguous. Launches the dk/dv pass, then the dq pass,
// on `stream`. Returns the first failing launch's cudaError_t;
// cudaErrorInvalidValue for a head dimension other than 16 or 64 or an empty
// shape.
extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* bias,
                                const void* lse, const void* delta, void* dq,
                                void* dk, void* dv, const long long* strides,
                                int B, int N, int H, int D, float q_scale,
                                void* stream) {
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
  return D == 16 ? launch<16>(a, B, H, s) : launch<64>(a, B, H, s);
}
