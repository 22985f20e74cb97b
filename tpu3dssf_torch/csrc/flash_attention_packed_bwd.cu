// Packed-layout flash attention backward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernel tpu3dssf/kernels/flash_attention.py::
// _packed_bwd_kernel with use_stats=True (K3, the training backward of the
// PTv3 stages with C % 128 == 0) and window_attention.py::_attn_bwd_kernel
// (K5, the C = 32/64 stages): the two compute the same function and differ
// only in Mosaic block rules. For every (batch row b, head h), from the
// forward's log-sum-exp lse (B, H, N) and delta = rowsum(do * o) (B, H, N),
// both f32 and computed outside:
//
//     q_s = bf16(q * bf16(q_scale))           (the forward's scaled q)
//     s   = q_s k^T + bias[b]                 p  = exp(s - lse)
//     dv  = p^T do                            dp = do v^T
//     ds  = p * (dp - delta)
//     dq  = (ds k) * q_scale                  dk = ds^T q_s
//
// with q, k, v read straight from the packed qkv (B, N, 3C) (head h at
// channel offset h*D of each third), do (B, N, C) bf16, and the result
// written as one packed dqkv (B, N, 3C) bf16. As in the TPU kernel, p is
// rounded to bf16 for the dv product and ds for the dq and dk products;
// every product accumulates in f32.
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
// shared memory, so every B fragment is two 32-bit loads. Ragged N is masked
// in the kernels: keys past N get a -inf bias, query rows past N a +inf lse
// (so p = 0 there), and rows past N are not stored.
//
// What bounds it. At D = 16 every score costs one exp and a few f32 ops on
// the CUDA cores against 4 x 16 multiply-adds on the tensor cores: like the
// forward, the kernel is bound by latency and the exp of each score
// (recomputed once in each pass), not by bytes. wgmma,
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
__global__ void __launch_bounds__(kThreads)
    fap_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dqkv, int N, int C,
                        float q_scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;
  constexpr int kTStride = kBlock + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlock * kStride];
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
  const int64_t row_stride = 3LL * C;
  const __nv_bfloat16* base = qkv + (int64_t)b * N * row_stride + h * D;
  const __nv_bfloat16* do_base = dout + (int64_t)b * N * C + h * D;
  const float* lse_bh = lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = delta + ((int64_t)b * H + h) * N;
  const float qs = __bfloat162float(__float2bfloat16(q_scale));

  stage<D, true, false>(sK, nullptr, base + (int64_t)k0 * row_stride + C,
                        row_stride, N - k0, 1.0f);
  stage<D, true, false>(sV, nullptr, base + (int64_t)k0 * row_stride + 2 * C,
                        row_stride, N - k0, 1.0f);
  __syncthreads();

  const int kr = warp * 16;  // this warp's 16 keys within the tile
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<kStride>(kf[kk], sK, kr, kk * 16, g, t);
    load_a<kStride>(vf[kk], sV, kr, kk * 16, g, t);
  }
  const int key0 = k0 + kr + g;  // keys of accumulator rows g and g + 8
  const int key1 = key0 + 8;
  const float kb0 = key0 < N ? bias[(int64_t)b * N + key0] : -INFINITY;
  const float kb1 = key1 < N ? bias[(int64_t)b * N + key1] : -INFINITY;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous query tile
    stage<D, true, true>(sQ, sQt, base + (int64_t)q0 * row_stride, row_stride,
                         N - q0, qs);
    stage<D, true, true>(sDo, sDot, do_base + (int64_t)q0 * C, C, N - q0,
                         1.0f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int n = q0 + r;
      sLse[r] = n < N ? lse_bh[n] : INFINITY;
      sDelta[r] = n < N ? delta_bh[n] : 0.0f;
    }
    __syncthreads();

    // p^T and ds^T for this warp's 16 keys x 64 queries
    float p[kBlock / 8][4], ds[kBlock / 8][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* qp = &sQ[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        mma_16816(s, kf[kk], ld32(qp), ld32(qp + 8));
        const __nv_bfloat16* op = &sDo[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        mma_16816(dp, vf[kk], ld32(op), ld32(op + 8));
      }
      const int c0 = j * 8 + 2 * t;  // the query columns of this thread
      const float l0 = sLse[c0], l1 = sLse[c0 + 1];
      const float e0 = sDelta[c0], e1 = sDelta[c0 + 1];
      p[j][0] = exp2f((s[0] + kb0 - l0) * kLog2e);
      p[j][1] = exp2f((s[1] + kb0 - l1) * kLog2e);
      p[j][2] = exp2f((s[2] + kb1 - l0) * kLog2e);
      p[j][3] = exp2f((s[3] + kb1 - l1) * kLog2e);
      ds[j][0] = p[j][0] * (dp[0] - e0);
      ds[j][1] = p[j][1] * (dp[1] - e1);
      ds[j][2] = p[j][2] * (dp[2] - e0);
      ds[j][3] = p[j][3] * (dp[3] - e1);
    }

    // dv += p^T do, dk += ds^T q_s: two adjacent n8 fragments form one k16
    // A operand
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
          pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
          pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
          pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* op = &sDot[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dv[n], pa, ld32(op), ld32(op + 8));
        const __nv_bfloat16* qp = &sQt[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dk[n], da, ld32(qp), ld32(qp + 8));
      }
    }
  }

  __nv_bfloat16* ob = dqkv + (int64_t)b * N * row_stride + h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < N) {
      __nv_bfloat16* r = ob + (int64_t)key0 * row_stride + col;
      *reinterpret_cast<uint32_t*>(r + C) = pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(r + 2 * C) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key1 < N) {
      __nv_bfloat16* r = ob + (int64_t)key1 * row_stride + col;
      *reinterpret_cast<uint32_t*>(r + C) = pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(r + 2 * C) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// dq for one 64-query tile of one (head, batch row).
template <int D>
__global__ void __launch_bounds__(kThreads)
    fap_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dqkv, int N, int C,
                      float q_scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;
  constexpr int kTStride = kBlock + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 sDo[kBlock * kStride];
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
  const int64_t row_stride = 3LL * C;
  const __nv_bfloat16* base = qkv + (int64_t)b * N * row_stride + h * D;
  const float* bias_b = bias + (int64_t)b * N;
  const float qs = __bfloat162float(__float2bfloat16(q_scale));

  stage<D, true, false>(sQ, nullptr, base + (int64_t)q0 * row_stride,
                        row_stride, N - q0, qs);
  stage<D, true, false>(sDo, nullptr, dout + (int64_t)b * N * C +
                        (int64_t)q0 * C + h * D, C, N - q0, 1.0f);
  __syncthreads();

  const int qr = warp * 16;
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<kStride>(qf[kk], sQ, qr, kk * 16, g, t);
    load_a<kStride>(of[kk], sDo, qr, kk * 16, g, t);
  }
  const int r0 = q0 + qr + g;  // query rows of accumulator rows g, g + 8
  const int r1 = r0 + 8;
  const float* lse_bh = lse + ((int64_t)b * H + h) * N;
  const float* delta_bh = delta + ((int64_t)b * H + h) * N;
  const float l0 = r0 < N ? lse_bh[r0] : INFINITY;
  const float l1 = r1 < N ? lse_bh[r1] : INFINITY;
  const float e0 = r0 < N ? delta_bh[r0] : 0.0f;
  const float e1 = r1 < N ? delta_bh[r1] : 0.0f;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous key tile
    stage<D, true, true>(sK, sKt, base + (int64_t)k0 * row_stride + C,
                         row_stride, N - k0, 1.0f);
    stage<D, true, false>(sV, nullptr,
                          base + (int64_t)k0 * row_stride + 2 * C, row_stride,
                          N - k0, 1.0f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int n = k0 + r;
      sBias[r] = n < N ? bias_b[n] : -INFINITY;
    }
    __syncthreads();

    float ds[kBlock / 8][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = &sK[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        mma_16816(s, qf[kk], ld32(kp), ld32(kp + 8));
        const __nv_bfloat16* vp = &sV[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        mma_16816(dp, of[kk], ld32(vp), ld32(vp + 8));
      }
      const float b0 = sBias[j * 8 + 2 * t];
      const float b1 = sBias[j * 8 + 2 * t + 1];
      ds[j][0] = exp2f((s[0] + b0 - l0) * kLog2e) * (dp[0] - e0);
      ds[j][1] = exp2f((s[1] + b1 - l0) * kLog2e) * (dp[1] - e0);
      ds[j][2] = exp2f((s[2] + b0 - l1) * kLog2e) * (dp[2] - e1);
      ds[j][3] = exp2f((s[3] + b1 - l1) * kLog2e) * (dp[3] - e1);
    }

#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
          pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
          pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
          pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* kp = &sKt[(n * 8 + g) * kTStride + kk * 16 + 2 * t];
        mma_16816(dq[n], da, ld32(kp), ld32(kp + 8));
      }
    }
  }

  __nv_bfloat16* ob = dqkv + (int64_t)b * N * row_stride + h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * row_stride + col) =
          pack_bf16(dq[n][0] * q_scale, dq[n][1] * q_scale);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * row_stride + col) =
          pack_bf16(dq[n][2] * q_scale, dq[n][3] * q_scale);
  }
}

}  // namespace

// C entry point (bound with ctypes). qkv (B, N, 3C) bf16, bias (B, 1, N)
// f32, dout (B, N, C) bf16, lse and delta (B, H, N) f32, dqkv (B, N, 3C)
// bf16, all contiguous and 16-byte aligned. Launches the dk/dv pass, then
// the dq pass, on `stream`. Returns the first failing launch's cudaError_t;
// cudaErrorInvalidValue for a head dimension D = C / H other than 16.
extern "C" int fap_backward_bf16(const void* qkv, const void* bias,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dqkv, int B, int N,
                                 int C, int H, float q_scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || C % H != 0 || C / H != 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBlock - 1) / kBlock, H, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* bs = static_cast<const float*>(bias);
  const auto* o = static_cast<const __nv_bfloat16*>(dout);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(delta);
  auto* dst = static_cast<__nv_bfloat16*>(dqkv);
  fap_bwd_dkdv_kernel<16><<<grid, kThreads, 0, s>>>(q, bs, o, l, d, dst, N, C,
                                                    q_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fap_bwd_dq_kernel<16><<<grid, kThreads, 0, s>>>(q, bs, o, l, d, dst, N, C,
                                                  q_scale);
  return (int)cudaGetLastError();
}
