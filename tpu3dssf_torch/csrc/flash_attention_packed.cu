// Strided flash attention forward for Hopper (sm_90a), bf16 in/out.
//
// One kernel replaces four TPU kernels that compute the same function and
// differ only in layout and Mosaic block rules:
//   * tpu3dssf/kernels/flash_attention.py::_packed_kernel, its
//     with_lse=False forward (K1) and, with the kLse flag, its with_lse=True
//     training forward (K2);
//   * tpu3dssf/kernels/window_attention.py::_attn_kernel_lse (K4, kLse) and
//     ::_attn_kernel (K6), the (W, K, H, D) window kernels;
//   * tpu3dssf/kernels/flash_attention.py::_flash_kernel (K8), the
//     (B, H, N, D) kernel of the ViT's many-head route, and (kLse) the
//     forward of its training rule.
// Computes, for every (batch row b, head h):
//
//     out[b, :, h, :] = softmax(q_s k^T + bias[b]) v
//
// q, k, v and out are separate pointers, each with its own (batch, token,
// head) strides in elements and the D channels of a head contiguous. The
// packed projection (B, N, 3C) is one stride set (q at channel h*D of a row
// of 3C, k at C + h*D, v at 2C + h*D: token stride 3C, head stride D), and
// (B, N, H, D) tensors, or q/k/v views of one (W, K, 3C) buffer, are others,
// so no layout is repacked before the kernel. q is scaled by q_scale in bf16
// (1.0 when the caller pre-scaled), the additive key bias (B, 1, N) is f32,
// and the output is normalised after the PV product by max(denominator,
// 1e-20), as the TPU kernels do.
//
// Design. One CTA of four warps per (64-row query tile, head, batch row);
// each warp owns 16 query rows. The CTA walks the keys in tiles of 64 with an
// online softmax (running max, running sum, f32 output accumulator in
// registers), so no score block ever leaves the SM: the TPU kernels instead
// kept all N keys of a head resident in VMEM, which at N = 2845, D = 64 is
// more than the 227 KB of shared memory a block may use. Both products run
// on the tensor cores as mma.sync m16n8k16 bf16 with f32 accumulation; the
// S accumulator fragment is re-packed in registers as the A operand of the
// PV product, so probabilities never touch shared memory. Ragged edges are
// masked in the kernel (keys past N score -inf, query rows past N are not
// stored), so N need not be a multiple of any tile: a 48-slot PTv3 window
// is one CTA per (window, head) with 16 idle rows and keys.
//
// With kLse the kernel also writes the per-(b, h, query row) log-sum-exp in
// natural-log units, lse[b, h, n] = m + log(max(l, 1e-20)) as f32 (B, H, N),
// converted once per row on the store from the running max m and sum l.
//
// What bounds it. At D = 16 (the PTv3 stages) each key brings 2 x 16 x 2
// bytes of K and V for 2 x 16 multiply-adds per query row: arithmetic
// intensity is low, and the kernel is bound by memory and latency (global
// loads, the exp of every score, shuffles). The 64-row query tile amortises
// each K/V tile over 64 rows, and one CTA per (tile, head, window) gives
// thousands of CTAs to hide the load latency. At D = 64 (the ViT) the
// products dominate and the bound is the tensor-core issue rate of mma.sync;
// keeping S and P in registers and padding the shared-memory rows to avoid
// bank conflicts keeps the MMA pipe fed. wgmma, TMA and a pipelined
// multi-stage K/V ring are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per CTA, 16 per warp
constexpr int kBlockK = 64;   // keys per inner-loop tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Pointers and (batch, token, head) strides in elements of one launch.
struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;   // (B, 1, N)
  __nv_bfloat16* out;
  float* lse;          // (B, H, N), written only with kLse
  int64_t q_s[3], k_s[3], v_s[3], o_s[3];
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

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads) fap_fwd_kernel(const FwdArgs a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;          // Q/K smem row stride (elements)
  constexpr int kVtStride = kBlockK + 8;  // V^T smem row stride (elements)
  constexpr int kChunks = D / 8;          // 16-byte chunks per head row
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * kVtStride];
  __shared__ float sBias[kBlockK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int N = a.N;
  const __nv_bfloat16* qb = a.q + b * a.q_s[0] + h * a.q_s[2];
  const __nv_bfloat16* kb = a.k + b * a.k_s[0] + h * a.k_s[2];
  const __nv_bfloat16* vb = a.v + b * a.v_s[0] + h * a.v_s[2];
  const float* bias_b = a.bias + (int64_t)b * N;

  // Q tile; q * q_scale rounded to bf16, the TPU kernels' q * bf16(scale)
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int n = q0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) v = *reinterpret_cast<const uint4*>(qb + n * a.q_s[1] + col);
    if (qs != 1.0f) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * qs);
    }
    *reinterpret_cast<uint4*>(&sQ[r * kStride + col]) = v;
  }
  __syncthreads();

  const int qr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = &sQ[(qr + g) * kStride + kk * 16 + 2 * t];
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    qf[kk][0] = ld32(p0);
    qf[kk][1] = ld32(p1);
    qf[kk][2] = ld32(p0 + 8);
    qf[kk][3] = ld32(p1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the sums

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int n = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) {
        kv = *reinterpret_cast<const uint4*>(kb + n * a.k_s[1] + col);
        vv = *reinterpret_cast<const uint4*>(vb + n * a.v_s[1] + col);
      }
      *reinterpret_cast<uint4*>(&sK[r * kStride + col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * kVtStride + r] = ve[i];
    }
    for (int r = tid; r < kBlockK; r += kThreads) {
      const int n = k0 + r;
      sBias[r] = n < N ? bias_b[n] : -INFINITY;
    }
    __syncthreads();

    // S = q_s K^T + bias for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = &sK[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        mma_16816(s[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
      const float b0 = sBias[j * 8 + 2 * t];
      const float b1 = sBias[j * 8 + 2 * t + 1];
      s[j][0] += b0;
      s[j][1] += b1;
      s[j][2] += b0;
      s[j][3] += b1;
    }

    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float mn0 = fmaxf(m0, t0);
    const float mn1 = fmaxf(m1, t1);
    // a row can only see -inf everywhere if the caller passed -inf biases;
    // keep it NaN-free (its output is then 0)
    const float ms0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float a0 = exp2f((m0 - ms0) * kLog2e);  // 0 on the first tile
    const float a1 = exp2f((m1 - ms1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = exp2f((s[j][0] - ms0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - ms0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - ms1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - ms1) * kLog2e);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // acc += P V: two adjacent n8 score fragments form one k16 A operand
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = &sVt[(n * 8 + g) * kVtStride + kk * 16 + 2 * t];
        mma_16816(acc[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);

  const int r0 = q0 + qr + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = a.out + b * a.o_s[0] + h * a.o_s[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.o_s[1] + col) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * a.o_s[1] + col) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
  if constexpr (kLse) {
    // a row whose every score was -inf (only with -inf biases) gets +inf,
    // so the backward's exp(s - lse) is 0 there and not NaN
    float* lb = a.lse + ((int64_t)b * gridDim.y + h) * N;
    if (t == 0 && r0 < N) lb[r0] = m0 == -INFINITY ? INFINITY : m0 + logf(d0);
    if (t == 0 && r1 < N) lb[r1] = m1 == -INFINITY ? INFINITY : m1 + logf(d1);
  }
}

template <bool kLse>
void launch(const FwdArgs& a, int B, int H, int D, cudaStream_t s) {
  const dim3 grid((a.N + kBlockQ - 1) / kBlockQ, H, B);
  if (D == 16)
    fap_fwd_kernel<16, kLse><<<grid, kThreads, 0, s>>>(a);
  else
    fap_fwd_kernel<64, kLse><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

// C entry point (bound with ctypes). q, k, v and out are (B, N, H, D) bf16
// views given by their data pointers and `strides`, 12 int64 in elements:
// the (batch, token, head) strides of q, k, v, out in that order, each a
// multiple of 8, with every pointer 16-byte aligned and the D channels of a
// head contiguous. bias (B, 1, N) f32 contiguous. lse (B, H, N) f32
// contiguous, or null for the forward without LSE. Returns the cudaError_t
// of the launch; cudaErrorInvalidValue for an unsupported head dimension
// (16 and 64 are built) or empty shape.
extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* lse,
                               const long long* strides, int B, int N, int H,
                               int D, float q_scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || (D != 16 && D != 64))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.q_s[i] = strides[i];
    a.k_s[i] = strides[3 + i];
    a.v_s[i] = strides[6 + i];
    a.o_s[i] = strides[9 + i];
  }
  a.N = N;
  a.q_scale = q_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    launch<true>(a, B, H, D, s);
  else
    launch<false>(a, B, H, D, s);
  return (int)cudaGetLastError();
}
