// Strided flash attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces four TPU kernels that compute the same function and differ only
// in layout and Mosaic block rules:
//   * tpu3dssf/kernels/flash_attention.py::_packed_kernel, its
//     with_lse=False forward (K1) and, with the kLse flag, its with_lse=True
//     training forward (K2); at D = 64 also its use_rope branch (kRope), the
//     DINOv3 ViT's K1 with q and k rotated by axial-RoPE tables;
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
// Two designs, chosen by the head dimension D at the C entry point.
//
// D = 16 (the PTv3 stages: K1, K2, K4, K6). A score costs 2 products of
// 32 flops and one exp, so at window 1024 the exp on the special-function
// units (16 per clock per SM) is the limit, about 3.7 times the products;
// at window 48 the bytes are. Both products run as mma.sync m16n8k16 bf16
// with f32 accumulation, each warp on 16 query rows; K rows are read by
// ldmatrix and V rows by ldmatrix.trans from swizzled 32-byte rows
// (mma16.cuh), so V is never transposed by hand. The softmax is online and
// in log2 units: s becomes (s + bias) log2(e) by one FMA with the bias
// staged in log2 units (a row of equal -1e9 biases then gives p = 1, as
// the TPU kernels do), one ex2.approx a score; the rows' maxima are taken
// by a tree, and the accumulator is rescaled every tile (skipping it by a
// warp vote where no max moved measured slower on an H100 at window 1024).
//   * fap_fwd_d16_kernel (N > 64): one CTA of 4 warps per (128 query rows,
//     head, batch row), so each K/V tile serves 128 rows; each warp owns 32
//     rows, two tiles of 16 whose softmax chains run side by side on every
//     K and V fragment it reads (half the shared-memory reads a score of 16
//     rows a warp). The keys stream in tiles of 64 through a three-stage
//     cp.async ring with their f32 biases (zeros and -inf past N), one
//     barrier a tile. There are still >= 1,000 CTAs at every PTv3 shape of
//     window 1024 (68 windows x 2 heads x 8 at C = 32). Other layouts
//     measured on an H100 (8 warps x 16 rows over 128-key tiles, 8 x 32,
//     2 x 64 over 32-key tiles) were no faster, and a build without the
//     exps only a little faster: instruction issue and latency hold it,
//     not the exp.
//   * fap_fwd_d16_small_kernel<kG> (N <= 64, windows of 48): one warp per
//     (batch row, head), 8 a CTA, over 16 kG >= N keys (N rounded up to 16),
//     so no warp idles and no padding slot costs an exp; the warp stages
//     its keys by cp.async, 16 bytes a thread, with its Q fragments in
//     flight beside them, and takes its tiles of 16 query rows two at a
//     time. Adjacent warps take adjacent heads of one window, whose rows
//     sit side by side in the projection.
// q_s = bf16(q * bf16(q_scale)) is formed once per fragment in registers.
//
// D = 64 (the ViT: K1 at every ViT-S layer, K8 and K8's forward with LSE on
// the ViT-L route), fap_fwd_kernel_d64. One score costs 256 product flops
// and one exp: at 989 TFLOP/s and 16 exps per clock on 132 SMs at 1.98 GHz
// the tensor cores and the exp are about equally tight (ViT-L, B = 12:
// products 0.40 ms, exps 0.37 ms). So the kernel keeps both busy at once:
//   * one CTA per (128 query rows, head, batch row) of three warpgroups:
//     two consumers of 64 rows each (setmaxnreg up to 232 registers) and a
//     producer (down to 40) of which one warp works;
//   * the producer loads Q once and streams K and V in tiles of 192 keys
//     (fewer per-tile waits, shuffles and rescales than 128) through a
//     ring of three stages with TMA (4-D tensor maps over (D, H, N, B) from
//     each view's strides, so the packed (B, N, 3C) layout and (B, N, H, D)
//     tensors are both just strides; 128-byte swizzle), with full/empty
//     mbarrier pairs; its lanes stage the f32 key bias beside each tile,
//     -inf past N (TMA fills keys past N with zeros, which would score 0),
//     and flag a tile whose biases are all 0 (the unmasked ViT), whose
//     softmax then reads none: shared-memory reads after the wait on S sit
//     on the softmax's critical path;
//   * S = q_s K^T is wgmma m64n192k16 from shared memory; O += P V is wgmma
//     m64n64k16 with P as the A operand from registers (the S accumulator
//     re-packed to bf16) and V read MN-major (the transpose flag), so V is
//     never transposed by hand;
//   * within a warpgroup, the products of key tile j (S_j) and of tile j-1
//     (P V) are in flight together while the softmax of S_j runs, so its
//     exps overlap the PV product; across the two warpgroups the tensor
//     cores take one's products while the other runs its softmax;
//   * q * bf16(q_scale) is rounded to bf16 once per CTA on the Q tile in
//     shared memory (each warpgroup its half), the TPU kernels' rounding.
// A row whose every score is -inf (only with -inf biases) gives output 0
// and, with kLse, LSE +inf.
//
// RoPE (kRope, D = 64; the TPU kernel's use_rope branch): each head's q is
// taken in f32 times q_scale (the f32 value, not bf16(q_scale)) and k in
// f32, each rotated by its token's row n of the (N, 32) f32 tables,
// (x1 cos - x2 sin, x1 sin + x2 cos) on channels [0, 32) and [32, 64),
// and rounded to bf16 once; every head and batch row uses the same tables.
// Products and sums are rounded one by one (no fused multiply-add), so the
// rotated values are those of the plain PyTorch version bit for bit.
//   * q is rotated by the consumers in the pass that scales the Q tile
//     otherwise, in the 128-byte-swizzled tile itself: logical 16-byte chunk
//     c of row r sits at physical chunk c ^ (r & 7), so its partner c + 4
//     sits at that index ^ 4, and each thread takes two such pairs.
//   * k is rotated once per call by a pre-kernel (fap_fwd_kernel_rope_k)
//     into a contiguous (B, N, H, 64) bf16 scratch that the wrapper takes
//     with torch.empty, and the attention kernel's K tensor map points at
//     it. The other design, the producer's idle warps rotating each K tile
//     after it lands, would rotate every key once per query tile and read
//     the tables (128 bytes a token each) again per CTA, and a 192-key
//     table tile (48 KB) fits beside the ring only once, not per stage; the
//     pre-kernel moves each key twice more through HBM instead (about 4% of
//     a ViT-L call).
//
// With kLse both write the per-(b, h, query row) log-sum-exp in natural-log
// units, lse[b, h, n] = m + log(max(l, 1e-20)) as f32 (B, H, N), converted
// once per row on the store from the running max m and sum l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma16.cuh"
#include "sm90.cuh"

namespace {

using mma16::pack_bf16;
constexpr float kLog2e = 1.4426950408889634f;

// Pointers and (batch, token, head) strides in elements of one launch.
struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;   // (B, 1, N)
  __nv_bfloat16* out;
  float* lse;          // (B, H, N), written only with kLse
  const float* rope_cos;  // (N, 32) RoPE tables, read only with kRope
  const float* rope_sin;
  int64_t q_s[3], k_s[3], v_s[3], o_s[3];
  int N;
  float q_scale;
};

// ---- D = 16: mma.sync, ldmatrix and a cp.async ring (see the head) -------

namespace d16 {

using namespace mma16;

constexpr int kWarps = 4;           // ring kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;       // query rows a warp owns: two tiles of 16
constexpr int kRows = kWarpRows * kWarps;  // query rows per CTA
constexpr int kKeys = 64;           // keys per ring tile
constexpr int kStages = 3;          // ring depth
constexpr int kSmallN = 64;         // up to here: one warp per (row, head)
constexpr int kSmallWarps = 8;      // warps, so (row, head) pairs, a CTA
constexpr float kLn2 = 0.6931471805599453f;

// The online softmax of one warp's 16 query rows: running max in log2
// units (rows g and g + 8), this thread's share of the sums, and the
// output accumulator over the 16 channels (two n8 fragments).
struct Rows {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
};

// q_s rows row0 .. row0 + 15 of one (batch row, head) as the A operand:
// q * bf16(q_scale) rounded to bf16, zero past N
__device__ __forceinline__ void load_q(uint32_t (&qf)[4],
                                       const __nv_bfloat16* qb,
                                       int64_t stride, int row0, int N,
                                       float qs, int lane) {
  load_a(qf, qb, stride, row0, N, lane);
  if (qs != 1.0f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[i] = scale_bf16x2(qf[i], qs);
  }
}

// One tile of 16 kGroups keys for kM tiles of 16 query rows of a warp
// (their Q fragments qf): K and V rows at the shared addresses sK, sV
// (row_off layout), the keys' biases in log2 units at bias2 (-inf past N).
// Each K and V fragment is read once for the kM row tiles, whose softmax
// chains are independent (instruction-level parallelism). Scores become
// (s + bias) log2(e) by one FMA, so a row of equal -1e9 biases gives equal
// scores and p = 1, as the TPU kernels give; one exp a score.
template <int kM, int kGroups>
__device__ __forceinline__ void attend(Rows (&r)[kM],
                                       const uint32_t (&qf)[kM][4],
                                       uint32_t sK, uint32_t sV,
                                       const float* bias2, int lane) {
  const int t = lane & 3;
  float s[kM][2 * kGroups][4];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    uint32_t kb[4];
    load_b_rows(kb, sK, i, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[m][2 * i][x] = s[m][2 * i + 1][x] = 0.0f;
      mma(s[m][2 * i], qf[m], kb[0], kb[1]);
      mma(s[m][2 * i + 1], qf[m], kb[2], kb[3]);
    }
  }
  float ms0[kM], ms1[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    // the rows' maxima over this thread's scores by a tree (short
    // chains), then over the four threads of a row
    float x0[2 * kGroups], x1[2 * kGroups];
#pragma unroll
    for (int j = 0; j < 2 * kGroups; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias2 + 8 * j + 2 * t);
      float(&sj)[4] = s[m][j];
      sj[0] = fmaf(sj[0], kLog2e, b.x);
      sj[1] = fmaf(sj[1], kLog2e, b.y);
      sj[2] = fmaf(sj[2], kLog2e, b.x);
      sj[3] = fmaf(sj[3], kLog2e, b.y);
      x0[j] = fmaxf(sj[0], sj[1]);
      x1[j] = fmaxf(sj[2], sj[3]);
    }
#pragma unroll
    for (int w = 1; w < 2 * kGroups; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < 2 * kGroups; j += 2 * w) {
        x0[j] = fmaxf(x0[j], x0[j + w]);
        x1[j] = fmaxf(x1[j], x1[j + w]);
      }
    }
    float t0 = x0[0], t1 = x1[0];
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float mn0 = fmaxf(r[m].m0, t0);
    const float mn1 = fmaxf(r[m].m1, t1);
    // a row can only see -inf everywhere if the caller passed -inf biases;
    // keep it NaN-free (its output is then 0)
    ms0[m] = mn0 == -INFINITY ? 0.0f : mn0;
    ms1[m] = mn1 == -INFINITY ? 0.0f : mn1;
    // every tile rescales (10 multiplies and 2 exps a thread): a warp
    // vote that skips it where no row's max moved measured slower, as it
    // sits on the softmax's critical path
    const float a0 = exp2_approx(r[m].m0 - ms0[m]);  // 0 on a row's first keys
    const float a1 = exp2_approx(r[m].m1 - ms1[m]);
    r[m].l0 *= a0;
    r[m].l1 *= a1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      r[m].o[n][0] *= a0;
      r[m].o[n][1] *= a0;
      r[m].o[n][2] *= a1;
      r[m].o[n][3] *= a1;
    }
    r[m].m0 = mn0;
    r[m].m1 = mn1;
  }
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    uint32_t vb[4];
    load_b_cols(vb, sV, i, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float(&p0)[4] = s[m][2 * i];
      float(&p1)[4] = s[m][2 * i + 1];
      p0[0] = exp2_approx(p0[0] - ms0[m]);
      p0[1] = exp2_approx(p0[1] - ms0[m]);
      p0[2] = exp2_approx(p0[2] - ms1[m]);
      p0[3] = exp2_approx(p0[3] - ms1[m]);
      p1[0] = exp2_approx(p1[0] - ms0[m]);
      p1[1] = exp2_approx(p1[1] - ms0[m]);
      p1[2] = exp2_approx(p1[2] - ms1[m]);
      p1[3] = exp2_approx(p1[3] - ms1[m]);
      r[m].l0 += (p0[0] + p0[1]) + (p1[0] + p1[1]);
      r[m].l1 += (p0[2] + p0[3]) + (p1[2] + p1[3]);
      // two adjacent n8 score fragments form one k16 A operand of O += P V
      const uint32_t pa[4] = {
          pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
          pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      mma(r[m].o[0], pa, vb[0], vb[1]);
      mma(r[m].o[1], pa, vb[2], vb[3]);
    }
  }
}

// out rows row0 .. row0 + 15 (those below N) normalised by max(l, 1e-20);
// with lse (the (b, h) row of the (B, H, N) LSE) also m + log(l), natural
// units, +inf where every score was -inf (the backward's p is then 0)
__device__ __forceinline__ void store_rows(Rows& r, __nv_bfloat16* ob,
                                           int64_t stride, float* lse,
                                           int row0, int N, int lane) {
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 1);
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 2);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 1);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 2);
  const float d0 = fmaxf(r.l0, 1e-20f);
  const float d1 = fmaxf(r.l1, 1e-20f);
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * stride + col) =
          pack_bf16(r.o[n][0] / d0, r.o[n][1] / d0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * stride + col) =
          pack_bf16(r.o[n][2] / d1, r.o[n][3] / d1);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < N)
      lse[r0] = r.m0 == -INFINITY ? INFINITY : (r.m0 + log2f(d0)) * kLn2;
    if (r1 < N)
      lse[r1] = r.m1 == -INFINITY ? INFINITY : (r.m1 + log2f(d1)) * kLn2;
  }
}

// N > kSmallN: one CTA of 4 warps per (128 query rows, head, batch row),
// each warp 32 rows (two independent tiles of 16 on every K/V fragment);
// K, V and the key biases stream through a ring of kStages tiles of 64
// keys by cp.async (zeros past N, bias -inf), one barrier a tile
template <bool kLse>
__global__ void __launch_bounds__(kThreads, 4)
    fap_fwd_d16_kernel(const FwdArgs a) {
  constexpr int kM = kWarpRows / 16;
  __shared__ __align__(128) uint8_t sKV[kStages][2][kKeys * 32];
  __shared__ __align__(16) float sBias[kStages][kKeys];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int N = a.N;
  const int tiles = (N + kKeys - 1) / kKeys;
  const __nv_bfloat16* kb = a.k + b * a.k_s[0] + h * a.k_s[2];
  const __nv_bfloat16* vb = a.v + b * a.v_s[0] + h * a.v_s[2];
  const float* bias_b = a.bias + (int64_t)b * N;

  // tile j into stage j % kStages: chunk i & 1 of key row i / 2 of K and
  // of V, and key i's bias, for i = tid, tid + kThreads, ...
  auto load = [&](int j) {
    const int st = j % kStages;
    for (int i = tid; i < 2 * kKeys; i += kThreads) {
      const int r = i >> 1, c = i & 1, n = j * kKeys + r;
      const int in = n < N ? 16 : 0;
      const int nn = n < N ? n : 0;
      cp_async16(smem_u32(sKV[st][0]) + row_off(r, c),
                 kb + nn * a.k_s[1] + 8 * c, in);
      cp_async16(smem_u32(sKV[st][1]) + row_off(r, c),
                 vb + nn * a.v_s[1] + 8 * c, in);
    }
    for (int i = tid; i < kKeys; i += kThreads) {
      const int n = j * kKeys + i;
      if (n < N)
        cp_async4(smem_u32(&sBias[st][i]), bias_b + n);
      else
        sBias[st][i] = -INFINITY;
    }
  };

  const int row0 = q0 + kWarpRows * warp;  // this warp's first query row
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  uint32_t qf[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
    load_q(qf[m], a.q + b * a.q_s[0] + h * a.q_s[2], a.q_s[1], row0 + 16 * m,
           N, qs, lane);
  Rows rows[kM];
  const bool live = row0 < N;  // a warp below N does the math

  load(0);
  cp_async_commit();
  if (tiles > 1) load(1);
  cp_async_commit();
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j
    for (int i = tid; i < kKeys && j * kKeys + i < N; i += kThreads)
      sBias[st][i] *= kLog2e;   // the keys this thread copied
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
    cp_async_commit();
    if (live)
      attend<kM, kKeys / 16>(rows, qf, smem_u32(sKV[st][0]),
                             smem_u32(sKV[st][1]), sBias[st], lane);
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
    store_rows(rows[m], a.out + b * a.o_s[0] + h * a.o_s[2], a.o_s[1],
               kLse ? a.lse + ((int64_t)b * gridDim.y + h) * N : nullptr,
               row0 + 16 * m, N, lane);
}

// N <= kSmallN: one warp per (batch row, head), 8 of them a CTA, over
// 16 kGroups >= N keys (N rounded up to 16, so a window of 48 spends no
// exp on a padding slot); the warp stages its K, V and biases, loads the
// Q fragments of all its kGroups tiles of 16 query rows meanwhile, then
// takes the tiles two at a time
template <int kGroups, bool kLse>
__global__ void __launch_bounds__(32 * kSmallWarps)
    fap_fwd_d16_small_kernel(const FwdArgs a, int H, int pairs) {
  constexpr int kN = 16 * kGroups;
  __shared__ __align__(128) uint8_t sKV[kSmallWarps][2][kN * 32];
  __shared__ __align__(16) float sBias[kSmallWarps][kN];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kSmallWarps + warp;
  if (pair >= pairs) return;
  const int h = pair % H;
  const int b = pair / H;
  const int N = a.N;
  const __nv_bfloat16* kb = a.k + b * a.k_s[0] + h * a.k_s[2];
  const __nv_bfloat16* vb = a.v + b * a.v_s[0] + h * a.v_s[2];
  const float* bias_b = a.bias + (int64_t)b * N;
  const uint32_t sK = smem_u32(sKV[warp][0]), sV = smem_u32(sKV[warp][1]);
  for (int i = lane; i < 2 * kN; i += 32) {
    const int r = i >> 1, c = i & 1;
    const int in = r < N ? 16 : 0;
    const int rr = r < N ? r : 0;
    cp_async16(sK + row_off(r, c), kb + rr * a.k_s[1] + 8 * c, in);
    cp_async16(sV + row_off(r, c), vb + rr * a.v_s[1] + 8 * c, in);
  }
  cp_async_commit();
  // every query tile's fragments, in flight beside K and V
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  const __nv_bfloat16* qb = a.q + b * a.q_s[0] + h * a.q_s[2];
  uint32_t qf[kGroups][4];
#pragma unroll
  for (int m = 0; m < kGroups; ++m)
    load_q(qf[m], qb, a.q_s[1], 16 * m, N, qs, lane);
  for (int i = lane; i < kN; i += 32)
    sBias[warp][i] = i < N ? bias_b[i] * kLog2e : -INFINITY;
  cp_async_wait<0>();
  __syncwarp();

  __nv_bfloat16* ob = a.out + b * a.o_s[0] + h * a.o_s[2];
  float* lse = kLse ? a.lse + ((int64_t)b * H + h) * N : nullptr;
#pragma unroll
  for (int m = 0; m < kGroups; m += 2) {
    if (m + 1 < kGroups) {
      Rows rows[2];
      attend<2, kGroups>(rows,
                         *reinterpret_cast<const uint32_t(*)[2][4]>(qf[m]),
                         sK, sV, sBias[warp], lane);
      store_rows(rows[0], ob, a.o_s[1], lse, 16 * m, N, lane);
      store_rows(rows[1], ob, a.o_s[1], lse, 16 * m + 16, N, lane);
    } else {
      Rows rows[1];
      attend<1, kGroups>(rows,
                         *reinterpret_cast<const uint32_t(*)[1][4]>(qf[m]),
                         sK, sV, sBias[warp], lane);
      store_rows(rows[0], ob, a.o_s[1], lse, 16 * m, N, lane);
    }
  }
}

template <bool kLse>
cudaError_t launch(const FwdArgs& a, int B, int H, cudaStream_t s) {
  if (a.N > kSmallN) {
    const dim3 grid((a.N + kRows - 1) / kRows, H, B);
    fap_fwd_d16_kernel<kLse><<<grid, kThreads, 0, s>>>(a);
  } else {
    const int pairs = B * H;
    const dim3 grid((pairs + kSmallWarps - 1) / kSmallWarps);
    const int threads = 32 * kSmallWarps;
    switch ((a.N + 15) / 16) {
      case 1: fap_fwd_d16_small_kernel<1, kLse><<<grid, threads, 0, s>>>(a, H, pairs); break;
      case 2: fap_fwd_d16_small_kernel<2, kLse><<<grid, threads, 0, s>>>(a, H, pairs); break;
      case 3: fap_fwd_d16_small_kernel<3, kLse><<<grid, threads, 0, s>>>(a, H, pairs); break;
      default: fap_fwd_d16_small_kernel<4, kLse><<<grid, threads, 0, s>>>(a, H, pairs); break;
    }
  }
  return cudaGetLastError();
}

}  // namespace d16

// ---- D = 64: wgmma, TMA and a K/V ring (see the head of the file) -------

namespace d64 {

// One chunk pair of a head row: lo holds channels 8c .. 8c + 7, hi channels
// 32 + 8c ..; cs and sn point at the 8 table entries of c in the token's row.
// x * scale, rotated, rounded to bf16 once; every step rounded on its own.
__device__ __forceinline__ void rope_pair(uint4& lo, uint4& hi,
                                          const float* cs, const float* sn,
                                          float scale) {
  const float4 c0 = reinterpret_cast<const float4*>(cs)[0];
  const float4 c1 = reinterpret_cast<const float4*>(cs)[1];
  const float4 s0 = reinterpret_cast<const float4*>(sn)[0];
  const float4 s1 = reinterpret_cast<const float4*>(sn)[1];
  const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  __nv_bfloat16* x1 = reinterpret_cast<__nv_bfloat16*>(&lo);
  __nv_bfloat16* x2 = reinterpret_cast<__nv_bfloat16*>(&hi);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a1 = __fmul_rn(__bfloat162float(x1[j]), scale);
    const float a2 = __fmul_rn(__bfloat162float(x2[j]), scale);
    x1[j] = __float2bfloat16(
        __fsub_rn(__fmul_rn(a1, cv[j]), __fmul_rn(a2, sv[j])));
    x2[j] = __float2bfloat16(
        __fadd_rn(__fmul_rn(a1, sv[j]), __fmul_rn(a2, cv[j])));
  }
}

// k rotated once per call into the contiguous (B, N, H, 64) scratch `dst`:
// one thread per (batch row, token, head, chunk pair c in 0..3), so a warp
// reads and writes whole 128-byte head rows
__global__ void __launch_bounds__(256)
    fap_fwd_kernel_rope_k(const FwdArgs a, int H, __nv_bfloat16* dst,
                          int64_t total) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = i & 3;
  const int64_t t = i >> 2;
  const int h = t % H;
  const int n = (t / H) % a.N;
  const int64_t b = t / H / a.N;
  const uint4* src = reinterpret_cast<const uint4*>(
      a.k + b * a.k_s[0] + n * a.k_s[1] + h * a.k_s[2]);
  uint4 lo = src[c], hi = src[c + 4];
  rope_pair(lo, hi, a.rope_cos + (int64_t)n * 32 + 8 * c,
            a.rope_sin + (int64_t)n * 32 + 8 * c, 1.0f);
  uint4* out = reinterpret_cast<uint4*>(dst + ((b * a.N + n) * H + h) * 64);
  out[c] = lo;
  out[c + 4] = hi;
}

constexpr int kRows = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int kKeys = 192;    // keys per tile
constexpr int kStages = 3;    // K/V ring depth
constexpr int kThreads = 384; // consumer warpgroups 0 and 1, producer 2
constexpr int kTile = 128 * 128;  // bytes of the Q tile: 128 rows of 64 bf16
constexpr int kKVTile = kKeys * 128;  // bytes of a K or V tile
// dynamic shared memory, from a 1024-byte-aligned base: Q, the ring's K and
// V tiles, the ring's key biases and their all-zero flags, then the
// barriers
constexpr int kBiasOff = kTile + kKVTile * 2 * kStages;
constexpr int kFlagOff = kBiasOff + kStages * kKeys * 4;
constexpr int kBarOff = kFlagOff + 16;  // the barriers 8-byte aligned
static_assert(kStages * 4 <= 16, "the flags fit before the barriers");
constexpr int kSmemBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;
constexpr float kLn2 = 0.6931471805599453f;

template <bool kLse, bool kRope>
__global__ void __launch_bounds__(kThreads, 1)
    fap_fwd_kernel_d64(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  float* sBias = reinterpret_cast<float*>(smem + kBiasOff);
  int* sZero = reinterpret_cast<int*>(smem + kFlagOff);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  auto sK = [&](int s) { return smem + kTile + kKVTile * 2 * s; };
  auto sV = [&](int s) { return smem + kTile + kKVTile * (2 * s + 1); };

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int N = a.N;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp keeps the ring full; lane 0 issues the TMA loads,
    // every lane stages six key biases in log2 units (-inf past N: the
    // mask of the ragged edge, since TMA fills keys past N with zeros), and
    // the tile is flagged when all of them are 0 (an unmasked ViT), so the
    // consumers skip reading them
    reg_dealloc<40>();
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kTile);
      tma_load_4d(sQ, &tq, q_full, 0, h, q0, b);
    }
    const float* bias_b = a.bias + (int64_t)b * N;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      float* bs = sBias + s * kKeys;
      bool zero = true;
      for (int i = lane; i < kKeys; i += 32) {
        const int n = j * kKeys + i;
        bs[i] = n < N ? bias_b[n] * kLog2e : -INFINITY;
        zero = zero && bs[i] == 0.0f;
      }
      zero = __all_sync(0xffffffffu, zero);
      if (lane == 0) {
        sZero[s] = zero;
        mbar_arrive_expect_tx(&full[s], 2 * kKVTile);
        tma_load_4d(sK(s), &tk, &full[s], 0, h, j * kKeys, b);
        tma_load_4d(sV(s), &tv, &full[s], 0, h, j * kKeys, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  reg_alloc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint8_t* sQw = sQ + wg * (kTile / 2);
  mbar_wait(q_full, 0);
  if constexpr (kRope) {
    // q * q_scale rotated and rounded once, in place on this warpgroup's 64
    // rows: 64 x 4 chunk pairs, two a thread; rows past N (TMA's zeros)
    // stay as they are
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pair = tid + 128 * i;
      const int r = pair >> 2;
      const int c = pair & 3;
      const int n = q0 + 64 * wg + r;
      if (n < N) {
        uint4* row = reinterpret_cast<uint4*>(sQw + r * 128);
        const int lo_at = c ^ (r & 7);  // the swizzle; the partner: ^ 4
        uint4 lo = row[lo_at], hi = row[lo_at ^ 4];
        rope_pair(lo, hi, a.rope_cos + (int64_t)n * 32 + 8 * c,
                  a.rope_sin + (int64_t)n * 32 + 8 * c, a.q_scale);
        row[lo_at] = lo;
        row[lo_at ^ 4] = hi;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }
  // without RoPE: q * q_scale rounded to bf16, the TPU kernels' q *
  // bf16(scale), once on this warpgroup's half of the tile (the swizzle
  // does not matter here)
  const float qs = __bfloat162float(__float2bfloat16(a.q_scale));
  if (!kRope && qs != 1.0f) {
    uint4* chunk = reinterpret_cast<uint4*>(sQw) + tid * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint4 v = chunk[c];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * qs);
      chunk[c] = v;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }
  const uint64_t dq = desc_sw128(sQw);

  float o[32], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  uint32_t p[kKeys / 16][4];  // the previous tile's P, bf16
  // running max in log2 units, rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.0f, l1 = 0.0f;             // this thread's share of the sums

  // S = q_s K^T for the tile in stage `st`
  auto issue_s = [&](int st) {
    const uint64_t dk = desc_sw128(sK(st));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n192<0, 0>(s, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk),
                          kk > 0);
  };
  // O += P V for the tile in stage `st` (V is MN-major: transpose flag)
  auto issue_pv = [&](int st) {
    const uint64_t dv = desc_sw128(sV(st));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_n64<1>(o, p[kk], desc_add(dv, 2048 * kk));
  };
  // s becomes (s + bias) log2(e), one FFMA a score; online-softmax update
  // of m, l; s becomes exp2(s - m), the subtraction exact where s = m (so
  // a row of equal -1e9 scores gives p = 1, as the TPU kernels do); returns
  // the factors that rescale the rows' earlier sums
  auto softmax = [&](int st, float& a0, float& a1) {
    const float* bs = sBias + st * kKeys;
    const bool zero = sZero[st];
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float2 bb = zero ? make_float2(0.0f, 0.0f)
          : *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
      s[4 * j] = fmaf(s[4 * j], kLog2e, bb.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], kLog2e, bb.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], kLog2e, bb.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], kLog2e, bb.y);
      t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
      t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
    a0 = exp2_approx(m0 - ms0);  // 0 on the first tile
    a1 = exp2_approx(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[4 * j] = exp2_approx(s[4 * j] - ms0);
      s[4 * j + 1] = exp2_approx(s[4 * j + 1] - ms0);
      s[4 * j + 2] = exp2_approx(s[4 * j + 2] - ms1);
      s[4 * j + 3] = exp2_approx(s[4 * j + 3] - ms1);
      r0 += s[4 * j] + s[4 * j + 1];
      r1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  // tile 0, then for each later tile j: S_j and P_{j-1} V_{j-1} in flight
  // together, the softmax of S_j under the PV product
  float a0, a1;
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, a0, a1);
  pack_p();
  for (int j = 1; j < tiles; ++j) {
    const int st = j % kStages;
    const int prev = (j - 1) % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
      wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
      wgmma_wait<1>();
    fence_regs(s);
    softmax(st, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    release(prev);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
    pack_p();
  }
  wgmma_fence();
  issue_pv((tiles - 1) % kStages);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  release((tiles - 1) % kStages);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
  const int r0 = q0 + 64 * wg + 16 * warp + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = a.out + b * a.o_s[0] + h * a.o_s[2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.o_s[1] + col) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * a.o_s[1] + col) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if constexpr (kLse) {
    // a row whose every score was -inf (only with -inf biases) gets +inf,
    // so the backward's exp(s - lse) is 0 there and not NaN
    float* lb = a.lse + ((int64_t)b * gridDim.y + h) * N;
    if (t == 0 && r0 < N)
      lb[r0] = m0 == -INFINITY ? INFINITY : (m0 + log2f(d0)) * kLn2;
    if (t == 0 && r1 < N)
      lb[r1] = m1 == -INFINITY ? INFINITY : (m1 + log2f(d1)) * kLn2;
  }
}

template <bool kLse, bool kRope>
cudaError_t launch(FwdArgs a, int B, int H, __nv_bfloat16* k_rot,
                   cudaStream_t stream) {
  if constexpr (kRope) {
    const int64_t total = (int64_t)B * a.N * H * 4;
    fap_fwd_kernel_rope_k<<<(unsigned)((total + 255) / 256), 256, 0,
                            stream>>>(a, H, k_rot, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.k = k_rot;  // the attention kernel reads the rotated keys
    a.k_s[0] = (int64_t)a.N * H * 64;
    a.k_s[1] = (int64_t)H * 64;
    a.k_s[2] = 64;
  }
  CUtensorMap tq, tk, tv;
  if (!sm90::make_head_map(&tq, a.q, a.q_s, B, a.N, H, kRows) ||
      !sm90::make_head_map(&tk, a.k, a.k_s, B, a.N, H, kKeys) ||
      !sm90::make_head_map(&tv, a.v, a.v_s, B, a.N, H, kKeys))
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory on the current device
  const cudaError_t err = cudaFuncSetAttribute(
      fap_fwd_kernel_d64<kLse, kRope>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kRows - 1) / kRows, H, B);
  fap_fwd_kernel_d64<kLse, kRope><<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace d64

template <bool kLse>
cudaError_t launch(const FwdArgs& a, int B, int H, int D,
                   __nv_bfloat16* k_rot, cudaStream_t s) {
  if (D == 64)
    return a.rope_cos != nullptr ? d64::launch<kLse, true>(a, B, H, k_rot, s)
                                 : d64::launch<kLse, false>(a, B, H, k_rot, s);
  return d16::launch<kLse>(a, B, H, s);
}

}  // namespace

// C entry point (bound with ctypes). q, k, v and out are (B, N, H, D) bf16
// views given by their data pointers and `strides`, 12 int64 in elements:
// the (batch, token, head) strides of q, k, v, out in that order, each a
// multiple of 8, with every pointer 16-byte aligned and the D channels of a
// head contiguous. bias (B, 1, N) f32 contiguous. lse (B, H, N) f32
// contiguous, or null for the forward without LSE. rope_cos and rope_sin
// (N, D/2) f32 contiguous, or both null for the forward without RoPE; with
// them k_rot is a contiguous (B, N, H, D) bf16 scratch (two device kernels
// then: k's rotation into k_rot, the attention). Returns the cudaError_t
// of the launch; cudaErrorInvalidValue for an unsupported head dimension
// (16 and 64 are built; RoPE at 64 only), an empty shape, or (D = 64) a
// view that cuTensorMapEncodeTiled refuses.
extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* lse,
                               const void* rope_cos, const void* rope_sin,
                               void* k_rot, const long long* strides, int B,
                               int N, int H, int D, float q_scale,
                               void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || (D != 16 && D != 64))
    return (int)cudaErrorInvalidValue;
  if ((rope_cos != nullptr || rope_sin != nullptr || k_rot != nullptr) &&
      (D != 64 || rope_cos == nullptr || rope_sin == nullptr ||
       k_rot == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  for (int i = 0; i < 3; ++i) {
    a.q_s[i] = strides[i];
    a.k_s[i] = strides[3 + i];
    a.v_s[i] = strides[6 + i];
    a.o_s[i] = strides[9 + i];
  }
  a.N = N;
  a.q_scale = q_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  return (int)(lse != nullptr ? launch<true>(a, B, H, D, kr, s)
                              : launch<false>(a, B, H, D, kr, s));
}

// Dynamic shared memory of the D = 64 kernel in bytes (for build reports).
extern "C" int fa_forward_d64_smem_bytes() { return d64::kSmemBytes; }
