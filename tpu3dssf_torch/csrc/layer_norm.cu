// LayerNorm over the last dimension of a (rows, C) tensor, bf16 or f32, and
// its gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's LayerNorm to XLA,
// which fuses the f32 statistics, the affine map and the casts around them
// into its neighbours. The port ran it as three kernels (the input cast to
// f32, torch's LayerNorm, the cast back), 20 bytes an element where 4 do.
//
// Semantics (flax LayerNorm, tpu3dssf_torch/models/layers.py): the mean and
// the biased variance of each row in f32, y = (x - mean) * rstd * w + b in
// f32 with rstd = 1 / sqrt(var + eps), rounded once to x's type; mean and
// rstd are returned in f32 for the gradient. A row of zeros (padding) gives
// b. The gradient, with xh = (x - mean) * rstd and g = dy * w:
//   dx = rstd * (g - mean_C(g) - xh * mean_C(g * xh)), rounded once,
//   dw = sum over rows of dy * xh, db = sum over rows of dy (f32).
//
// What bounds it. A few operations an element against 4 bytes (bf16 in and
// out; the backward 6), so the bytes: at 3.35 TB/s an eval batch's 57 PTv3
// norms take about 0.4 ms. torch's kernel gives a thread block to every row
// and reduces across the block twice; PTv3's rows are 32 to 512 wide, so a
// batch is hundreds of thousands of tiny blocks far from that bound.
//
// What the design does about it:
// * a group of G lanes owns a row, each lane moving 8 elements at a time
//   (16 bytes of bf16), neighbouring lanes on neighbouring addresses:
//   G = C / 8 rounded up to a power of two up to 32 (4 at C = 32, 32 at
//   C = 256), so a warp holds 32 / G rows; past C = 256 a warp owns a row
//   and each lane CHUNKS = C / 256 (rounded up) runs of 8, up to C = 1024
//   (ViT-L's width, the widest in the port). G and CHUNKS follow from C
//   alone;
// * the row stays in registers: the mean, then the sum of squared
//   deviations (two passes over registers, not one over memory), each by a
//   butterfly of shuffles within the group, which gives every lane of the
//   group the same bits;
// * the backward's dw and db are summed without atomics, in an order fixed
//   by rows and C alone, so a step is the same bits every launch, graphed
//   or eager: each block of layer_norm_bwd_kernel owns a fixed run of rows
//   and writes one f32 partial row of each into a (blocks, C) scratch
//   (lanes sum their rows in order, then the groups of a warp by
//   shuffles, then the warps in warp order through shared memory);
//   layer_norm_bwd_sum_kernel sums the partials in block order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 8;         // elements a lane moves at once
constexpr int kWarps = 8;       // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 4;   // C <= 32 lanes * 4 chunks * 8 = 1024
constexpr int kBwdBlocks = 512; // the backward's blocks at most
constexpr int kSumRows = 8;     // partial rows a thread column of the sum

template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[kVec]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[kVec]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[kVec]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// the sum over the G lanes of a group (aligned runs of G lanes); every lane
// of the group gets the same bits (f32 addition commutes exactly)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the first column of a lane's chunk j
template <int G>
__device__ __forceinline__ int column(int j, int sub) {
  return (j * G + sub) * kVec;
}

template <typename T, int G, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, long long rows, int C,
                          float eps) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31, sub = lane % G;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          kRowsPerWarp +
      lane / G;
  // no lane leaves early: the shuffles take the whole warp
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * C;
  float v[CHUNKS][kVec];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = column<G>(j, sub);
    if (live && c < C) {
      Io<T>::load(xr + c, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum += v[j][i];
  }
  const float mean = group_sum<G>(sum) / static_cast<float>(C);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    if (column<G>(j, sub) < C) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float d = v[j][i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd =
      rsqrtf(group_sum<G>(sq) / static_cast<float>(C) + eps);
  if (!live) return;
  T* yr = y + row * C;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = column<G>(j, sub);
    if (c >= C) continue;
    float wv[kVec], bv[kVec], out[kVec];
    Io<float>::load(w + c, wv);
    Io<float>::load(b + c, bv);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out[i] = (v[j][i] - mean) * rstd * wv[i] + bv[i];
    Io<T>::store(yr + c, out);
  }
  if (sub == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int G, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          float* __restrict__ part_w,
                          float* __restrict__ part_b, long long rows, int C,
                          long long rows_per_block) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kRowsPerStep = kWarps * kRowsPerWarp;
  extern __shared__ float shared[];  // [2][C]: the block's dw and db
  const int lane = threadIdx.x & 31, sub = lane % G, warp = threadIdx.x / 32;
  const long long first = blockIdx.x * rows_per_block;
  const long long end =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  float acc_w[CHUNKS][kVec], acc_b[CHUNKS][kVec];
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc_w[j][i] = acc_b[j][i] = 0.f;

  for (long long base = first; base < end; base += kRowsPerStep) {
    const long long row = base + warp * kRowsPerWarp + lane / G;
    const bool live = row < end;
    const long long at = (live ? row : 0) * C;
    const float m = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float xh[CHUNKS][kVec], g[CHUNKS][kVec];
    float s_gx = 0.f, s_g = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = column<G>(j, sub);
      float dv[kVec], wv[kVec];
      if (live && c < C) {
        Io<T>::load(x + at + c, xh[j]);
        Io<T>::load(dy + at + c, dv);
        Io<float>::load(w + c, wv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) xh[j][i] = dv[i] = wv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xh[j][i] = (xh[j][i] - m) * rs;
        g[j][i] = dv[i] * wv[i];
        s_gx += g[j][i] * xh[j][i];
        s_g += g[j][i];
        acc_w[j][i] += dv[i] * xh[j][i];
        acc_b[j][i] += dv[i];
      }
    }
    const float c1 = group_sum<G>(s_gx) / static_cast<float>(C);
    const float c2 = group_sum<G>(s_g) / static_cast<float>(C);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = column<G>(j, sub);
      if (c >= C) continue;
      float out[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        out[i] = rs * (g[j][i] - c2 - xh[j][i] * c1);
      Io<T>::store(dx + at + c, out);
    }
  }
  // the groups of a warp hold the same columns: sum them
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc_w[j][i] += __shfl_xor_sync(0xffffffffu, acc_w[j][i], off);
        acc_b[j][i] += __shfl_xor_sync(0xffffffffu, acc_b[j][i], off);
      }
  }
  // then the warps, in warp order
  float* sw = shared;
  float* sb = shared + C;
  for (int turn = 0; turn < kWarps; ++turn) {
    if (warp == turn && lane < G) {
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const int c = column<G>(j, sub);
        if (c >= C) continue;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          sw[c + i] = turn ? sw[c + i] + acc_w[j][i] : acc_w[j][i];
          sb[c + i] = turn ? sb[c + i] + acc_b[j][i] : acc_b[j][i];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    part_w[static_cast<long long>(blockIdx.x) * C + c] = sw[c];
    part_b[static_cast<long long>(blockIdx.x) * C + c] = sb[c];
  }
}

// dw[c] and db[c]: the partials of column c summed in block order, in
// kSumRows interleaved runs (thread row t takes blocks t, t + kSumRows, ...)
// that are then added in run order. Block (32, kSumRows) a tile of 32
// columns.
__global__ void __launch_bounds__(32 * kSumRows)
    layer_norm_bwd_sum_kernel(const float* __restrict__ part_w,
                              const float* __restrict__ part_b,
                              float* __restrict__ dw, float* __restrict__ db,
                              int blocks, int C) {
  __shared__ float sw[kSumRows][32], sb[kSumRows][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float aw = 0.f, ab = 0.f;
  if (c < C) {
    for (int k = threadIdx.y; k < blocks; k += kSumRows) {
      aw += part_w[static_cast<long long>(k) * C + c];
      ab += part_b[static_cast<long long>(k) * C + c];
    }
  }
  sw[threadIdx.y][threadIdx.x] = aw;
  sb[threadIdx.y][threadIdx.x] = ab;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int t = 1; t < kSumRows; ++t) {
      aw += sw[t][threadIdx.x];
      ab += sb[t][threadIdx.x];
    }
    dw[c] = aw;
    db[c] = ab;
  }
}

// the lanes a row (G) and the runs of 8 a lane (CHUNKS) for C, or false
// where C is no multiple of 8, under 16 or above 1024
bool shape_of(int C, int* G, int* chunks) {
  if (C < 2 * kVec || C % kVec || C > 32 * kMaxChunks * kVec) return false;
  const int vecs = C / kVec;
  int g = 1;
  while (g < vecs && g < 32) g *= 2;
  *G = g;
  *chunks = (vecs + g - 1) / g;
  return true;
}

long long rows_per_step(int G) { return kWarps * (32 / G); }

template <typename T, int G, int CHUNKS>
void launch_fwd(const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, long long rows, int C, float eps,
                cudaStream_t stream) {
  const long long blocks = (rows + rows_per_step(G) - 1) / rows_per_step(G);
  layer_norm_fwd_kernel<T, G, CHUNKS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, C, eps);
}

template <typename T, int G, int CHUNKS>
void launch_bwd(const void* dy, const void* x, const void* w,
                const void* mean, const void* rstd, void* dx, void* part_w,
                void* part_b, long long rows, int C, long long blocks,
                long long per_block, cudaStream_t stream) {
  layer_norm_bwd_kernel<T, G, CHUNKS>
      <<<blocks, kThreads, 2 * C * sizeof(float), stream>>>(
          static_cast<const T*>(dy), static_cast<const T*>(x),
          static_cast<const float*>(w), static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<T*>(dx),
          static_cast<float*>(part_w), static_cast<float*>(part_b), rows, C,
          per_block);
}

// Calls Launch::template run<G, CHUNKS>() for C's G and CHUNKS.
template <typename Launch>
void dispatch(int G, int chunks, Launch&& launch) {
  switch (G) {
    case 2: return launch.template run<2, 1>();
    case 4: return launch.template run<4, 1>();
    case 8: return launch.template run<8, 1>();
    case 16: return launch.template run<16, 1>();
  }
  switch (chunks) {
    case 1: return launch.template run<32, 1>();
    case 2: return launch.template run<32, 2>();
    case 3: return launch.template run<32, 3>();
    default: return launch.template run<32, 4>();
  }
}

template <typename T>
struct Fwd {
  const void *x, *w, *b;
  void *y, *mean, *rstd;
  long long rows;
  int C;
  float eps;
  cudaStream_t stream;
  template <int G, int CHUNKS>
  void run() {
    launch_fwd<T, G, CHUNKS>(x, w, b, y, mean, rstd, rows, C, eps, stream);
  }
};

template <typename T>
struct Bwd {
  const void *dy, *x, *w, *mean, *rstd;
  void *dx, *part_w, *part_b;
  long long rows;
  int C;
  long long blocks, per_block;
  cudaStream_t stream;
  template <int G, int CHUNKS>
  void run() {
    launch_bwd<T, G, CHUNKS>(dy, x, w, mean, rstd, dx, part_w, part_b, rows,
                             C, blocks, per_block, stream);
  }
};

}  // namespace

extern "C" {

// The backward's split of `rows` rows of width C into blocks, into
// plan[0..1]: the blocks (each one f32 partial row of dw and of db in the
// caller's (blocks, C) scratch) and the rows a block owns (a multiple of
// the rows a block takes at a time). It depends on rows and C alone.
// Returns the cudaError_t (cudaErrorInvalidValue for a C no multiple of 8,
// under 16 or above 1024, or rows < 0).
int layer_norm_bwd_plan(long long rows, int C, long long* plan) {
  int G, chunks;
  if (!shape_of(C, &G, &chunks) || rows < 0) return cudaErrorInvalidValue;
  const long long step = rows_per_step(G);
  const long long per = (rows + kBwdBlocks - 1) / kBwdBlocks;
  const long long per_block = per < step ? step : (per + step - 1) / step * step;
  plan[0] = (rows + per_block - 1) / per_block;
  plan[1] = per_block;
  return cudaSuccess;
}

// x (rows, C) bf16 (bf16 = 1) or f32, w and b (C,) f32, all contiguous,
// 16-byte aligned, on the current device; writes y (rows, C) in x's type
// and mean, rstd (rows,) f32. Returns the launch's cudaError_t.
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, long long rows, int C, float eps,
                   int bf16, void* stream) {
  int G, chunks;
  if (!shape_of(C, &G, &chunks) || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch(G, chunks, Fwd<__nv_bfloat16>{x, w, b, y, mean, rstd, rows, C,
                                            eps, s});
  else
    dispatch(G, chunks, Fwd<float>{x, w, b, y, mean, rstd, rows, C, eps, s});
  return static_cast<int>(cudaGetLastError());
}

// dy and x (rows, C) bf16 (bf16 = 1) or f32, w (C,), mean and rstd
// (rows,) f32 (the forward's), contiguous and 16-byte aligned on the
// current device; writes dx (rows, C) in x's type and dw, db (C,) f32,
// through the caller's part_w and part_b scratch of layer_norm_bwd_plan's
// plan[0] x C f32 each. Two launches: the rows, then the sum of the
// partials. Returns their cudaError_t.
int layer_norm_bwd(const void* dy, const void* x, const void* w,
                   const void* mean, const void* rstd, void* dx, void* dw,
                   void* db, void* part_w, void* part_b, long long rows, int C,
                   int bf16, void* stream) {
  long long plan[2];
  int G, chunks;
  if (layer_norm_bwd_plan(rows, C, plan) != cudaSuccess ||
      !shape_of(C, &G, &chunks))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (bf16)
      dispatch(G, chunks, Bwd<__nv_bfloat16>{dy, x, w, mean, rstd, dx, part_w,
                                             part_b, rows, C, plan[0],
                                             plan[1], s});
    else
      dispatch(G, chunks, Bwd<float>{dy, x, w, mean, rstd, dx, part_w, part_b,
                                     rows, C, plan[0], plan[1], s});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layer_norm_bwd_sum_kernel<<<(C + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<int>(plan[0]), C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
