// Warp-level building blocks of the D = 16 attention kernels in
// flash_attention_packed.cu and flash_attention_packed_bwd.cu: mma.sync
// m16n8k16, ldmatrix (plain and transposed), movmatrix, cp.async, and the
// shared-memory layout of a tile of 16-channel rows.
//
// A tile row is one token's 16 bf16 channels, 32 bytes: two 16-byte chunks.
// ldmatrix reads eight rows of one chunk at once; at a 32-byte row stride
// rows r and r + 4 would share banks, so chunk c of row r is stored at
// chunk c ^ ((r >> 2) & 1) (row_off), and the eight rows of one read cover
// all 32 banks.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), g = lane / 4,
// t = lane % 4: an A register holds row g (or g + 8) at columns 2t, 2t + 1
// (or 8 + 2t ..); a B register column g at rows 2t, 2t + 1 (or 8 + 2t ..);
// an accumulator d[0], d[1] row g at columns 2t, 2t + 1, d[2], d[3] row
// g + 8.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma16 {

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a register times s, each rounded to bf16 (q * bf16(s))
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk c (0 or 1) of row r in a tile of 32-byte rows
__device__ __forceinline__ uint32_t row_off(int r, int c) {
  return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

// rows row0 .. row0 + 15 of a (token, 16 channels) slice at p, `stride`
// elements apart, as an A operand (rows = tokens), zero at rows past N
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* p, int64_t stride,
                                       int row0, int N, int lane) {
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c = 2 * (lane & 3);
  const __nv_bfloat16* p0 = p + r0 * stride + c;
  const __nv_bfloat16* p1 = p + r1 * stride + c;
  a[0] = r0 < N ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
  a[1] = r1 < N ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
  a[2] = r0 < N ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
  a[3] = r1 < N ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Rows 16i .. 16i + 15 of a tile at shared address `tile`, as B operands
// of two n8 products whose columns are those rows and whose reduction is
// the 16 channels (S = Q K^T: K's rows are the keys): r[0], r[1] for rows
// 16i .. + 7, r[2], r[3] for rows 16i + 8 .. + 15.
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], uint32_t tile,
                                            int i, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4(r, tile + row_off(16 * i + (lane & 7) + ((m >> 1) << 3), m & 1));
}

// The same rows as B operands of two n8 products whose reduction runs over
// the rows and whose columns are the channels (O += P V): r[0], r[1] for
// channels 0 .. 7, r[2], r[3] for channels 8 .. 15.
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], uint32_t tile,
                                            int i, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4_trans(r, tile + row_off(16 * i + (lane & 7) + ((m & 1) << 3),
                                      m >> 1));
}

// an 8 x 8 bf16 fragment transposed within the warp
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma16
