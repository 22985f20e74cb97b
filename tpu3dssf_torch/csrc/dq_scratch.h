// The f32 scratch that the attention backward (fa_backward_bf16,
// flash_attention_packed_bwd.cu) sums dq in, sized from the problem alone.
//
// Shared by ops_cuda.cpp, whose backward kernels allocate it on the card,
// and ops_schema.cpp, which serves the same function on any device as
// tpu3dssf_host::dq_scratch, so a machine without a card can check the
// sizing.

#pragma once

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>

#include <cstdint>

namespace tpu3dssf {

// the largest N of the D = 16 backward's one-warp kernel (kSmallN in
// flash_attention_packed_bwd.cu)
constexpr int64_t kD16SmallN = 64;

// The scratch for q of shape (B, N, H, D): at D = 64 a zeroed (B, H, N
// rounded up to 64, 64) tensor that the kernel's atomics sum into; at
// D = 16, past one key block of `block_keys` keys, one partial per block,
// (B, H, blocks, N, 16), summed in block order by a second kernel; else
// none (an undefined tensor).
inline at::Tensor dq_scratch(int64_t B, int64_t N, int64_t H, int64_t D,
                             int64_t block_keys,
                             const at::TensorOptions& options) {
  const auto f32 = options.dtype(at::kFloat);
  if (D == 64) return at::zeros({B, H, (N + 63) / 64 * 64, 64}, f32);
  const int64_t blocks =
      N > kD16SmallN ? (N + block_keys - 1) / block_keys : 1;
  if (blocks == 1) return at::Tensor();
  return at::empty({B, H, blocks, N, 16}, f32);
}

}  // namespace tpu3dssf
