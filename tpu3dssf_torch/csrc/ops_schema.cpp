// The port's operators, tpu3dssf::*: their schemas, and nothing else.
//
// This file is the one place where the port's operators are defined: the
// seven that carry the nine TPU kernels (K1-K9) and the two of its own
// LayerNorm kernels, which replace no TPU kernel. It holds no kernel and no CUDA, so a
// host C++ compiler builds it on any machine (tpu3dssf_torch/kernels/
// _build.py, at the first import of tpu3dssf_torch.kernels), and a process
// that loads it with torch.ops.load_library (or dlopen) knows the
// operators. Their kernels are registered elsewhere:
//   * CUDA: ops_cuda.cpp (TORCH_LIBRARY_IMPL(tpu3dssf, CUDA, ...)), in the
//     library that nvcc and the host compiler build with the kernels;
//   * CPU (the plain PyTorch versions) and fake (shapes for tracers):
//     tpu3dssf_torch/kernels/ops.py, in Python.
// Where one operator serves two TPU kernels it takes the one it counts as
// its `kernel` argument (see ops.py).
//
// Beside them, tpu3dssf_host:: serves host-side sizing that the CUDA
// kernels use, on any device, so that it can be checked without a card.

#include <torch/library.h>

#include <optional>

#include "dq_scratch.h"

TORCH_LIBRARY(tpu3dssf, m) {
  // the Python module that registers the fake kernels
  m.set_python_module("tpu3dssf_torch.kernels.ops");
  // K1 (with tables its RoPE branch)
  m.def(
      "packed_attention(Tensor qkv, Tensor key_bias, SymInt heads, "
      "float? q_scale, Tensor? rope_cos, Tensor? rope_sin) -> Tensor");
  // K2, K4, or with tables K1's RoPE branch: the forward with its LSE
  m.def(
      "packed_attention_lse(Tensor qkv, Tensor key_bias, SymInt heads, "
      "float? q_scale, Tensor? rope_cos, Tensor? rope_sin, str kernel) -> "
      "(Tensor, Tensor)");
  // K3, K5
  m.def(
      "packed_attention_bwd(Tensor qkv, Tensor key_bias, Tensor dout, "
      "Tensor lse, Tensor delta, SymInt heads, float? q_scale, str kernel) "
      "-> Tensor");
  // K6, K8
  m.def(
      "attention(Tensor q, Tensor k, Tensor v, Tensor key_bias, "
      "Tensor? key_mask, str kernel) -> Tensor");
  // K4, K8 with the LSE
  m.def(
      "attention_lse(Tensor q, Tensor k, Tensor v, Tensor key_bias, "
      "float q_scale, str kernel) -> (Tensor, Tensor)");
  // K5, K9
  m.def(
      "attention_bwd(Tensor q, Tensor k, Tensor v, Tensor key_bias, "
      "Tensor dout, Tensor lse, Tensor delta, float q_scale, str kernel) "
      "-> (Tensor, Tensor, Tensor)");
  // K7
  m.def(
      "knn(Tensor queries, Tensor refs, Tensor ref_mask, SymInt k) -> "
      "(Tensor, Tensor)");
  // LayerNorm over the last dimension of (rows, C): (y, mean, rstd)
  m.def(
      "layer_norm(Tensor x, Tensor weight, Tensor bias, float eps) -> "
      "(Tensor, Tensor, Tensor)");
  // its gradient: (dx, dweight, dbias)
  m.def(
      "layer_norm_bwd(Tensor dy, Tensor x, Tensor weight, Tensor mean, "
      "Tensor rstd) -> (Tensor, Tensor, Tensor)");
}

namespace {

// dq_scratch.h's scratch on `device` (None where the kernel takes none)
std::optional<at::Tensor> dq_scratch(int64_t B, int64_t N, int64_t H,
                                     int64_t D, int64_t block_keys,
                                     c10::Device device) {
  at::Tensor x = tpu3dssf::dq_scratch(B, N, H, D, block_keys,
                                      at::TensorOptions().device(device));
  if (!x.defined()) return std::nullopt;
  return x;
}

}  // namespace

TORCH_LIBRARY(tpu3dssf_host, m) {
  // the attention backward's dq scratch for q of shape (B, N, H, D), with
  // the D = 16 kernel's key block of block_keys keys
  m.def(
      "dq_scratch(int B, int N, int H, int D, int block_keys, Device device) "
      "-> Tensor?",
      &dq_scratch);
}
