// The CUDA kernels of the tpu3dssf:: operators (ops_schema.cpp defines
// them), and the launch counters of the nine TPU kernels they serve and of
// the port's own LayerNorm kernels (LN, its gradient LNB).
//
// Each kernel checks the contract of the Hopper kernel it launches and
// raises through TORCH_CHECK on a breach, before anything is allocated,
// launched or counted; it takes its outputs and scratch from PyTorch's
// allocator on the inputs' card, launches the kernel's C entry point on
// PyTorch's current stream of that card, raises where the launch returns
// an error, and then adds one to the counter of the kernel it served.
// Nothing falls back to a plain version. The entry points:
//   * fa_forward_bf16 (flash_attention_packed.cu): K1 (and its RoPE
//     branch), K2, K4, K6, K8;
//   * fa_backward_bf16 (flash_attention_packed_bwd.cu): K3, K5, K9;
//   * knn_plan and knn_f32 (knn.cu): K7;
//   * layer_norm_fwd, layer_norm_bwd_plan and layer_norm_bwd
//     (layer_norm.cu): LN, LNB.
// q, k, v, the output and the gradients go to them as separate pointers
// with their (batch, token, head) strides, so the packed (B, N, 3C) layout
// is one stride set and (B, N, H, D) views are others: nothing is repacked.
//
// The counters are read and written by the operators of tpu3dssf_cuda::
// (Python: tpu3dssf_torch.kernels.modules) and by the C functions
// tpu3dssf_read_launch_counts / tpu3dssf_write_launch_counts (a process
// without Python, such as aoti_runner).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <string>
#include <type_traits>
#include <vector>

#include "dq_scratch.h"

extern "C" {
int fa_forward_bf16(const void* q, const void* k, const void* v,
                    const void* bias, void* out, void* lse,
                    const void* rope_cos, const void* rope_sin, void* k_rot,
                    const long long* strides, int B, int N, int H, int D,
                    float q_scale, void* stream);
int fa_backward_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* bias, const void* lse,
                     const void* delta, void* dq, void* dk, void* dv,
                     void* dq_scratch, const long long* strides, int B, int N,
                     int H, int D, float q_scale, void* stream);
int fa_forward_d64_smem_bytes();
int fa_backward_d64_smem_bytes();
int fa_backward_d16_block_keys();
int knn_plan(int B, int Q, int R, int k, long long* out);
int knn_f32(const void* queries, const void* refs, const void* ref_mask,
            void* out_d, void* out_i, void* packed, void* unfoldable,
            void* part_d, void* part_i, int B, int Q, int R, int k,
            int blocks, long long partial, void* stream);
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, long long rows, int C, float eps,
                   int bf16, void* stream);
int layer_norm_bwd_plan(long long rows, int C, long long* plan);
int layer_norm_bwd(const void* dy, const void* x, const void* w,
                   const void* mean, const void* rstd, void* dx, void* dw,
                   void* db, void* part_w, void* part_b, long long rows, int C,
                   int bf16, void* stream);
}

namespace {

using at::Tensor;

// the counters, in the order of launch_counts(): the TPU kernels, then the
// port's own
constexpr const char* kCounters[] = {"K1", "K2", "K3", "K4", "K5", "K6",
                                     "K7", "K8", "K9", "LN", "LNB"};
constexpr int kKernels = sizeof(kCounters) / sizeof(kCounters[0]);
std::atomic<int64_t> g_launches[kKernels];

constexpr int kMaxK = 8;  // knn's largest k (knn.cu)
constexpr const char* kPacked = "flash_attention_packed";

void count(const std::string& kernel) {
  for (int i = 0; i < kKernels; ++i)
    if (kernel == kCounters[i]) g_launches[i]++;
}

// Error messages are put together as strings, with no stream: built with
// g++ 13 against torch 2.11 on an H100 host, an integer inserted into a
// std::ostream in this library crashed the process (SIGSEGV), while
// strings took the same path without fault.
std::string shape(at::IntArrayRef s) {
  std::string out = "(";
  for (size_t i = 0; i < s.size(); ++i)
    out += (i ? ", " : "") + std::to_string(s[i]);
  return out + (s.size() == 1 ? ",)" : ")");
}

std::string text(const char* s) { return s; }
std::string text(const std::string& s) { return s; }
std::string text(const c10::Device& d) { return d.str(); }
std::string text(at::ScalarType t) { return c10::toString(t); }
template <typename T, std::enable_if_t<std::is_integral_v<T>, int> = 0>
std::string text(T v) {
  return std::to_string(v);
}

// the message of a failed check, from its pieces
template <typename... Args>
std::string cat(const Args&... args) {
  std::string out;
  ((out += text(args)), ...);
  return out;
}

// the TPU kernel the call serves: one of `allowed`
void check_kernel(const char* op, const std::string& kernel,
                  std::initializer_list<const char*> allowed) {
  std::string names;
  for (const char* a : allowed) {
    if (kernel == a) return;
    names += std::string(names.empty() ? "" : ", ") + a;
  }
  TORCH_CHECK(false,
              cat("tpu3dssf::", op, ": kernel must be one of (", names,
                  "), got '", kernel, "'"));
}

// the wrapper that a (B, N, H, D) kernel serves, as the errors name it
const char* caller(const std::string& kernel) {
  return (kernel == "K8" || kernel == "K9") ? "flash_attention"
                                            : "window_attention";
}

std::string layout_error(const char* name, const Tensor& x) {
  return std::string(name) +
         ": each head's D channels must be contiguous, with 16-byte-aligned "
         "rows and strides a multiple of 8, got strides " +
         shape(x.strides());
}

// The kernels' contract on (B, N, H, D) views: bf16, one shape and card,
// each head's D channels contiguous, strides a multiple of 8 elements and
// 16-byte-aligned data, D in {16, 64}, and a contiguous f32 (B, 1, N) key
// bias on the same card.
void check_views(const char* name, std::initializer_list<Tensor> views,
                 const Tensor& key_bias) {
  const Tensor& q = *views.begin();
  for (const Tensor& x : views) {
    TORCH_CHECK(x.scalar_type() == at::kBFloat16,
                cat(name, ": the CUDA kernel takes bfloat16 tensors, got ",
                    x.scalar_type()));
    TORCH_CHECK(x.dim() == 4 && x.sizes() == q.sizes() &&
                    x.device() == q.device(),
                cat(name, ": every tensor must be (B, N, H, D) = ",
                    shape(q.sizes()), " on ", q.device(), ", got ",
                    shape(x.sizes()), " on ", x.device()));
    TORCH_CHECK(x.device().is_cuda(),
                cat(name, ": no kernel for device ", x.device()));
    TORCH_CHECK(x.stride(3) == 1 && x.stride(0) % 8 == 0 &&
                    x.stride(1) % 8 == 0 && x.stride(2) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
                cat(layout_error(name, x)));
  }
  const int64_t B = q.size(0), N = q.size(1), D = q.size(3);
  TORCH_CHECK(D == 16 || D == 64,
              cat(name, ": head dim ", D, " must be one of (16, 64)"));
  TORCH_CHECK(key_bias.device() == q.device() &&
                  key_bias.scalar_type() == at::kFloat &&
                  key_bias.sizes() == at::IntArrayRef({B, 1, N}) &&
                  key_bias.is_contiguous(),
              cat(name, ": key_bias must be a contiguous float32 (B, 1, N) = ",
                  shape({B, 1, N}), " tensor on ", q.device(), ", got ",
                  key_bias.scalar_type(), " ", shape(key_bias.sizes()), " on ",
                  key_bias.device()));
}

// RoPE in the kernel: D = 64 and contiguous, 16-byte-aligned (N, D/2) f32
// tables on q's card.
void check_rope(const char* name, const Tensor& q, const Tensor& cos,
                const Tensor& sin) {
  const int64_t N = q.size(1), D = q.size(3);
  TORCH_CHECK(D == 64,
              cat(name, ": RoPE in the kernel is built for head dim 64 only, "
                  "got ", D, " (the plain version takes any D)"));
  for (const Tensor& x : {cos, sin}) {
    TORCH_CHECK(x.device() == q.device() && x.scalar_type() == at::kFloat &&
                    x.sizes() == at::IntArrayRef({N, D / 2}) &&
                    x.is_contiguous() &&
                    reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
                cat(name, ": rope_cos/rope_sin must be contiguous float32 ",
                    shape({N, D / 2}), " tables on ", q.device(), ", got ",
                    x.scalar_type(), " ", shape(x.sizes()), " on ",
                    x.device()));
  }
}

void check_stats(const char* name, const Tensor& q, const Tensor& lse,
                 const Tensor& delta) {
  const int64_t B = q.size(0), N = q.size(1), H = q.size(2);
  auto check = [&](const char* what, const Tensor& x) {
    TORCH_CHECK(x.device() == q.device() && x.scalar_type() == at::kFloat &&
                    x.sizes() == at::IntArrayRef({B, H, N}) &&
                    x.is_contiguous(),
                cat(name, " backward: ", what, " must be a contiguous float32 ",
                    shape({B, H, N}), " tensor on ", q.device(), ", got ",
                    x.scalar_type(), " ", shape(x.sizes()), " on ",
                    x.device()));
  };
  check("lse", lse);
  check("delta", delta);
}

// The packed layout: a contiguous (B, N, 3C) qkv with C / heads an integer.
void check_packed(const Tensor& qkv, int64_t heads) {
  TORCH_CHECK(qkv.dim() == 3 && qkv.size(2) % 3 == 0,
              cat(kPacked, ": qkv must be (B, N, 3C), got ",
                  shape(qkv.sizes())));
  const int64_t C = qkv.size(2) / 3;
  TORCH_CHECK(heads > 0 && C % heads == 0,
              cat(kPacked, ": head dim C/heads = ", C, "/", heads, " is not "
                  "an integer"));
  TORCH_CHECK(qkv.is_contiguous(),
              cat(kPacked, ": qkv must be contiguous"));
}

// q, k, v of a (B, N, 3C) projection as (B, N, H, D) views
std::vector<Tensor> split_heads(const Tensor& qkv, int64_t heads) {
  const int64_t C = qkv.size(2) / 3;
  std::vector<Tensor> out;
  for (int64_t i = 0; i < 3; ++i)
    out.push_back(qkv.narrow(2, i * C, C).unflatten(2, {heads, C / heads}));
  return out;
}

void push_strides(std::vector<long long>& s, const Tensor& x) {
  for (int i = 0; i < 3; ++i) s.push_back(x.stride(i));
}

void* stream_of(const Tensor& x) {
  return c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
}

void check_launch(int err, const char* name, const char* what,
                  const Tensor& q) {
  TORCH_CHECK(err == 0,
              cat(name, ": ", what, " kernel launch failed with cudaError_t ",
                  err, " (B=", q.size(0), ", N=", q.size(1), ", H=", q.size(2),
                  ", D=", q.size(3), ")"));
}

// The forward kernel on (B, N, H, D) views: out (B, N, H, D) bf16 and,
// with `with_lse`, lse (B, H, N) f32. With tables (D = 64) the kernel
// rotates q in its Q pass and k once into a (B, N, H, D) scratch.
std::pair<Tensor, Tensor> forward(const char* name, const Tensor& q,
                                  const Tensor& k, const Tensor& v,
                                  const Tensor& key_bias, double q_scale,
                                  bool with_lse,
                                  const std::optional<Tensor>& cos,
                                  const std::optional<Tensor>& sin) {
  check_views(name, {q, k, v}, key_bias);
  TORCH_CHECK(cos.has_value() == sin.has_value(),
              cat(kPacked, ": pass both rope_cos and rope_sin, or neither"));
  if (cos) check_rope(name, q, *cos, *sin);
  const int64_t B = q.size(0), N = q.size(1), H = q.size(2), D = q.size(3);
  c10::cuda::CUDAGuard guard(q.device());
  Tensor out = at::empty({B, N, H, D}, q.options());
  Tensor lse = with_lse ? at::empty({B, H, N}, q.options().dtype(at::kFloat))
                        : Tensor();
  Tensor k_rot = cos ? at::empty_like(out) : Tensor();
  std::vector<long long> strides;
  for (const Tensor& x : {q, k, v, out}) push_strides(strides, x);
  const int err = fa_forward_bf16(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
      out.data_ptr(), with_lse ? lse.data_ptr() : nullptr,
      cos ? cos->data_ptr() : nullptr, sin ? sin->data_ptr() : nullptr,
      cos ? k_rot.data_ptr() : nullptr, strides.data(), B, N, H, D,
      static_cast<float>(q_scale), stream_of(q));
  check_launch(err, name, with_lse ? "forward-with-LSE" : "forward", q);
  return {out, lse};
}

// The backward kernel's f32 scratch for dq (dq_scratch.h), on q's card.
Tensor dq_scratch(const Tensor& q) {
  return tpu3dssf::dq_scratch(q.size(0), q.size(1), q.size(2), q.size(3),
                              fa_backward_d16_block_keys(), q.options());
}

// The backward kernel on (B, N, H, D) views into dq, dk, dv (views too).
void backward(const char* name, const Tensor& q, const Tensor& k,
              const Tensor& v, const Tensor& key_bias, const Tensor& dout,
              const Tensor& lse, const Tensor& delta, double q_scale,
              const Tensor& dq, const Tensor& dk, const Tensor& dv) {
  const int64_t B = q.size(0), N = q.size(1), H = q.size(2), D = q.size(3);
  c10::cuda::CUDAGuard guard(q.device());
  Tensor scratch = dq_scratch(q);
  std::vector<long long> strides;
  for (const Tensor& x : {q, k, v, dout, dq, dk, dv})
    push_strides(strides, x);
  const int err = fa_backward_bf16(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      key_bias.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
      dk.data_ptr(), dv.data_ptr(),
      scratch.defined() ? scratch.data_ptr() : nullptr, strides.data(), B, N,
      H, D, static_cast<float>(q_scale), stream_of(q));
  check_launch(err, name, "backward", q);
}

double scale_or_one(const std::optional<double>& q_scale) {
  return q_scale.has_value() ? *q_scale : 1.0;
}

// --- the operators' CUDA kernels --------------------------------------------

Tensor packed_attention(const Tensor& qkv, const Tensor& key_bias,
                        c10::SymInt heads_, std::optional<double> q_scale,
                        const std::optional<Tensor>& rope_cos,
                        const std::optional<Tensor>& rope_sin) {
  const int64_t heads = heads_.expect_int();
  check_packed(qkv, heads);
  auto v = split_heads(qkv, heads);
  Tensor out = forward(kPacked, v[0], v[1], v[2], key_bias,
                       scale_or_one(q_scale), false, rope_cos, rope_sin)
                   .first;
  count("K1");
  return out.flatten(2);
}

std::tuple<Tensor, Tensor> packed_attention_lse(
    const Tensor& qkv, const Tensor& key_bias, c10::SymInt heads_,
    std::optional<double> q_scale, const std::optional<Tensor>& rope_cos,
    const std::optional<Tensor>& rope_sin, c10::string_view kernel_) {
  const std::string kernel(kernel_.data(), kernel_.size());
  check_kernel("packed_attention_lse", kernel, {"K1", "K2", "K4"});
  TORCH_CHECK((kernel == "K1") == rope_cos.has_value(),
              cat("tpu3dssf::packed_attention_lse: K1 is the RoPE branch "
                  "(tables given); K2 and K4 take no tables"));
  const int64_t heads = heads_.expect_int();
  check_packed(qkv, heads);
  auto v = split_heads(qkv, heads);
  auto [out, lse] = forward(kPacked, v[0], v[1], v[2], key_bias,
                            scale_or_one(q_scale), true, rope_cos, rope_sin);
  count(kernel);
  return {out.flatten(2), lse};
}

Tensor packed_attention_bwd(const Tensor& qkv, const Tensor& key_bias,
                            const Tensor& dout, const Tensor& lse,
                            const Tensor& delta, c10::SymInt heads_,
                            std::optional<double> q_scale,
                            c10::string_view kernel_) {
  const std::string kernel(kernel_.data(), kernel_.size());
  check_kernel("packed_attention_bwd", kernel, {"K3", "K5"});
  const int64_t heads = heads_.expect_int();
  check_packed(qkv, heads);
  auto v = split_heads(qkv, heads);
  Tensor dout4 = dout.contiguous().unflatten(-1, {heads, -1});
  check_views(kPacked, {v[0], v[1], v[2], dout4}, key_bias);
  check_stats(kPacked, v[0], lse, delta);
  Tensor dqkv = at::empty_like(qkv);
  auto g = split_heads(dqkv, heads);
  backward(kPacked, v[0], v[1], v[2], key_bias, dout4, lse, delta,
           scale_or_one(q_scale), g[0], g[1], g[2]);
  count(kernel);
  return dqkv;
}

Tensor attention(const Tensor& q, const Tensor& k, const Tensor& v,
                 const Tensor& key_bias, const std::optional<Tensor>& key_mask,
                 c10::string_view kernel_) {
  const std::string kernel(kernel_.data(), kernel_.size());
  check_kernel("attention", kernel, {"K6", "K8"});
  TORCH_CHECK((kernel == "K6") == key_mask.has_value(),
              cat("tpu3dssf::attention: K6 (the window route) takes the key "
                  "mask, K8 none"));
  Tensor out = forward(caller(kernel), q, k, v, key_bias,
                       1.0 / std::sqrt(static_cast<double>(q.size(3))),
                       false, std::nullopt, std::nullopt)
                   .first;
  count(kernel);
  if (key_mask) {  // K6 zeroes the masked query rows
    out = out.mul(key_mask->reshape({q.size(0), q.size(1), 1, 1})
                      .to(out.scalar_type()));
  }
  return out;
}

std::tuple<Tensor, Tensor> attention_lse(const Tensor& q, const Tensor& k,
                                         const Tensor& v,
                                         const Tensor& key_bias,
                                         double q_scale,
                                         c10::string_view kernel_) {
  const std::string kernel(kernel_.data(), kernel_.size());
  check_kernel("attention_lse", kernel, {"K4", "K8"});
  auto [out, lse] = forward(caller(kernel), q, k, v, key_bias, q_scale, true,
                            std::nullopt, std::nullopt);
  count(kernel);
  return {out, lse};
}

std::tuple<Tensor, Tensor, Tensor> attention_bwd(
    const Tensor& q, const Tensor& k, const Tensor& v, const Tensor& key_bias,
    const Tensor& dout, const Tensor& lse, const Tensor& delta,
    double q_scale, c10::string_view kernel_) {
  const std::string kernel(kernel_.data(), kernel_.size());
  check_kernel("attention_bwd", kernel, {"K5", "K9"});
  const char* name = caller(kernel);
  Tensor d = dout.contiguous();
  check_views(name, {q, k, v, d}, key_bias);
  check_stats(name, q, lse, delta);
  auto opts = q.options().memory_format(at::MemoryFormat::Contiguous);
  Tensor dq = at::empty(q.sizes(), opts), dk = at::empty(q.sizes(), opts),
         dv = at::empty(q.sizes(), opts);
  backward(name, q, k, v, key_bias, d, lse, delta, q_scale, dq, dk, dv);
  count(kernel);
  return {dq, dk, dv};
}

// K7's contract: (B, Q, 3) and (B, R, 3) f32 on one card, a (B, R) bool
// mask, 1 <= k <= min(8, R), non-empty shapes.
void check_knn(const Tensor& queries, const Tensor& refs,
               const Tensor& ref_mask, int64_t k) {
  TORCH_CHECK(queries.dim() == 3 && queries.size(2) == 3 && refs.dim() == 3 &&
                  refs.size(2) == 3 && refs.size(0) == queries.size(0),
              cat("knn: queries (B, Q, 3) and refs (B, R, 3), got ",
                  shape(queries.sizes()), " and ", shape(refs.sizes())));
  const int64_t B = refs.size(0), R = refs.size(1);
  TORCH_CHECK(ref_mask.sizes() == at::IntArrayRef({B, R}) &&
                  ref_mask.scalar_type() == at::kBool,
              cat("knn: ref_mask must be bool (B, R) = ", shape({B, R}),
                  ", got ", ref_mask.scalar_type(), " ",
                  shape(ref_mask.sizes())));
  TORCH_CHECK(queries.scalar_type() == at::kFloat,
              cat("knn: queries must be float32, got ", queries.scalar_type()));
  TORCH_CHECK(refs.scalar_type() == at::kFloat,
              cat("knn: refs must be float32, got ", refs.scalar_type()));
  TORCH_CHECK(refs.device() == queries.device() &&
                  ref_mask.device() == queries.device(),
              cat("knn: queries, refs and ref_mask must be on one device"));
  TORCH_CHECK(1 <= k && k <= std::min<int64_t>(kMaxK, R) &&
                  queries.size(1) >= 1 && B >= 1,
              cat("knn: needs 1 ≤ k ≤ min(", kMaxK, ", R) and non-empty "
                  "shapes, got k=", k, ", queries ", shape(queries.sizes()),
                  ", refs ", shape(refs.sizes())));
}

std::vector<int64_t> plan(int64_t B, int64_t Q, int64_t R, int64_t k) {
  long long out[4];
  const int err = knn_plan(B, Q, R, k, out);
  TORCH_CHECK(err == 0,
              cat("knn: knn_plan failed with cudaError_t ", err, " (B=", B,
                  ", Q=", Q, ", R=", R, ", k=", k, ")"));
  return {out[0], out[1], out[2], out[3]};
}

std::tuple<Tensor, Tensor> knn(const Tensor& queries_, const Tensor& refs_,
                               const Tensor& ref_mask, c10::SymInt k_) {
  const int64_t k = k_.expect_int();
  check_knn(queries_, refs_, ref_mask, k);
  Tensor queries = queries_.contiguous(), refs = refs_.contiguous();
  Tensor mask = ref_mask.contiguous().view(at::kByte);
  const int64_t B = queries.size(0), Q = queries.size(1), R = refs.size(1);
  c10::cuda::CUDAGuard guard(queries.device());
  const auto p = plan(B, Q, R, k);
  auto f32 = queries.options();
  Tensor dist = at::empty({B, Q, k}, f32);
  Tensor idx = at::empty({B, Q, k}, f32.dtype(at::kInt));
  // scratch: the packed refs, the pack kernel's flags, the partial lists
  Tensor packed = at::empty({B, R, 4}, f32);
  Tensor flags = at::empty({p[3]}, f32.dtype(at::kByte));
  Tensor part_d = at::empty({p[2]}, f32);
  Tensor part_i = at::empty({p[2]}, f32.dtype(at::kInt));
  const int err = knn_f32(
      queries.data_ptr(), refs.data_ptr(), mask.data_ptr(), dist.data_ptr(),
      idx.data_ptr(), packed.data_ptr(), flags.data_ptr(), part_d.data_ptr(),
      part_i.data_ptr(), B, Q, R, k, p[0], p[2], stream_of(queries));
  TORCH_CHECK(err == 0,
              cat("knn: kernel launch failed with cudaError_t ", err, " (B=", B,
                  ", Q=", Q, ", R=", R, ", k=", k, ", ", p[1], " segments a "
                  "unit at most)"));
  count("K7");
  return {dist, idx};
}

// LayerNorm's contract: a contiguous (rows, C) bf16 or f32 x with C a
// multiple of 8 from 16 to 1024, contiguous f32 (C,) vectors, one card,
// 16-byte-aligned data.
constexpr int64_t kMinLayerNormC = 16;    // layer_norm.cu's 2 lanes * 8
constexpr int64_t kMaxLayerNormC = 1024;  // layer_norm.cu's 32 * 4 * 8

void check_aligned(const char* op, const char* what, const Tensor& t) {
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0,
              cat(op, ": ", what, "'s data must be 16-byte aligned"));
}

void check_layer_norm(const Tensor& x,
                      std::initializer_list<std::pair<const char*, Tensor>>
                          vectors) {
  TORCH_CHECK(x.device().is_cuda(),
              cat("layer_norm: no kernel for device ", x.device()));
  TORCH_CHECK(x.scalar_type() == at::kBFloat16 ||
                  x.scalar_type() == at::kFloat,
              cat("layer_norm: x must be bfloat16 or float32, got ",
                  x.scalar_type()));
  TORCH_CHECK(x.dim() == 2 && x.size(1) % 8 == 0 &&
                  x.size(1) >= kMinLayerNormC && x.size(1) <= kMaxLayerNormC,
              cat("layer_norm: x must be (rows, C) with C a multiple of 8 "
                  "from ", kMinLayerNormC, " to ", kMaxLayerNormC, ", got ",
                  shape(x.sizes())));
  TORCH_CHECK(x.is_contiguous(), cat("layer_norm: x must be contiguous"));
  check_aligned("layer_norm", "x", x);
  const int64_t C = x.size(1);
  for (const auto& [what, v] : vectors) {
    TORCH_CHECK(v.device() == x.device() && v.scalar_type() == at::kFloat &&
                    v.sizes() == at::IntArrayRef({C}) && v.is_contiguous(),
                cat("layer_norm: ", what, " must be a contiguous float32 ",
                    shape({C}), " tensor on ", x.device(), ", got ",
                    v.scalar_type(), " ", shape(v.sizes()), " on ",
                    v.device()));
    check_aligned("layer_norm", what, v);
  }
}

std::tuple<Tensor, Tensor, Tensor> layer_norm_forward(const Tensor& x,
                                                      const Tensor& weight,
                                                      const Tensor& bias,
                                                      double eps) {
  check_layer_norm(x, {{"weight", weight}, {"bias", bias}});
  const int64_t rows = x.size(0), C = x.size(1);
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  const auto f32 = x.options().dtype(at::kFloat);
  Tensor mean = at::empty({rows}, f32), rstd = at::empty({rows}, f32);
  const int err = layer_norm_fwd(
      x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
      mean.data_ptr(), rstd.data_ptr(), rows, C, static_cast<float>(eps),
      x.scalar_type() == at::kBFloat16, stream_of(x));
  TORCH_CHECK(err == 0, cat("layer_norm: kernel launch failed with "
                            "cudaError_t ", err, " (rows=", rows, ", C=", C,
                            ")"));
  count("LN");
  return {y, mean, rstd};
}

// layer_norm_bwd_plan's (blocks, rows a block) for rows x C
std::vector<int64_t> layer_norm_bwd_blocks(int64_t rows, int64_t C) {
  long long plan[2];
  TORCH_CHECK(layer_norm_bwd_plan(rows, static_cast<int>(C), plan) == 0,
              cat("layer_norm backward: no plan for rows=", rows, ", C=", C));
  return {plan[0], plan[1]};
}

std::tuple<Tensor, Tensor, Tensor> layer_norm_backward(const Tensor& dy,
                                                       const Tensor& x,
                                                       const Tensor& weight,
                                                       const Tensor& mean,
                                                       const Tensor& rstd) {
  check_layer_norm(x, {{"weight", weight}});
  TORCH_CHECK(dy.device() == x.device() &&
                  dy.scalar_type() == x.scalar_type() &&
                  dy.sizes() == x.sizes() && dy.is_contiguous(),
              cat("layer_norm backward: dy must be a contiguous ",
                  x.scalar_type(), " ", shape(x.sizes()), " tensor on ",
                  x.device(), ", got ", dy.scalar_type(), " ",
                  shape(dy.sizes()), " on ", dy.device()));
  check_aligned("layer_norm backward", "dy", dy);
  const int64_t rows = x.size(0), C = x.size(1);
  for (const auto& [what, v] : {std::pair<const char*, Tensor>{"mean", mean},
                                {"rstd", rstd}}) {
    TORCH_CHECK(v.device() == x.device() && v.scalar_type() == at::kFloat &&
                    v.sizes() == at::IntArrayRef({rows}) && v.is_contiguous(),
                cat("layer_norm backward: ", what, " must be a contiguous "
                    "float32 ", shape({rows}), " tensor on ", x.device(),
                    ", got ", v.scalar_type(), " ", shape(v.sizes()), " on ",
                    v.device()));
  }
  c10::cuda::CUDAGuard guard(x.device());
  const auto plan = layer_norm_bwd_blocks(rows, C);
  const auto f32 = x.options().dtype(at::kFloat);
  Tensor dx = at::empty_like(x);
  Tensor dw = at::empty({C}, f32), db = at::empty({C}, f32);
  // one f32 partial row of dw and of db a block, summed in block order
  Tensor part_w = at::empty({plan[0], C}, f32);
  Tensor part_b = at::empty({plan[0], C}, f32);
  const int err = layer_norm_bwd(
      dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
      rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
      part_w.data_ptr(), part_b.data_ptr(), rows, C,
      x.scalar_type() == at::kBFloat16, stream_of(x));
  TORCH_CHECK(err == 0, cat("layer_norm backward: kernel launch failed with "
                            "cudaError_t ", err, " (rows=", rows, ", C=", C,
                            ")"));
  count("LNB");
  return {dx, dw, db};
}

// --- tpu3dssf_cuda:: the counters and the sources' constants ----------------

std::vector<int64_t> launch_counts() {
  std::vector<int64_t> out(kKernels);
  for (int i = 0; i < kKernels; ++i) out[i] = g_launches[i].load();
  return out;
}

void set_launch_counts(at::IntArrayRef counts) {
  TORCH_CHECK(counts.size() == kKernels,
              cat("set_launch_counts: ", kKernels,
                  " counts (K1 ... K9, LN, LNB), got ", counts.size()));
  for (int i = 0; i < kKernels; ++i) g_launches[i] = counts[i];
}

int64_t constant(c10::string_view name_) {
  const std::string name(name_.data(), name_.size());
  if (name == "fa_forward_d64_smem_bytes") return fa_forward_d64_smem_bytes();
  if (name == "fa_backward_d64_smem_bytes")
    return fa_backward_d64_smem_bytes();
  if (name == "fa_backward_d16_block_keys")
    return fa_backward_d16_block_keys();
  TORCH_CHECK(false,
              cat("tpu3dssf_cuda::constant: no constant ", name));
  return -1;
}

}  // namespace

extern "C" {
// counts[0..10] = the launches of K1 ... K9, LN and LNB made in this
// process
void tpu3dssf_read_launch_counts(int64_t* counts) {
  for (int i = 0; i < kKernels; ++i) counts[i] = g_launches[i].load();
}
void tpu3dssf_write_launch_counts(const int64_t* counts) {
  for (int i = 0; i < kKernels; ++i) g_launches[i] = counts[i];
}
}

TORCH_LIBRARY_IMPL(tpu3dssf, CUDA, m) {
  m.impl("packed_attention", &packed_attention);
  m.impl("packed_attention_lse", &packed_attention_lse);
  m.impl("packed_attention_bwd", &packed_attention_bwd);
  m.impl("attention", &attention);
  m.impl("attention_lse", &attention_lse);
  m.impl("attention_bwd", &attention_bwd);
  m.impl("knn", &knn);
  m.impl("layer_norm", &layer_norm_forward);
  m.impl("layer_norm_bwd", &layer_norm_backward);
}

TORCH_LIBRARY(tpu3dssf_cuda, m) {
  m.def("launch_counts() -> int[]", &launch_counts);
  m.def("set_launch_counts(int[] counts) -> ()", &set_launch_counts);
  m.def("knn_plan(int B, int Q, int R, int k) -> int[]", &plan);
  m.def("layer_norm_bwd_plan(int rows, int C) -> int[]",
        &layer_norm_bwd_blocks);
  m.def("constant(str name) -> int", &constant);
}
