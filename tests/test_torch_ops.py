"""The kernels as ``torch.library`` custom ops (``tpu3dssf::*``), on the CPU.

``import tpu3dssf_torch.kernels`` loads the C++ library that defines seven
ops for the nine TPU kernels (csrc/ops_schema.cpp, built here with the host
compiler) and registers their CPU kernels (the plain versions) and fake
kernels (shapes only); their CUDA kernels are C++ (csrc/ops_cuda.cpp), in
the library that only a machine with a card builds. Here:
``torch.library.opcheck`` on every op at small f32 shapes (a few heads, a
ragged N, the RoPE tables once); every wrapper and training rule goes
through its op, and its CPU result equals the plain version's bit for bit
(tolerance 0: the op's CPU kernel is the plain version); the fake kernels
raise the CUDA kernels' errors on CUDA fakes (no card needed: a fake has no
data) and take what the plain versions take on CPU fakes. The CUDA
kernels run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import tpu3dssf_torch.kernels  # noqa: F401  (registers the ops)
from tpu3dssf_torch.kernels import knn, ops
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import window_attention as wa
from tpu3dssf_torch.voxel.voxelize import _topk_neighbors

OPS = ("packed_attention", "packed_attention_lse", "packed_attention_bwd",
       "attention", "attention_lse", "attention_bwd", "knn")
B, N, H, D = 2, 37, 3, 16        # ragged N
C = H * D


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _packed(seed=0):
    g = _gen(seed)
    qkv = torch.randn(B, N, 3 * C, generator=g)
    keep = torch.rand(B, N, generator=g) > 0.3
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, -1e9)[:, None, :].contiguous()
    cos, sin = torch.rand(2, N, D // 2, generator=g) * 2 - 1
    return qkv, bias, keep, cos.contiguous(), sin.contiguous()


def _stats(seed=1):
    g = _gen(seed)
    return (torch.randn(B, N, C, generator=g),
            torch.randn(B, H, N, generator=g),
            torch.randn(B, H, N, generator=g))


def _views(qkv):
    return fa._split_heads(qkv, H)


def _cloud(seed=2):
    g = _gen(seed)
    return (torch.rand(B, 29, 3, generator=g) * 4,
            torch.rand(B, 41, 3, generator=g) * 4,
            torch.rand(B, 41, generator=g) > 0.25)


def _cases():
    qkv, bias, keep, cos, sin = _packed()
    dout, lse, delta = _stats()
    q, k, v = _views(qkv)
    do4 = dout.unflatten(-1, (H, D))
    queries, refs, mask = _cloud()
    return {
        "packed_attention": (qkv, bias, H, 0.25, None, None),
        "packed_attention_rope": ("packed_attention",
                                  (qkv, bias, H, 0.25, cos, sin)),
        "packed_attention_lse": (qkv, bias, H, 0.25, None, None, "K2"),
        "packed_attention_lse_rope": ("packed_attention_lse",
                                      (qkv, bias, H, 0.25, cos, sin, "K1")),
        "packed_attention_bwd": (qkv, bias, dout, lse, delta, H, 0.25, "K3"),
        "attention": (q, k, v, bias, None, "K8"),
        "attention_window": ("attention", (q, k, v, bias, keep, "K6")),
        "attention_lse": (q, k, v, bias, 0.25, "K4"),
        "attention_bwd": (q, k, v, bias, do4, lse, delta, 0.25, "K9"),
        "knn": (queries, refs, mask, 5),
    }


CASES = list(_cases())


@pytest.mark.parametrize("case", CASES)
def test_opcheck(case):
    args = _cases()[case]
    name = case
    if isinstance(args[0], str):
        name, args = args
    torch.library.opcheck(getattr(torch.ops.tpu3dssf, name).default, args)


def test_the_package_registers_seven_ops_with_three_kernels_each():
    """CPU and fake kernels here, on every op; the CUDA kernels in the C++
    library's ``TORCH_LIBRARY_IMPL(tpu3dssf, CUDA, ...)``, which a machine
    without a card never loads: no other CUDA kernel stands in for them."""
    # and the two LayerNorm ops (tests/test_torch_layer_norm.py)
    assert set(ops.KERNELS) == {*OPS, "layer_norm", "layer_norm_bwd"}
    assert sorted(k for ks in ops.KERNELS.values() for k in ks) == sorted(
        ["K1", "K1", "K2", "K3", "K4", "K4", "K5", "K5", "K6", "K7", "K8",
         "K8", "K9", "LN", "LNB"])
    from torch._library.simple_registry import singleton
    from tpu3dssf_torch.kernels import _build
    source = (_build.CSRC_DIR / _build.CUDA_OPS_SOURCE).read_text()
    cuda_impl = source.split("TORCH_LIBRARY_IMPL(tpu3dssf, CUDA, m) {")[1]
    cuda_impl = cuda_impl.split("}")[0]
    for name in OPS:
        qual = f"tpu3dssf::{name}"
        assert hasattr(torch.ops.tpu3dssf, name)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CPU")
        assert singleton.find(qual).fake_impl.kernel is not None
        assert f'm.impl("{name}", &{name});' in cuda_impl
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            qual, "CUDA") == _build.cuda_library_loaded()
    assert cuda_impl.count("m.impl(") == len(ops.KERNELS)


class _Ops(TorchDispatchMode):
    """Records the ``tpu3dssf`` ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "tpu3dssf":
            kernel = [a for a in args if isinstance(a, str)]
            self.seen.append((func.__name__.split(".")[0], *kernel))
        return func(*args, **(kwargs or {}))


def _same(got, want):
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_inference_wrappers_go_through_their_ops_bit_for_bit():
    qkv, bias, keep, cos, sin = _packed()
    q, k, v = _views(qkv)
    queries, refs, mask = _cloud()
    calls = [
        (lambda: fa.flash_attention_packed(qkv, bias, H, 0.25),
         lambda: fa.flash_attention_packed_reference(qkv, bias, H, 0.25),
         ("packed_attention",)),
        (lambda: fa.flash_attention_packed(qkv, bias, H, 0.25, cos, sin),
         lambda: fa.flash_attention_packed_reference(qkv, bias, H, 0.25,
                                                     cos, sin),
         ("packed_attention",)),
        (lambda: fa.flash_attention(q, k, v, bias),
         lambda: fa.mha_reference(q, k, v, bias), ("attention", "K8")),
        (lambda: wa.window_attention(q, k, v, keep),
         lambda: wa.window_attention_reference(q, k, v, keep),
         ("attention", "K6")),
        (lambda: wa.window_attention_packed(qkv, keep, H),
         lambda: fa.flash_attention_packed_reference(
             qkv, wa.key_bias(keep), H, D ** -0.5)
         * keep[..., None].to(qkv.dtype), ("packed_attention",)),
        (lambda: _topk_neighbors(queries, refs, mask, 5),
         lambda: knn.topk_neighbors_reference(queries, refs, mask, 5),
         ("knn",)),
    ]
    before = tpu3dssf_torch.kernels.modules.launch_counts()
    for run, plain, op in calls:
        with _Ops() as mode:
            got = run()
        assert mode.seen == [op]
        _same(got, plain())
    assert tpu3dssf_torch.kernels.modules.launch_counts() == before


def _grads(fn, *leaves, dout):
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    with _Ops() as mode:
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, dout)
    return out.detach(), grads, mode.seen


def test_training_rules_go_through_their_ops_bit_for_bit():
    qkv, bias, keep, cos, sin = _packed()
    dout, _, _ = _stats()
    q, k, v = _views(qkv)
    do4 = dout.unflatten(-1, (H, D))
    before = tpu3dssf_torch.kernels.modules.launch_counts()

    # the packed rule: K2 + K3
    out, (dqkv,), seen = _grads(
        lambda x: fa.flash_attention_packed(x, bias, H, 0.25), qkv,
        dout=dout)
    want, lse = fa.flash_attention_packed_lse_reference(qkv, bias, H, 0.25)
    delta = fa.row_delta(dout, want, H)
    assert seen == [("packed_attention_lse", "K2"),
                    ("packed_attention_bwd", "K3")]
    _same(out, want)
    _same(dqkv, fa.flash_attention_packed_bwd_reference(
        qkv, bias, dout, lse, delta, H, 0.25))

    # its RoPE branch: K1 with its LSE + K9 on the rotated q and k
    out, (dqkv,), seen = _grads(
        lambda x: fa.flash_attention_packed(x, bias, H, 0.25, cos, sin),
        qkv, dout=dout)
    assert seen == [("packed_attention_lse", "K1"), ("attention_bwd", "K9")]
    _same(out, fa.flash_attention_packed_reference(qkv, bias, H, 0.25, cos,
                                                   sin))

    # the packed window rule: K4 + K5
    out, (dqkv,), seen = _grads(
        lambda x: wa.window_attention_packed(x, keep, H), qkv, dout=dout)
    assert seen == [("packed_attention_lse", "K4"),
                    ("packed_attention_bwd", "K5")]
    wb, mask = wa.key_bias(keep), keep[..., None].to(qkv.dtype)
    want, lse = fa.flash_attention_packed_lse_reference(qkv, wb, H,
                                                        D ** -0.5)
    _same(out, want * mask)
    g = dout * mask
    _same(dqkv, fa.flash_attention_packed_bwd_reference(
        qkv, wb, g, lse, fa.row_delta(g, want * mask, H), H, D ** -0.5))

    # the (B, N, H, D) rules: K8 + K9, and the window route's K4 + K5
    for fn, kernels, bias_, qmask in (
            (lambda *x: fa.flash_attention(*x, bias), ("K8", "K9"), bias,
             None),
            (lambda *x: wa.window_attention(*x, keep), ("K4", "K5"),
             wa.key_bias(keep), keep[..., None, None].to(q.dtype))):
        out, grads, seen = _grads(fn, q, k, v, dout=do4)
        assert seen == [("attention_lse", kernels[0]),
                        ("attention_bwd", kernels[1])]
        want, lse = fa.flash_attention_lse_reference(q, k, v, bias_,
                                                     D ** -0.5)
        g = do4
        if qmask is not None:
            want, g = want * qmask, do4 * qmask
        _same(out, want)
        _same(grads, fa.flash_attention_bwd_reference(
            q, k, v, bias_, g, lse, fa.row_delta(g, want), D ** -0.5))
    assert tpu3dssf_torch.kernels.modules.launch_counts() == before


def _cuda(shape, stride=None, dtype=torch.bfloat16):
    """A CUDA tensor, under a fake mode (a fake needs no card)."""
    if stride is None:
        return torch.empty(shape, device="cuda", dtype=dtype)
    return torch.empty_strided(shape, stride, device="cuda", dtype=dtype)


def _cuda_fakes(*xs):
    """CUDA fakes of ``xs`` (bf16 where a float is given), under the
    returned mode."""
    mode = FakeTensorMode()
    with mode:
        out = [torch.empty_strided(x.shape, x.stride(), device="cuda",
                                   dtype=torch.bfloat16
                                   if x.dtype == torch.float32 else x.dtype)
               for x in xs]
    return mode, out


def test_fake_kernels_raise_the_launchers_errors_on_cuda_fakes():
    qkv, bias, keep, cos, sin = _packed()
    mode, (fqkv, fbias, fcos, fsin) = _cuda_fakes(qkv, bias, cos, sin)
    with mode:
        fbias, fcos, fsin = fbias.float(), fcos.float(), fsin.float()
        out = torch.ops.tpu3dssf.packed_attention(fqkv, fbias, H, 0.25, None,
                                                  None)
        assert (out.shape, out.dtype, out.device.type) == (
            (B, N, C), torch.bfloat16, "cuda")
        out, lse = torch.ops.tpu3dssf.packed_attention_lse(
            fqkv, fbias, H, 0.25, None, None, "K2")
        assert lse.shape == (B, H, N) and lse.dtype == torch.float32
        for args, err, match in (
                ((fqkv.float(), fbias, H), TypeError, "bfloat16"),
                ((fqkv, fbias, 6), ValueError, "head dim 8 must be one of"),
                ((fqkv, fbias, 5), ValueError, "is not an integer"),
                ((fqkv, fbias.double(), H), ValueError, "key_bias"),
                ((_cuda((B, N, 3 * C - 1)), fbias, H), ValueError,
                 r"\(B, N, 3C\)")):
            with pytest.raises(err, match=match):
                torch.ops.tpu3dssf.packed_attention(*args, 0.25, None, None)
        # the tables: D = 64 only
        with pytest.raises(ValueError, match="64 only"):
            torch.ops.tpu3dssf.packed_attention(fqkv, fbias, H, 0.25, fcos,
                                                fsin)
        with pytest.raises(ValueError, match="K1 is the RoPE branch"):
            torch.ops.tpu3dssf.packed_attention_lse(fqkv, fbias, H, 0.25,
                                                    None, None, "K1")
        q, k, v = _views(fqkv)
        with pytest.raises(ValueError, match="kernel must be one of"):
            torch.ops.tpu3dssf.attention(q, k, v, fbias, None, "K1")
        apart = _cuda((B, N, H, D), (2 * N * H * D, 2 * H * D, 2 * D, 2))
        with pytest.raises(ValueError, match="strides a multiple of 8"):
            torch.ops.tpu3dssf.attention(apart, k, v, fbias, None, "K8")
        dq, dk, dv = torch.ops.tpu3dssf.attention_bwd(
            q, k, v, fbias, q, lse, lse, 0.25, "K5")
        assert dq.shape == (B, N, H, D) and dq.is_contiguous()
        with pytest.raises(ValueError, match="lse must be"):
            torch.ops.tpu3dssf.attention_bwd(
                q, k, v, fbias, q, _cuda((B, 1, N), dtype=torch.float32),
                lse, 0.25, "K5")
    queries, refs, mask = _cloud()
    mode, (fq, fr, fm) = _cuda_fakes(queries, refs, mask)
    with mode:
        d, i = torch.ops.tpu3dssf.knn(fq.float(), fr.float(), fm, 5)
        assert d.shape == i.shape == (B, 29, 5) and i.dtype == torch.int32
        with pytest.raises(TypeError, match="float32"):
            torch.ops.tpu3dssf.knn(fq, fr.float(), fm, 5)
        with pytest.raises(ValueError, match="k ≤ min"):
            torch.ops.tpu3dssf.knn(fq.float(), fr.float(), fm, 9)


def test_fake_kernels_take_what_the_plain_versions_take_on_cpu_fakes():
    """On CPU tensors the op is the plain version: any float dtype and D,
    and the tables at any D; the fake gives the real kernel's metadata."""
    qkv, bias, keep, cos, sin = _packed()
    with FakeTensorMode() as mode:
        fqkv, fbias, fcos, fsin = (mode.from_tensor(x)
                                   for x in (qkv, bias, cos, sin))
        out = torch.ops.tpu3dssf.packed_attention(fqkv, fbias, H, 0.25, fcos,
                                                  fsin)
    want = torch.ops.tpu3dssf.packed_attention(qkv, bias, H, 0.25, cos, sin)
    assert (out.shape, out.stride(), out.dtype) == (
        want.shape, want.stride(), want.dtype)


def test_cpu_tensor_never_reaches_a_launcher():
    """A CPU tensor takes the plain version and counts nothing, in the
    kernel's dtype too; the k-NN wrapper, which has no plain route, raises
    on one, as it always did; and no kernel module keeps a launcher of its
    own (each launch is the C++ kernel of an op)."""
    queries, refs, mask = _cloud()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        knn.knn(queries, refs, mask, 3)
    before = tpu3dssf_torch.kernels.modules.launch_counts()
    _same(torch.ops.tpu3dssf.knn(queries, refs, mask, 3),
          knn.topk_neighbors_reference(queries, refs, mask, 3))
    qkv, bias, *_ = _packed()
    qkv = qkv.bfloat16()
    _same(torch.ops.tpu3dssf.packed_attention_lse(qkv, bias, H, 0.25, None,
                                                  None, "K2"),
          fa.flash_attention_packed_lse_reference(qkv, bias, H, 0.25))
    assert tpu3dssf_torch.kernels.modules.launch_counts() == before
    for module in (fa, wa, knn):
        assert not [n for n in vars(module) if n.startswith("_launch")]
