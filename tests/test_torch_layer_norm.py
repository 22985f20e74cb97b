"""The port's LayerNorm op pair (``tpu3dssf::layer_norm``, ``tpu3dssf::
layer_norm_bwd``; tpu3dssf_torch/kernels/layer_norm.py, csrc/layer_norm.cu)
and the module that runs every LayerNorm of the port through it
(``models.layers.LayerNorm``), on the CPU.

The ops' CPU kernels are the plain versions: the arithmetic the module ran
before the kernel (``F.layer_norm(x.float(), ...)`` cast to the compute
dtype, and autograd's gradient through it), which these tests hold bit for
bit, forward and backward, in bf16 and f32 at every width the port's models
take (PTv3 32–512, ViT-S 384, ViT-L 1024). The fake kernels give the C++
kernels' shapes and raise their errors on CUDA fakes (no card needed: a fake
has no data), as ``csrc/ops_cuda.cpp`` words them. The CUDA kernels run on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 36).
"""

import re

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import tpu3dssf_torch.kernels  # noqa: F401  (registers the ops)
from tpu3dssf_torch.kernels import _build, modules, ops
from tpu3dssf_torch.kernels import layer_norm as layer_norm_fn
from tpu3dssf_torch.kernels.modules import layer_norm as ln
from tpu3dssf_torch.models.layers import LayerNorm

WIDTHS = (32, 64, 128, 256, 384, 512, 1024)
DTYPES = (torch.bfloat16, torch.float32)
ROWS = 37                      # no multiple of any block's rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(C, dtype, rows=ROWS, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, C, generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.2 * torch.randn(C, generator=g)
    b = 0.2 * torch.randn(C, generator=g)
    dy = torch.randn(rows, C, generator=g).to(dtype)
    x[0] = 0                   # a padded row: gives the bias
    return x, w, b, dy


def _old(x, w, b, eps, dtype):
    """The module's arithmetic before the kernel."""
    return F.layer_norm(x.float(), w.shape, w, b, eps).to(dtype)


def _equal(got, want):
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", WIDTHS)
def test_op_cpu_kernels_are_the_old_arithmetic_bit_for_bit(C, dtype):
    x, w, b, dy = _inputs(C, dtype)
    eps = 1e-6
    y, mean, rstd = torch.ops.tpu3dssf.layer_norm(x, w, b, eps)
    xs = x.clone().requires_grad_()
    ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
    want = _old(xs, ws, bs, eps, dtype)
    want.backward(dy)
    _equal((y,), (want,))
    assert torch.equal(y[0], b.to(dtype))
    _, m32, r32 = torch.native_layer_norm(x.float(), (C,), w, b, eps)
    _equal((mean, rstd), (m32.reshape(-1), r32.reshape(-1)))
    grads = torch.ops.tpu3dssf.layer_norm_bwd(dy, x, w, mean, rstd)
    _equal(grads, (xs.grad, ws.grad, bs.grad))


@pytest.mark.parametrize("x_dtype,dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=str)
def test_module_is_the_old_module_bit_for_bit(x_dtype, dtype):
    """``models.layers.LayerNorm`` on (B, N, C), forward and every
    gradient, against its old forward; the input in the compute dtype goes
    to the op as it is, any other in f32."""
    C = 64
    m = LayerNorm(C, eps=1e-5, dtype=dtype)
    x, w, b, _ = _inputs(C, x_dtype, rows=2 * 19)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    x = x.reshape(2, 19, C).requires_grad_()
    y = m(x)
    x2 = x.detach().clone().requires_grad_()
    w2, b2 = w.clone().requires_grad_(), b.clone().requires_grad_()
    want = _old(x2, w2, b2, 1e-5, dtype)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(5))
    y.backward(g.to(dtype))
    want.backward(g.to(dtype))
    _equal((y, x.grad, m.weight.grad, m.bias.grad),
           (want, x2.grad, w2.grad, b2.grad))
    with torch.no_grad():
        _equal((m(x),), (want,))


def test_the_module_takes_the_op_and_its_training_rule():
    """No gradient pending: one ``layer_norm`` op; with one: the op, then
    ``layer_norm_bwd`` in the backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "tpu3dssf":
                self.seen.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    m = LayerNorm(32, dtype=torch.bfloat16)
    x = _inputs(32, torch.bfloat16)[0].reshape(1, ROWS, 32)
    with torch.no_grad(), Ops() as mode:
        m(x)
    assert mode.seen == ["layer_norm"]
    with Ops() as mode:
        m(x).float().sum().backward()
    assert mode.seen == ["layer_norm", "layer_norm_bwd"]
    assert m.weight.grad is not None and m.bias.grad is not None


@pytest.mark.parametrize("name,args", [
    ("layer_norm", lambda x, w, b, dy, m, r: (x, w, b, 1e-5)),
    ("layer_norm_bwd", lambda x, w, b, dy, m, r: (dy, x, w, m, r))])
def test_opcheck(name, args):
    x, w, b, dy = _inputs(40, torch.float32, rows=9)
    _, m, r = torch.ops.tpu3dssf.layer_norm(x, w, b, 1e-5)
    torch.library.opcheck(getattr(torch.ops.tpu3dssf, name).default,
                          args(x, w, b, dy, m, r))


def test_each_op_has_its_three_kernels_and_counts_nothing_on_the_cpu():
    from torch._library.simple_registry import singleton
    source = (_build.CSRC_DIR / _build.CUDA_OPS_SOURCE).read_text()
    cuda_impl = source.split("TORCH_LIBRARY_IMPL(tpu3dssf, CUDA, m) {")[1]
    cuda_impl = cuda_impl.split("}")[0]
    names = ("layer_norm", "layer_norm_bwd")
    assert {name: ops.KERNELS[name] for name in names} == {
        "layer_norm": ("LN",), "layer_norm_bwd": ("LNB",)}
    for name in names:
        qual = f"tpu3dssf::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CPU")
        assert singleton.find(qual).fake_impl.kernel is not None
        assert f'm.impl("{name}", &' in cuda_impl
    before = modules.launch_counts()
    m = LayerNorm(32)
    m(_inputs(32, torch.float32)[0]).sum().backward()
    assert modules.launch_counts() == before


def test_the_counters_read_through_the_kernel_module():
    """LN and LNB sit after K1–K9 in the one registry that
    ``launch_counts()`` reads and the graphs keep."""
    if _build.cuda_library_loaded():
        pytest.skip("the CUDA library is loaded: its counters are C++")
    assert list(modules.COUNTERS) == [f"K{i}" for i in range(1, 10)] + [
        "LN", "LNB"]
    assert {k: modules.COUNTERS[k] for k in ("LN", "LNB")} == {
        "LN": ("layer_norm", "LAUNCHES"), "LNB": ("layer_norm",
                                                  "BWD_LAUNCHES")}
    before = modules.launch_counts()
    try:
        modules.set_launch_counts({"LN": 57, "LNB": 3})
        assert (ln.LAUNCHES, ln.BWD_LAUNCHES) == (57, 3)
        assert modules.launch_counts() == dict(before, LN=57, LNB=3)
    finally:
        modules.set_launch_counts(before)


def test_the_cuda_sources_agree_on_the_widest_row_and_the_counters():
    cu = (_build.CSRC_DIR / "layer_norm.cu").read_text()
    cpp = (_build.CSRC_DIR / _build.CUDA_OPS_SOURCE).read_text()
    runner = (_build.CSRC_DIR / _build.RUNNER_SOURCE).read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", cu).group(1))
             for k in ("kVec", "kMaxChunks")}
    assert 32 * const["kMaxChunks"] * const["kVec"] == ln.MAX_C
    assert 2 * const["kVec"] == ln.MIN_C
    assert f"kMaxLayerNormC = {ln.MAX_C};" in cpp
    assert f"kMinLayerNormC = {ln.MIN_C};" in cpp
    assert "layer_norm.cu" in _build.KERNEL_SOURCES

    for src in (cpp, runner):
        i = src.index("kCounters[] = {")
        listed = re.findall(r'"(\w+)"', src[i:src.index("};", i)])
        assert listed == list(modules.COUNTERS)


def _cuda_fakes(C=64, rows=10, dtype=torch.bfloat16):
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(rows, C, device="cuda", dtype=dtype)
        w = torch.empty(C, device="cuda")
        b = torch.empty(C, device="cuda")
    return mode, x, w, b


def test_fake_kernels_give_the_cuda_kernels_shapes():
    mode, x, w, b = _cuda_fakes()
    with mode:
        y, mean, rstd = torch.ops.tpu3dssf.layer_norm(x, w, b, 1e-6)
        assert (y.shape, y.dtype, y.device.type) == (
            (10, 64), torch.bfloat16, "cuda")
        assert mean.shape == rstd.shape == (10,)
        assert mean.dtype == rstd.dtype == torch.float32
        dx, dw, db = torch.ops.tpu3dssf.layer_norm_bwd(y, x, w, mean, rstd)
        assert (dx.shape, dx.dtype) == ((10, 64), torch.bfloat16)
        assert dw.shape == db.shape == (64,) and dw.dtype == torch.float32
    with FakeTensorMode() as cpu:
        fx = cpu.from_tensor(torch.ones(3, 5, 6, dtype=torch.bfloat16))
        y, mean, _ = torch.ops.tpu3dssf.layer_norm(
            fx, cpu.from_tensor(torch.ones(6)),
            cpu.from_tensor(torch.zeros(6)), 1e-6)
        assert y.shape == (3, 5, 6) and mean.shape == (15,)


def _cuda(*shape, dtype=torch.float32, stride=None):
    """A CUDA tensor, made from nothing under a fake mode (a fake needs no
    card; this CPU build of torch refuses views of CUDA fakes)."""
    if stride is None:
        return torch.empty(shape, device="cuda", dtype=dtype)
    return torch.empty_strided(shape, stride, device="cuda", dtype=dtype)


def _breaches():
    """{what is wrong: ((x, weight, bias) made under a fake mode, the C++
    kernel's error)}."""
    bf16 = torch.bfloat16
    ok_x, ok_v = (lambda: _cuda(10, 64, dtype=bf16)), (lambda: _cuda(64))
    return {
        "dtype": (lambda: (_cuda(10, 64, dtype=torch.float16), ok_v(),
                           ok_v()),
                  "layer_norm: x must be bfloat16 or float32, got Half"),
        "not_2d": (lambda: (_cuda(2, 5, 64, dtype=bf16), ok_v(), ok_v()),
                   r"layer_norm: x must be \(rows, C\) with C a multiple "
                   r"of 8 from 16 to 1024, got \(2, 5, 64\)"),
        "width": (lambda: (_cuda(10, 60, dtype=bf16), _cuda(60), _cuda(60)),
                  r"C a multiple of 8 from 16 to 1024, got \(10, 60\)"),
        "too_wide": (lambda: (_cuda(10, 1032, dtype=bf16), _cuda(1032),
                              _cuda(1032)),
                     r"got \(10, 1032\)"),
        "too_narrow": (lambda: (_cuda(10, 8, dtype=bf16), _cuda(8),
                                _cuda(8)),
                       r"got \(10, 8\)"),
        "strided": (lambda: (_cuda(10, 64, dtype=bf16, stride=(1, 10)),
                             ok_v(), ok_v()),
                    "layer_norm: x must be contiguous"),
        "weight": (lambda: (ok_x(), _cuda(64, dtype=bf16), ok_v()),
                   r"layer_norm: weight must be a contiguous float32 "
                   r"\(64,\) tensor on cuda:0, got BFloat16 \(64,\) on cuda:0"),
        "bias": (lambda: (ok_x(), ok_v(), _cuda(32)),
                 r"layer_norm: bias must be a contiguous float32 \(64,\) "
                 r"tensor on cuda:0, got Float \(32,\)"),
    }


@pytest.mark.parametrize("breach", sorted(_breaches()))
def test_fake_kernel_raises_the_cuda_kernels_error(breach):
    make, message = _breaches()[breach]
    with FakeTensorMode(), pytest.raises(RuntimeError, match=message):
        torch.ops.tpu3dssf.layer_norm(*make(), 1e-6)
    cpp = (_build.CSRC_DIR / _build.CUDA_OPS_SOURCE).read_text()
    for piece in ("x must be bfloat16 or float32, got ",
                  "x must be (rows, C) with C a multiple of 8 ",
                  "x must be contiguous", " must be a contiguous float32 "):
        assert piece in cpp


def test_fake_backward_raises_the_cuda_kernels_errors():
    mode, x, w, b = _cuda_fakes()
    with mode:
        y, mean, rstd = torch.ops.tpu3dssf.layer_norm(x, w, b, 1e-6)
        with pytest.raises(RuntimeError, match=r"layer_norm backward: dy "
                           r"must be a contiguous BFloat16 \(10, 64\)"):
            torch.ops.tpu3dssf.layer_norm_bwd(_cuda(10, 64), x, w, mean,
                                              rstd)
        with pytest.raises(RuntimeError, match=r"layer_norm backward: rstd "
                           r"must be a contiguous float32 \(10,\) tensor"):
            torch.ops.tpu3dssf.layer_norm_bwd(y, x, w, mean, _cuda(5))
        with pytest.raises(RuntimeError, match="layer_norm: weight must"):
            torch.ops.tpu3dssf.layer_norm_bwd(y, x, _cuda(8), mean, rstd)


def test_the_wrapper_runs_the_op_without_a_gradient():
    x, w, b, _ = _inputs(32, torch.bfloat16)
    _equal((layer_norm_fn(x, w, b, 1e-6),),
           (_old(x, w, b, 1e-6, torch.bfloat16),))
    xg = x.clone().requires_grad_()
    y = layer_norm_fn(xg, w, b, 1e-6)
    assert y.grad_fn is not None and "LayerNormFunction" in type(
        y.grad_fn).__name__
