"""The port's C++ op libraries and their build (tpu3dssf_torch/csrc/
ops_schema.cpp, ops_cuda.cpp, aoti_runner.cpp; tpu3dssf_torch/kernels/
_build.py), on the CPU.

Here the host compiler builds the schema library (importing
``tpu3dssf_torch.kernels`` does) and ``aoti_runner``; the CUDA library is
built only where nvcc and a card are (tests/test_torch_cuda.py,
chip_smoke.py), so its command lines are checked without running them. The
seven attention and k-NN ops' schemas are held to the ones the Python
``custom_op`` declarations gave them before the ops moved to C++ (the table
below), so that artifacts and callers see the same ops; the two LayerNorm
ops were defined in C++ from the start.
"""

import ast
import subprocess
from pathlib import Path

import pytest
import torch

import tpu3dssf_torch.kernels  # noqa: F401  (loads the schema library)
from tpu3dssf_torch.export import read_raw, write_raw
from tpu3dssf_torch.kernels import _build, modules
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import knn
from tpu3dssf_torch.kernels.modules import window_attention as wa

# the schemas of the ops as Python custom ops declared them (the LayerNorm
# ops' as ops_schema.cpp declares them)
SCHEMAS = {
    "packed_attention": "tpu3dssf::packed_attention(Tensor qkv, Tensor "
    "key_bias, SymInt heads, float? q_scale, Tensor? rope_cos, Tensor? "
    "rope_sin) -> Tensor",
    "packed_attention_lse": "tpu3dssf::packed_attention_lse(Tensor qkv, "
    "Tensor key_bias, SymInt heads, float? q_scale, Tensor? rope_cos, "
    "Tensor? rope_sin, str kernel) -> (Tensor, Tensor)",
    "packed_attention_bwd": "tpu3dssf::packed_attention_bwd(Tensor qkv, "
    "Tensor key_bias, Tensor dout, Tensor lse, Tensor delta, SymInt heads, "
    "float? q_scale, str kernel) -> Tensor",
    "attention": "tpu3dssf::attention(Tensor q, Tensor k, Tensor v, Tensor "
    "key_bias, Tensor? key_mask, str kernel) -> Tensor",
    "attention_lse": "tpu3dssf::attention_lse(Tensor q, Tensor k, Tensor v, "
    "Tensor key_bias, float q_scale, str kernel) -> (Tensor, Tensor)",
    "attention_bwd": "tpu3dssf::attention_bwd(Tensor q, Tensor k, Tensor v, "
    "Tensor key_bias, Tensor dout, Tensor lse, Tensor delta, float q_scale, "
    "str kernel) -> (Tensor, Tensor, Tensor)",
    "knn": "tpu3dssf::knn(Tensor queries, Tensor refs, Tensor ref_mask, "
    "SymInt k) -> (Tensor, Tensor)",
    "layer_norm": "tpu3dssf::layer_norm(Tensor x, Tensor weight, Tensor "
    "bias, float eps) -> (Tensor, Tensor, Tensor)",
    "layer_norm_bwd": "tpu3dssf::layer_norm_bwd(Tensor dy, Tensor x, Tensor "
    "weight, Tensor mean, Tensor rstd) -> (Tensor, Tensor, Tensor)",
}
NVCC = "/usr/local/cuda/bin/nvcc"   # a path for the command lines only
KERNELS_DIR = Path(_build.__file__).parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_each_schema_is_the_one_python_declared(name):
    op = getattr(torch.ops.tpu3dssf, name).default
    assert str(op._schema) == SCHEMAS[name]


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_each_op_is_defined_in_the_schema_library(name):
    """Defined by ops_schema.cpp, with CPU and fake kernels from Python."""
    qual = f"tpu3dssf::{name}"
    op = getattr(torch.ops.tpu3dssf, name).default
    where = op._handle.debug()
    assert f"csrc/{_build.SCHEMA_SOURCE}" in where, where
    assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CPU")
    from torch._library.simple_registry import singleton
    assert singleton.find(qual).fake_impl.kernel is not None


def test_the_schema_source_defines_seven_ops_and_no_kernel():
    src = (_build.CSRC_DIR / _build.SCHEMA_SOURCE).read_text()
    ops = src.split("TORCH_LIBRARY(tpu3dssf, m) {")[1].split("\n}\n")[0]
    assert ops.count("m.def(") == len(SCHEMAS)
    assert "m.impl" not in src and "cuda" not in src.split("#include")[1]
    assert 'm.set_python_module("tpu3dssf_torch.kernels.ops")' in src


def test_the_schema_library_is_built_here_and_loaded():
    path = _build.schema_library_path()
    assert path.exists() and path in _build.loaded_libraries()
    assert path.parent == _build.BUILD_DIR
    assert not _build.cuda_library_loaded() or torch.cuda.is_available()


def test_no_kernel_module_binds_a_library_through_ctypes():
    for path in sorted(KERNELS_DIR.glob("*.py")):
        tree = ast.parse(path.read_text())
        imported = {a.name.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
        imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
        assert "ctypes" not in imported, path.name


@pytest.mark.parametrize("source", _build.KERNEL_SOURCES)
def test_kernel_sources_compile_for_sm90a_without_torch(source):
    cmd = _build.object_command(source, Path("/x/out.o"), nvcc=NVCC)
    assert cmd[0] == NVCC and "arch=compute_90a,code=sm_90a" in cmd
    assert "-c" in cmd and str(_build.CSRC_DIR / source) in cmd
    assert not any(c.startswith("-I") for c in cmd)   # no torch header


def test_the_cuda_ops_compile_against_torch_and_the_toolkit():
    cmd = _build.object_command(_build.CUDA_OPS_SOURCE, Path("/x/o.o"),
                                nvcc=NVCC, cxx="g++")
    abi = int(torch.compiled_with_cxx11_abi())
    assert cmd[0] == "g++" and f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    from torch.utils.cpp_extension import include_paths
    assert all(f"-I{p}" in cmd for p in include_paths())
    assert "-I/usr/local/cuda/include" in cmd and "-fPIC" in cmd


def test_the_cuda_library_links_torch_with_an_rpath():
    objs = [Path(f"/x/{i}.o") for i in range(4)]
    cmd = _build.link_command(objs, Path("/x/lib.so"), nvcc=NVCC, cxx="g++")
    lib = _build.torch_lib_dir()
    assert cmd[:4] == ["g++", "-shared", "-o", "/x/lib.so"]
    assert f"-L{lib}" in cmd and f"-Wl,-rpath,{lib}" in cmd
    for x in ("torch", "torch_cpu", "torch_cuda", "c10", "c10_cuda",
              "cudart_static"):
        assert f"-l{x}" in cmd
    assert "-L/usr/local/cuda/lib64" in cmd
    assert all(str(o) in cmd for o in objs)


def test_the_schema_library_and_the_runner_link_torch_not_python():
    lib = _build.torch_lib_dir()
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"
    for cmd in (_build.schema_command(Path("/x/s.so"), cxx="g++"),
                _build.runner_command(Path("/x/r"), cxx="g++")):
        assert cmd[0] == "g++" and f"-Wl,-rpath,{lib}" in cmd and abi in cmd
        assert not any(c.startswith("-lpython") or "libpython" in c
                       for c in cmd)


def test_the_host_compiler_links_openmp_for_aotinductor(monkeypatch):
    """``find_cxx`` picks a compiler that links ``-fopenmp`` (AOTInductor
    links its packages so), and ``compile_infer_package`` hands it on."""
    cxx = _build.find_cxx()
    res = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o",
                          "/dev/null"], input="int main() { return 0; }",
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    from tpu3dssf_torch import export
    seen = {}
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        lambda program, package_path, inductor_configs:
                        seen.update(inductor_configs) or package_path)
    assert export.compile_infer_package(torch.nn.Linear(2, 2),
                                        (torch.ones(1, 2),), "p.pt2") \
        == "p.pt2"
    assert seen["cpp.cxx"] == (cxx,)


def test_library_names_change_with_torch_and_its_abi(monkeypatch):
    paths = (_build.schema_library_path, _build.cuda_library_path,
             _build.runner_path,
             lambda: _build.object_path(_build.CUDA_OPS_SOURCE),
             lambda: _build.object_path("knn.cu"))
    before = [f() for f in paths]
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    other = [f() for f in paths]
    assert all(a != b for a, b in zip(before, other))
    other_abi = not torch.compiled_with_cxx11_abi()
    monkeypatch.setattr(torch, "compiled_with_cxx11_abi", lambda: other_abi)
    assert all(a != b for a, b in zip(other, [f() for f in paths]))


def test_the_runner_compiles_here_without_cuda_headers_or_python():
    src = (_build.CSRC_DIR / _build.RUNNER_SOURCE).read_text()
    includes = [x for x in src.splitlines() if x.startswith("#include")]
    assert not any("cuda_runtime" in x or "c10/cuda" in x or "ATen/cuda"
                   in x or "Python" in x for x in includes)
    runner = _build.build_runner()
    ldd = subprocess.run(["ldd", str(runner)], capture_output=True,
                         text=True, check=True).stdout
    assert "libtorch_cpu" in ldd and "libpython" not in ldd
    res = subprocess.run([str(runner)], capture_output=True, text=True)
    assert res.returncode == 2 and "usage" in res.stderr


def test_counters_live_in_python_where_no_cuda_library_is_loaded():
    if _build.cuda_library_loaded():
        pytest.skip("the CUDA library is loaded: its counters are C++")
    before = modules.launch_counts()
    try:
        modules.set_launch_counts({"K3": before["K3"] + 1, "K7": 11})
        assert modules.launch_counts() == dict(before, K3=before["K3"] + 1,
                                               K7=11)
        assert (fa.BWD_LAUNCHES, knn.LAUNCHES) == (before["K3"] + 1, 11)
        assert wa.LAUNCHES == before["K6"]
        with pytest.raises(KeyError):
            modules.set_launch_counts({"K10": 1})
        with pytest.raises(AttributeError):
            fa.NO_SUCH_LAUNCHES
    finally:
        modules.set_launch_counts(before)


@pytest.mark.parametrize("dtype", sorted(
    {"float32", "bfloat16", "int32", "int64", "bool", "uint8"}))
def test_raw_tensor_files_round_trip(tmp_path, dtype):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 3, 5, generator=gen) * 40).to(
        getattr(torch, dtype))
    write_raw(tmp_path / "x.raw", x[:, ::2])           # a strided view
    y = read_raw(tmp_path / "x.raw")
    assert y.dtype == x.dtype and torch.equal(y, x[:, ::2])
    header = (tmp_path / "x.raw").read_bytes().split(b"\n", 1)[0]
    assert header == f"tpu3dssf-raw {dtype} 3 2 2 5".encode()
