"""Build the port's C++ and CUDA sources at first use and load them.

Three build outputs, each under ``build/tpu3dssf_torch/`` at the
repository root and named by a hash of its sources, the flags, the torch
version and torch's C++ ABI flag, so an edited source, another torch or
another ABI rebuilds and an unchanged one is reused:

* the schema library (``csrc/ops_schema.cpp``, the host C++ compiler): the
  ``tpu3dssf::`` operators' schemas, and ``tpu3dssf_host::dq_scratch``
  (``csrc/dq_scratch.h``, the backward's scratch sizing that the CUDA
  library shares). :mod:`tpu3dssf_torch.kernels.ops` builds and loads it at import, on any
  machine, before it registers their CPU and fake kernels;
* the CUDA library: the kernel sources (``csrc/*.cu``, nvcc for sm_90a, no
  torch headers, one nvcc process each, all started together) and
  ``csrc/ops_cuda.cpp`` (the host compiler against torch's and the CUDA
  toolkit's headers: the operators' CUDA kernels and the launch counters),
  linked into one shared library against torch's ``lib/``. ``ops`` loads
  it at import where a card is present;
* ``aoti_runner`` (``csrc/aoti_runner.cpp``): a program linked against
  libtorch, without Python, that runs an AOTInductor package.

The compilers are called directly: ``torch.utils.cpp_extension.load``
would need ninja. Each output is written under a name of its own and
renamed into place, so processes that build the same output at once agree.
The Hopper kernels encode their TMA tensor maps with the
``cuTensorMapEncodeTiled`` that the CUDA runtime hands out
(``cudaGetDriverEntryPoint``), so nothing links ``-lcuda``.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu3dssf_torch"
KERNEL_SOURCES = ("flash_attention_packed.cu", "flash_attention_packed_bwd.cu",
                  "knn.cu", "layer_norm.cu")
SCHEMA_SOURCE = "ops_schema.cpp"
CUDA_OPS_SOURCE = "ops_cuda.cpp"
RUNNER_SOURCE = "aoti_runner.cpp"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}
# build step (a source, or "link") -> {"seconds": its time (0.0 when the
# output was reused), "log": the compiler's output}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else ``$CUDA_HOME/bin``, else the toolkit's default
    place; raises when none has one."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda: "
        "the CUDA kernels of tpu3dssf_torch are compiled from source at "
        "first use")


@functools.cache
def find_cxx() -> str:
    """The host C++ compiler: the first of ``$CXX``, g++ and c++ on PATH
    that links an OpenMP program (AOTInductor links its packages with
    ``-fopenmp``), else the first of them found."""
    found = [shutil.which(n) for n in (os.environ.get("CXX"), "g++", "c++")
             if n and shutil.which(n)]
    if not found:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++): the "
                           "tpu3dssf operators' schema library is compiled "
                           "from source at first import")
    for cxx in found:
        res = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o",
                              os.devnull], input="int main() { return 0; }",
                             capture_output=True, text=True)
        if res.returncode == 0:
            return cxx
    return found[0]


def torch_lib_dir() -> str:
    return str(Path(torch.__file__).resolve().parent / "lib")


def abi_define() -> str:
    return f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"


def torch_cxx_flags() -> list:
    """Flags of a host compile against torch's headers."""
    from torch.utils.cpp_extension import include_paths
    return [*CXX_FLAGS, abi_define(), *(f"-I{p}" for p in include_paths())]


def torch_link_flags(libs) -> list:
    """``-L``, an rpath and ``-l`` for each of torch's ``libs``."""
    lib = torch_lib_dir()
    return [f"-L{lib}", f"-Wl,-rpath,{lib}", *(f"-l{x}" for x in libs)]


def fingerprint(*parts) -> str:
    """A hash of ``parts`` (bytes or str), the torch version and the ABI
    flag."""
    h = hashlib.sha256()
    for p in (*parts, torch.__version__, abi_define()):
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _read(name) -> bytes:
    return (CSRC_DIR / name).read_bytes()


def _headers() -> bytes:
    """The headers that sources include (``*.cuh``, ``*.h``)."""
    return b"".join(h.read_bytes() for h in sorted(
        [*CSRC_DIR.glob("*.cuh"), *CSRC_DIR.glob("*.h")]))


def schema_library_path() -> Path:
    digest = fingerprint(_read(SCHEMA_SOURCE), _headers(), *CXX_FLAGS)
    return BUILD_DIR / f"ops_schema-{digest}.so"


def schema_command(out, cxx=None) -> list:
    return [cxx or find_cxx(), *torch_cxx_flags(), "-shared",
            str(CSRC_DIR / SCHEMA_SOURCE), "-o", str(out),
            *torch_link_flags(("c10", "torch_cpu"))]


def object_path(source) -> Path:
    """The object file of a kernel source (hash of it, the headers and the
    flags) or of ``ops_cuda.cpp`` (hash of it, the headers and the
    flags)."""
    if source.endswith(".cu"):
        digest = fingerprint(_read(source), _headers(), *NVCC_FLAGS)
    else:
        digest = fingerprint(_read(source), _headers(), *torch_cxx_flags())
    return BUILD_DIR / f"{Path(source).stem}-{digest}.o"


def cuda_library_path() -> Path:
    """The CUDA library, named by a hash of every source that goes in."""
    parts = [_read(s) for s in (*KERNEL_SOURCES, CUDA_OPS_SOURCE)]
    return BUILD_DIR / (f"tpu3dssf_cuda-"
                        f"{fingerprint(*parts, _headers(), *NVCC_FLAGS)}.so")


def cuda_include_dir(nvcc) -> str:
    return str(Path(nvcc).resolve().parent.parent / "include")


def object_command(source, out, nvcc=None, cxx=None) -> list:
    """The compile of one source of the CUDA library into ``out``."""
    if source.endswith(".cu"):
        return [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                str(CSRC_DIR / source)]
    return [cxx or find_cxx(), *torch_cxx_flags(),
            f"-I{cuda_include_dir(nvcc or find_nvcc())}", "-c",
            str(CSRC_DIR / source), "-o", str(out)]


def cuda_lib_dir(nvcc) -> str:
    return str(Path(nvcc).resolve().parent.parent / "lib64")


def link_command(objects, out, nvcc=None, cxx=None) -> list:
    """The objects linked into one library against torch's libraries, with
    the CUDA runtime linked statically, as nvcc links it by default."""
    return [cxx or find_cxx(), "-shared", "-o", str(out), *map(str, objects),
            *torch_link_flags(("torch", "torch_cpu", "torch_cuda", "c10",
                               "c10_cuda")),
            f"-L{cuda_lib_dir(nvcc or find_nvcc())}", "-lcudart_static",
            "-lrt", "-lpthread", "-ldl"]


def runner_path() -> Path:
    return BUILD_DIR / (f"aoti_runner-"
                        f"{fingerprint(_read(RUNNER_SOURCE), *CXX_FLAGS)}")


def runner_command(out, cxx=None) -> list:
    """The runner links libtorch and libdl, never libpython; where torch
    has its CUDA library, that is linked too (``--no-as-needed``), so the
    CUDA backend registers in a process without Python."""
    libs = ["torch", "torch_cpu", "c10"]
    cuda = (Path(torch_lib_dir()) / "libtorch_cuda.so").exists()
    return [cxx or find_cxx(), *torch_cxx_flags(),
            str(CSRC_DIR / RUNNER_SOURCE), "-o", str(out),
            *torch_link_flags(libs),
            *(["-Wl,--no-as-needed", "-ltorch_cuda", "-Wl,--as-needed"]
              if cuda else []), "-ldl"]


def _make(step, out, command):
    """``out``, built by ``command(path)`` (the command line that writes
    ``path``) unless it exists: into a file of its own, renamed into place
    (atomic: concurrent builds agree). Records the step in
    :data:`BUILD_INFO`."""
    if out.exists():
        with _lock:
            BUILD_INFO.setdefault(step, dict(seconds=0.0, log=""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp{out.suffix}")
    cmd = command(tmp)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    info = dict(seconds=time.perf_counter() - t0,
                log=res.stdout + res.stderr)
    with _lock:
        BUILD_INFO[step] = info
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {step} failed (exit {res.returncode}):"
                           f"\n{' '.join(cmd)}\n{info['log']}")
    os.replace(tmp, out)
    return out


def build_schema_library() -> Path:
    return _make(SCHEMA_SOURCE, schema_library_path(), schema_command)


def build_cuda_library() -> Path:
    """Compile every source of the CUDA library at once (one process each),
    then link them."""
    so = cuda_library_path()
    if so.exists():
        return _make("link", so, None)
    nvcc = find_nvcc()
    sources = (*KERNEL_SOURCES, CUDA_OPS_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        objects = list(pool.map(lambda s: _make(
            s, object_path(s), lambda o: object_command(s, o, nvcc)),
            sources))
    return _make("link", so, lambda o: link_command(objects, o, nvcc))


def build_runner() -> Path:
    return _make(RUNNER_SOURCE, runner_path(), runner_command)


def _load(name, build):
    with _lock:
        if name in _loaded:
            return _loaded[name]
    path = build()
    with _lock:
        if name not in _loaded:
            torch.ops.load_library(str(path))
            _loaded[name] = path
        return _loaded[name]


def load_schema_library() -> Path:
    """Build (once per machine) and load the schema library; returns its
    path."""
    return _load("schema", build_schema_library)


def load_cuda_library() -> Path:
    """Build (once per machine) and load the CUDA library; returns its
    path."""
    load_schema_library()
    return _load("cuda", build_cuda_library)


def cuda_library_loaded() -> bool:
    return "cuda" in _loaded


def loaded_libraries() -> list:
    """The paths of the libraries loaded in this process, schema first:
    what a process without Python loads to run a package."""
    return [_loaded[k] for k in ("schema", "cuda") if k in _loaded]
