"""Build the port's CUDA sources with nvcc at first use and load them.

Each source under ``tpu3dssf_torch/csrc/`` exposes a plain C interface and
is compiled on its own into a shared library (no PyTorch headers, so a
build takes seconds), then bound with :mod:`ctypes`. Libraries go to
``build/tpu3dssf_torch/`` at the repository root, named by a hash of the
source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu3dssf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# source name -> {"seconds": compile time (0.0 when reused), "log": ptxas}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else ``$CUDA_HOME/bin``; raises when neither has
    one."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of tpu3dssf_torch are compiled from source at first use")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its library is missing, then load it.

    nvcc runs outside the lock, into a file of its own that is renamed into
    place, so callers on several threads build several sources at once."""
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib
    so = library_path(source)
    info = {"seconds": 0.0, "log": ""}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(
            f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{info['log']}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(so))
            BUILD_INFO[source] = info
        return _libs[source]
