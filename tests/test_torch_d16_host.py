"""Host-side logic of the D = 16 attention backward: the key blocks and
the dq scratch that the op's C++ kernel (csrc/ops_cuda.cpp) hands the
kernel, and their agreement with the constants of the CUDA source (which
only the card compiles; tests/test_torch_cuda.py and chip_smoke.py check
the built library's value). The scratch's sizing (csrc/dq_scratch.h) is
shared with the schema library, which serves it here as
``tpu3dssf_host::dq_scratch``."""

import re
from pathlib import Path

import pytest
import torch

from tpu3dssf_torch.kernels.modules import flash_attention as fa

SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / fa._BWD_SOURCE
OPS_SOURCE = SOURCE.with_name("ops_cuda.cpp")
SCRATCH_SOURCE = SOURCE.with_name("dq_scratch.h")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constant(name):
    """An ``int`` constexpr of the source's d16 namespace."""
    d16 = SOURCE.read_text().split("namespace d16 {", 1)[1]
    d16 = d16.split("}  // namespace d16", 1)[0]
    return re.search(rf"constexpr int {name} = ([^;]+);", d16).group(1)


def test_block_constants_match_the_cuda_source():
    assert int(_constant("kWarps")) * int(_constant("kWarpKeys")) \
        == fa.D16_BWD_KEYS == 256
    assert _constant("kBlockKeys") == "kWarps * kWarpKeys"
    assert int(_constant("kSmallN")) == fa.D16_SMALL_N == 64
    assert ("constexpr int64_t kD16SmallN = 64;"
            in SCRATCH_SOURCE.read_text())


def test_the_cuda_op_takes_the_shared_scratch_with_the_kernels_block():
    """ops_cuda.cpp allocates the scratch that dq_scratch.h sizes (the
    function the tests below call), with the built kernel's key block."""
    src = OPS_SOURCE.read_text()
    assert '#include "dq_scratch.h"' in src
    body = src.split("Tensor dq_scratch(const Tensor& q) {")[1]
    body = body.split("\n}\n")[0]
    assert "tpu3dssf::dq_scratch(q.size(0), q.size(1), q.size(2), " \
        "q.size(3),\n" in body
    assert "fa_backward_d16_block_keys(), q.options());" in body


def dq_scratch(B, N, H, D, device):
    """The scratch that the CUDA op hands the backward for q of shape (B,
    N, H, D), with the D = 16 key block of the wrappers, on ``device``;
    None where it takes none."""
    return torch.ops.tpu3dssf_host.dq_scratch(B, N, H, D, fa.D16_BWD_KEYS,
                                              device)


@pytest.mark.parametrize("N,blocks", [(1, 1), (48, 1), (64, 1), (65, 1),
                                      (256, 1), (257, 2), (1000, 4),
                                      (1024, 4), (1100, 5), (2100, 9)])
def test_key_blocks(N, blocks):
    assert fa.d16_key_blocks(N) == blocks


@pytest.mark.parametrize("N", [1, 48, 64, 65, 256])
def test_no_scratch_where_one_block_writes_dq(N):
    assert dq_scratch(4, N, 8, 16, torch.device("cpu")) is None


@pytest.mark.parametrize("B,N,H", [(2, 257, 1), (68, 1024, 2), (6, 2100, 32)])
def test_scratch_holds_one_partial_per_key_block(B, N, H):
    x = dq_scratch(B, N, H, 16, torch.device("cpu"))
    assert x.dtype == torch.float32 and x.is_contiguous()
    assert tuple(x.shape) == (B, H, fa.d16_key_blocks(N), N, 16)


def test_d64_scratch_is_zeroed_and_padded_to_64_rows():
    x = dq_scratch(2, 77, 6, 64, torch.device("cpu"))
    assert tuple(x.shape) == (2, 6, 128, 64)
    assert x.dtype == torch.float32 and not x.any()
