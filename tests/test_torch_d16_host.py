"""Host-side logic of the D = 16 attention backward: the key blocks and the
dq scratch that ``_launch_flash_bwd`` hands the kernel, and their
agreement with the constants of the CUDA source (which only the card
compiles; tests/test_torch_cuda.py checks the built library's value)."""

import re
from pathlib import Path

import pytest
import torch

from tpu3dssf_torch.kernels.modules import flash_attention as fa

SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / fa._BWD_SOURCE


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


@pytest.mark.parametrize("N,blocks", [(1, 1), (48, 1), (64, 1), (65, 1),
                                      (256, 1), (257, 2), (1000, 4),
                                      (1024, 4), (1100, 5), (2100, 9)])
def test_key_blocks(N, blocks):
    assert fa.d16_key_blocks(N) == blocks


@pytest.mark.parametrize("N", [1, 48, 64, 65, 256])
def test_no_scratch_where_one_block_writes_dq(N):
    assert fa.dq_scratch(4, N, 8, 16, torch.device("cpu")) is None


@pytest.mark.parametrize("B,N,H", [(2, 257, 1), (68, 1024, 2), (6, 2100, 32)])
def test_scratch_holds_one_partial_per_key_block(B, N, H):
    x = fa.dq_scratch(B, N, H, 16, torch.device("cpu"))
    assert x.dtype == torch.float32 and x.is_contiguous()
    assert tuple(x.shape) == (B, H, fa.d16_key_blocks(N), N, 16)


def test_d64_scratch_is_zeroed_and_padded_to_64_rows():
    x = fa.dq_scratch(2, 77, 6, 64, torch.device("cpu"))
    assert tuple(x.shape) == (2, 6, 128, 64)
    assert x.dtype == torch.float32 and not x.any()
