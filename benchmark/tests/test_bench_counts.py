"""The yardstick's counts redone by hand: ViT-S/16, ViT-L/16 and PTv3
FLOPs and bytes, windows of valid tokens, the k-NN bound, the valid tokens
of each stage of a hand-made cloud."""

import itertools

import pytest
import torch

from benchmark.harness import counts as C
from benchmark.reference.widths import PTv3Widths, encoder

PEAK, HBM, F32 = 989e12, 3.35e12, 67e12


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (C.BF16_FLOPS, C.F32_FLOPS, C.HBM_BYTES) == (PEAK, F32, HBM)


def test_windows_of_valid_tokens():
    assert C.windows(2048, 1024) == [1024, 1024]
    assert C.windows(2500, 1024) == [1024, 1024, 452]
    assert C.windows(300, 1024) == [300]
    assert C.windows(0, 1024) == []


@pytest.mark.parametrize("name,D,L,H", [("dinov3", 384, 12, 6),
                                            ("dinov3_large", 1024, 24, 16)])
def test_vit_by_hand(name, D, L, H):
    N, Np = 2845, 2840
    attn = 4 * N * N * D
    dense = 2 * N * 12 * D * D
    flops = 2 * Np * 768 * D + L * (attn + dense)
    w = C.vit_work(6, encoder(name))
    assert w.flops == pytest.approx(6 * flops, rel=1e-12)
    one = max(attn / PEAK, N * (8 * D + 4) / HBM)
    assert w.attn_s == pytest.approx(6 * L * one, rel=1e-12)
    assert w.attn_exp_s == pytest.approx(
        6 * L * H * N * N / (16 * 132 * 1980e6), rel=1e-12)
    # the ViT's attention is bound by its products, not its bytes
    assert attn / PEAK > N * (8 * D + 4) / HBM


def test_ptv3_block_by_hand():
    s = PTv3Widths()
    w = C.block_work(1500, 32, 2, s)
    attn = 4 * 32 * (1024 ** 2 + 476 ** 2)
    assert w.flops == 2 * 1500 * 13 * 32 * 32 + attn
    assert w.attn_s == pytest.approx(max(attn / PEAK,
                                         1500 * (8 * 32 + 4) / HBM))


def test_ptv3_by_hand():
    n = [25600, 13312, 7168, 4096, 2048]
    enc_c, dec_c = (32, 64, 128, 256, 512), (64, 64, 128, 256)
    enc_d, dec_d = (2, 2, 2, 6, 2), (2, 2, 2, 2)

    def block(m, c):
        full, rest = divmod(m, 1024)
        return 2 * m * 13 * c * c + 4 * c * (full * 1024 ** 2 + rest ** 2)

    flops = 2 * n[0] * 4 * 32
    for st in range(5):
        if st:
            flops += 2 * n[st - 1] * enc_c[st - 1] * enc_c[st]
        flops += enc_d[st] * block(n[st], enc_c[st])
    for d in (3, 2, 1, 0):
        coarse = 512 if d == 3 else dec_c[d + 1]
        flops += 2 * (n[d + 1] * coarse + n[d] * enc_c[d]) * dec_c[d]
        flops += dec_d[d] * block(n[d], dec_c[d])
    assert C.ptv3_work(n, PTv3Widths()).flops == pytest.approx(flops,
                                                                rel=1e-12)


def test_heads_and_knn_by_hand():
    assert C.head_work(100, (448, 256, 64, 16)).flops == 2 * 100 * (
        448 * 256 + 256 * 64 + 64 * 16)
    assert C.head_work(100, (64, 16)).flops == 2 * 100 * 64 * 16
    w = C.knn_work(30000, 32000, 5)
    assert w.knn_s == pytest.approx(max(
        9 * 30000 * 32000 / F32,
        (30000 * 12 + 32000 * 13 + 30000 * 5 * 8) / HBM))


def test_stage_tokens_of_a_hand_made_cloud():
    # eight points in eight 0.1 m voxels of one 0.2 m cell, one far point
    pts = [[0.05 + 0.1 * i, 0.05 + 0.1 * j, 0.05 + 0.1 * k, 0.5]
           for i, j, k in itertools.product((0, 1), repeat=3)]
    pts += [[5.05, 5.05, 5.05, 0.5]]
    P = 16
    points = torch.zeros((1, P, 4))
    points[0, :9] = torch.tensor(pts)
    valid = torch.zeros((1, P), dtype=torch.bool)
    valid[0, :9] = True
    assert C.stage_tokens(points, valid, 0.1, 16, 16) == [[9, 2, 2, 2, 2]]
    # at capacity 8 the far voxel (last in cell-key order) is dropped
    assert C.stage_tokens(points, valid, 0.1, 8, 16) == [[8, 1, 1, 1, 1]]
