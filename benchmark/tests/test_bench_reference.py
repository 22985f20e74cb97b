"""The plain reference against the program's plain path (its kernels'
CPU versions) in float32 at a tiny size, on the benchmark's own inputs and
weights; and the float8 control visibly off."""

import dataclasses

import pytest
import torch

from benchmark.harness import weights as W
from benchmark.reference import nn as rnn
from benchmark.reference import widths
from benchmark.reference.models import Segmentation, loss_and_counts
from benchmark.reference.vit import ViT, ViTConfig, preprocess
from benchmark.traffic.generator import make_pool

TRAFFIC = {"batch": 2, "pool": 2, "valid_points": 2800}


def _pair(program_cls, fusion, modes, seed):
    from tpu3dssf_torch.models.fusion import FusionConfig, PipelineConfig
    from tpu3dssf_torch.models.ptv3 import PTv3Config
    cfg = PipelineConfig(fusion=FusionConfig(), ptv3=PTv3Config(),
                         voxel_size=0.1, voxel_capacity=2048,
                         intensity_mode=modes[0], devoxelize_mode=modes[1])
    table = widths.of(_Config("dinov3" if fusion else "none"))
    with torch.device("meta"):
        w = W.make_weights(Segmentation(table, 0.1, 2048, *modes), seed,
                           "cpu")
    prog = W.load(program_cls(cfg), w)
    ref = W.load(Segmentation(table, 0.1, 2048, *modes), w)
    return prog, ref


class _Config:
    """The fields of the program's Config that the width table reads."""

    def __init__(self, encoder, window=1024, classes=16):
        self.image_encoder, self.mlp_class = encoder, classes
        self.tpu = type("Tpu", (), {"window_size": window})()


def test_width_table_follows_the_configuration():
    from tpu3dssf_torch.models.vit import dinov3_large
    large = widths.of(_Config("dinov3_large", window=512, classes=20))
    p = dinov3_large()
    assert (large.vit.hidden_size, large.vit.num_layers,
            large.vit.num_heads, large.vit.patch_size,
            large.vit.image_size) == (p.hidden_size, p.num_layers,
                                       p.num_heads, p.patch_size,
                                       p.image_size)
    assert large.head == (64 + 1024, 256, 64, 20)
    assert large.ptv3.window == 512
    assert widths.of(_Config("none")).head == (64, 16)
    with pytest.raises(NotImplementedError):
        widths.of(_Config("dinov2"))
    # weights drawn at other widths than the model's fail the load
    narrow = ViTConfig(hidden_size=256, num_heads=4, num_layers=1)
    w = W.make_weights(ViT(narrow), 1, "cpu")
    with pytest.raises(ValueError):
        W.load(ViT(ViTConfig(num_layers=1)), w)


@pytest.mark.parametrize("modes", [("mean", "own"), ("knn5", "nearest")])
def test_lidar_model_matches_program(modes):
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.metrics import confusion_matrix
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    b = make_pool(TRAFFIC, 2 ** 33 + 5, 4096, "cpu", cameras=False)[0]
    prog, ref = _pair(LidarSegmentationModel, False, modes, 11)
    with torch.no_grad():
        a = prog(b["points"], b["point_valid"])
        r = ref(b["points"], b["point_valid"])
    assert (a - r).abs().max() <= 1e-5 * r.abs().max()
    out = CELSLoss()(a, b["labels"], b["mask"])
    loss, valid, cm = loss_and_counts(r, b["labels"], b["mask"], [1.0] * 16,
                                      1.0)
    assert float(out.total) == pytest.approx(float(loss), rel=1e-5)
    assert int(out.num_valid) == valid
    assert torch.equal(confusion_matrix(out.predictions, b["labels"], 16,
                                        out.valid), cm)


def test_vit_and_fusion_match_program():
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.vit import (VisionTransformer, dinov3_small,
                                           fold_layerscale)
    from tpu3dssf_torch.train.loop import make_image_encode_fn
    b = make_pool(dict(TRAFFIC, batch=1, pool=1), 77, 4096, "cpu",
                  cameras=True)[0]
    vc = dataclasses.replace(dinov3_small(), num_layers=2)
    with torch.device("meta"):
        w = W.make_weights(ViT(ViTConfig(num_layers=2)), 3, "cpu")
    rv = W.load(ViT(ViTConfig(num_layers=2)), w)
    pv = W.load(VisionTransformer(vc), w)
    fold_layerscale(pv)
    tok_p = make_image_encode_fn(pv, vc.image_size, torch.float32)(
        b["images"])
    with torch.no_grad():
        tok_r = rv(preprocess(b["images"][0], (640, 1138)))[None]
    assert (tok_p - tok_r).abs().max() <= 1e-5 * tok_r.abs().max()
    prog, ref = _pair(SegmentationPipeline, True, ("mean", "own"), 8)
    args = (b["points"], b["point_valid"], tok_r, b["cam_intrinsics"],
            b["lidar2cam"])
    with torch.no_grad():
        a, r = prog(*args), ref(*args)
        with rnn.lower_precision():
            r8 = ref(*args)
    assert (a - r).abs().max() <= 1e-5 * r.abs().max()
    assert (r8 - r).abs().max() >= 1e-2 * r.abs().max()


def test_control_rounds_gradients_with_their_own_scales():
    x = torch.randn(8, 64, requires_grad=True)
    g = torch.randn(8, 64) * 1e-5       # far below the forward's scale
    with rnn.lower_precision():
        y = rnn.stored(x * 1.0)
    y.backward(g)
    assert (y - x).abs().max() > 0                 # the forward is rounded
    assert (x.grad - g).abs().max() > 0            # and the gradient
    assert (x.grad - g).abs().max() <= 2 ** -3 * g.abs().amax()
    assert (x.grad != 0).float().mean() > 0.9      # not flushed to zero
