"""Shared CLI wiring for the port: config → data, models, loss, state.

The host-side pieces (config loading, the synthetic dataset and its
loader, the dataset and loader builders, one example batch, the metric
logger, stdout tee and history plot) are the JAX package's own, which
import no JAX, re-exported here. The model build functions here make the
port's modules on an explicit ``device`` with seeded random weights (no
pretrained weights are loaded yet).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dssf.cli.common import (  # noqa: F401  (re-exported)
    build_dataloaders,
    build_datasets,
    example_batch,
)
from tpu3dssf.config import Config, load_config  # noqa: F401
from tpu3dssf.data import HostDataPipeline, SyntheticNuScenes  # noqa: F401
from tpu3dssf.utils.logging import create_logger, tee_stdout  # noqa: F401
from tpu3dssf.utils.viz import plot_training_history  # noqa: F401
from tpu3dssf_torch.models.ptv3 import _round_up

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(name: str) -> torch.device:
    """``--device`` → a torch device; raises for CUDA without a card (the
    CLIs never drop to the CPU on their own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            "--device cpu to run the plain PyTorch versions on the CPU)")
    return device


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.tpu.compute_dtype]


def build_image_encoder(cfg: Config, device, seed: int = 0):
    """Frozen ViT + encode fn on ``device``; returns (encode_fn, vit_cfg),
    or (None, None) for the LiDAR-only path.

    No pretrained weights are loaded yet: the ViT gets the seeded flax-
    style init, and its LayerScale (1e-5) is folded into the Dense weights
    as the JAX CLI does for its frozen encoder.
    """
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (VisionTransformer, dinov2_small,
                                           dinov3_large, dinov3_small,
                                           fold_layerscale)
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    if cfg.image_encoder == "none":
        return None, None
    dtype = compute_dtype(cfg)
    vit_cfg = {"dinov2": dinov2_small, "dinov3": dinov3_small,
               "dinov3_large": dinov3_large}[cfg.image_encoder]()
    vit_cfg = type(vit_cfg)(**{**vit_cfg.__dict__, "dtype": dtype})
    print(f"[cli] no pretrained {cfg.image_encoder} weights or checkpoints "
          "are loaded by the port yet — using seeded random weights")
    vit = init_weights(VisionTransformer(vit_cfg), seed)
    vit = fold_layerscale(vit).to(device).eval()
    encode = make_image_encode_fn(vit, vit_cfg.image_size, dtype)
    return encode, vit_cfg


def build_pipeline(cfg: Config, vit_cfg=None, device="cpu", seed: int = 1):
    """The fusion ``SegmentationPipeline`` on ``device`` with seeded
    weights; returns (model, PipelineConfig)."""
    from tpu3dssf_torch.models.fusion import (FusionConfig, PipelineConfig,
                                              SegmentationPipeline)
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.ptv3 import PTv3Config

    if cfg.image_encoder == "none":
        raise NotImplementedError(
            "the LiDAR-only model is not ported yet (ROADMAP.md, H100 port)")
    dtype = compute_dtype(cfg)
    w = cfg.tpu.window_size
    fusion = FusionConfig(patch_tok_dim=vit_cfg.hidden_size,
                          patch_size=vit_cfg.patch_size,
                          encoder_size=vit_cfg.image_size,
                          output_dim=cfg.mlp_class, dtype=dtype)
    pipe = PipelineConfig(
        fusion=fusion,
        ptv3=PTv3Config(enc_window=(w,) * 5, dec_window=(w,) * 4,
                        use_pallas=cfg.tpu.use_pallas, remat=cfg.tpu.remat,
                        remat_attention=cfg.tpu.remat_attention,
                        drop_path=cfg.drop_path, dtype=dtype),
        voxel_size=cfg.voxel_size,
        voxel_capacity=_round_up(cfg.tpu.voxel_capacity, w),
        intensity_mode=cfg.tpu.intensity_mode,
        devoxelize_mode=cfg.tpu.devoxelize_mode,
    )
    model = init_weights(SegmentationPipeline(pipe), seed)
    return model.to(device).eval(), pipe


def init_state(cfg: Config, model, steps_per_epoch: int = 1):
    """The train state over ``model``'s parameters with the config's
    optimizer, schedule, clip and non-finite guard."""
    from tpu3dssf_torch.train.state import TrainState, create_optimizer
    opt = create_optimizer(
        model.parameters(), cfg.optimizer, cfg.learning_rate,
        weight_decay=cfg.weight_decay, momentum=cfg.momentum,
        nesterov=cfg.nesterov, lr_scheduler=cfg.lr_scheduler,
        steps_per_epoch=steps_per_epoch, num_epochs=cfg.max_num_epochs,
        grad_clip=cfg.grad_clip, skip_nonfinite=cfg.skip_nonfinite)
    return TrainState(model, opt)


def build_loss(cfg: Config):
    from tpu3dssf_torch.losses import CELSLoss
    weights = (np.asarray(cfg.class_weights, np.float32)
               if cfg.class_weights else None)
    return CELSLoss(weight=weights, ignore_index=0,
                    lamda_lovasz=cfg.lambda_lovasz)


def zero_tokens(cfg: Config, vit_cfg, batch_size: int, device="cpu"):
    """Placeholder patch tokens (the LiDAR-only path ignores them)."""
    if vit_cfg is None:
        return torch.zeros((batch_size, 1, 1, 1), device=device)
    return torch.zeros((batch_size, 6, vit_cfg.num_patches,
                        vit_cfg.hidden_size), device=device)


def batch_to_device(batch, device):
    """Host numpy batch → tensors on ``device`` (images stay on the host
    side of the caller)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}
