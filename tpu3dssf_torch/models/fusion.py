"""Cross-modal fusion head + the full segmentation pipeline, in PyTorch.

Port of ``tpu3dssf.models.fusion``: project voxel centroids
into all cameras, gather one ViT token per (camera, voxel), masked mean
over valid cameras, concat with the PTv3 voxel feature, MLP to class
logits, devoxelize to points. Submodules are named as in flax
(``ptv3``, ``fusion.mlp0``, ``fusion.mlp_out``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from tpu3dssf_torch.geometry import (
    multi_camera_projector,
    pixel_to_patch_index,
    scale_pixel_coords,
)
from tpu3dssf_torch.models.layers import Dense
from tpu3dssf_torch.models.ptv3 import PointTransformerV3, PTv3Config
from tpu3dssf_torch.utils.timing import span
from tpu3dssf_torch.voxel import (
    devoxelize_nearest,
    devoxelize_own_voxel,
    voxelize,
)


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    point_feat_dim: int = 64
    patch_tok_dim: int = 384
    hidden_dims: Tuple[int, ...] = (256, 64)
    output_dim: int = 16
    patch_size: int = 16
    encoder_size: Tuple[int, int] = (640, 1138)   # (H, W)
    raw_image_size: Tuple[int, int] = (900, 1600)
    dtype: torch.dtype = torch.float32

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return (self.encoder_size[0] // self.patch_size,
                self.encoder_size[1] // self.patch_size)


def gather_camera_features(patch_tokens, voxel_xyz, cam_intrinsics,
                           lidar2cam, cfg: FusionConfig):
    """Per-voxel fused image feature over all cameras.

    Args:
      patch_tokens: (B, N_cam, M, D) ViT patch tokens.
      voxel_xyz: (B, V, 3) voxel centroids (LiDAR frame).
      cam_intrinsics: (B, N_cam, 3, 3); lidar2cam: (B, N_cam, 4, 4).

    Returns:
      fused (B, V, D) in patch_tokens.dtype; cam_valid (B, N_cam, V).
    """
    gh, gw = cfg.grid_hw
    pix, _, valid = multi_camera_projector(
        voxel_xyz, cam_intrinsics, lidar2cam, cfg.raw_image_size)
    pix = scale_pixel_coords(pix, cfg.raw_image_size, cfg.encoder_size)
    flat_idx = pixel_to_patch_index(pix, cfg.patch_size, gh, gw)

    B, V = voxel_xyz.shape[:2]
    n_cam, D = patch_tokens.shape[1], patch_tokens.shape[-1]
    dtype = patch_tokens.dtype
    # camera by camera: no (B, N_cam, V, D) gather is materialised
    acc = torch.zeros((B, V, D), dtype=dtype, device=patch_tokens.device)
    cnt = torch.zeros((B, V, 1), dtype=dtype, device=patch_tokens.device)
    for c in range(n_cam):
        g = torch.gather(patch_tokens[:, c], 1,
                         flat_idx[:, c][..., None].expand(-1, -1, D))
        w = valid[:, c][..., None].to(dtype)
        acc = acc + g * w
        cnt = cnt + w
    return acc / cnt.clamp_min(1.0), valid


class FeatureFusionModel(nn.Module):
    """The fusion head: projection-gather-pool + MLP."""

    def __init__(self, config: FusionConfig):
        super().__init__()
        self.config = config
        dims = ((config.point_feat_dim + config.patch_tok_dim,)
                + tuple(config.hidden_dims))
        for i in range(len(config.hidden_dims)):
            self.add_module(f"mlp{i}", Dense(dims[i], dims[i + 1],
                                             config.dtype))
        self.mlp_out = Dense(dims[-1], config.output_dim, config.dtype)

    def forward(self, patch_tokens, voxel_features, voxel_raw, voxel_mask,
                cam_intrinsics, lidar2cam):
        cfg = self.config
        fused_img, _ = gather_camera_features(
            patch_tokens, voxel_raw[..., :3], cam_intrinsics, lidar2cam, cfg)
        x = torch.cat([voxel_features, fused_img.to(voxel_features.dtype)],
                      dim=-1)
        for i in range(len(cfg.hidden_dims)):
            x = torch.relu(getattr(self, f"mlp{i}")(x))
        return self.mlp_out(x) * voxel_mask[..., None]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    fusion: FusionConfig = FusionConfig()
    ptv3: PTv3Config = PTv3Config()
    voxel_size: float = 0.1
    voxel_capacity: int = 32768
    intensity_mode: str = "mean"
    devoxelize_mode: str = "own"


class SegmentationPipeline(nn.Module):
    """LiDAR points + camera patch tokens → per-point class logits:
    voxelize → PTv3 → fusion head → devoxelize.

    ``keep`` holds PTv3's DropPath masks (``PointTransformerV3.
    draw_keep``); None (the default) is JAX's ``deterministic=True``. The
    patch tokens come from the frozen encoder (under
    ``torch.inference_mode``): no learnable op may touch them before they
    are gathered, since autograd cannot save inference tensors.
    """

    def __init__(self, config: PipelineConfig):
        super().__init__()
        self.config = config
        self.ptv3 = PointTransformerV3(config.ptv3)
        self.fusion = FeatureFusionModel(config.fusion)

    def forward(self, points, point_mask, patch_tokens, cam_intrinsics,
                lidar2cam, keep=None):
        cfg = self.config
        with span("forward", points):
            with span("voxelize", points):
                vox = voxelize(points, point_mask, cfg.voxel_size,
                               cfg.voxel_capacity,
                               intensity_mode=cfg.intensity_mode)
            with span("ptv3", points):
                voxel_feats, voxel_mask = self.ptv3(
                    vox.voxel_raw, vox.voxel_coords, vox.voxel_mask, keep)
            with span("head", points):
                voxel_scores = self.fusion(patch_tokens, voxel_feats,
                                           vox.voxel_raw, voxel_mask,
                                           cam_intrinsics, lidar2cam)
            with span("devoxelize", points):
                if cfg.devoxelize_mode == "own":
                    point_scores, _ = devoxelize_own_voxel(
                        vox.point_voxel, vox.point_ok, voxel_scores)
                elif cfg.devoxelize_mode == "nearest":
                    point_scores, _ = devoxelize_nearest(
                        points[..., :3], point_mask, vox.voxel_raw[..., :3],
                        vox.voxel_mask, voxel_scores)
                else:
                    raise ValueError(cfg.devoxelize_mode)
        return point_scores
