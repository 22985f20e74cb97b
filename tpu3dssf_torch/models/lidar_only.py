"""LiDAR-only segmentation: PTv3 + a linear head, no camera branch.

Port of ``tpu3dssf.models.lidar_only``: what ``image_encoder: none``
builds. Submodules are named as in flax (``ptv3``, ``head``).
"""

from __future__ import annotations

from torch import nn

from tpu3dssf_torch.models.fusion import PipelineConfig
from tpu3dssf_torch.models.layers import Dense
from tpu3dssf_torch.models.ptv3 import PointTransformerV3
from tpu3dssf_torch.voxel import (devoxelize_nearest, devoxelize_own_voxel,
                                  voxelize)


class LidarSegmentationModel(nn.Module):
    """points → voxelize → PTv3 → linear classifier → devoxelize.

    Same call signature as
    :class:`~tpu3dssf_torch.models.fusion.SegmentationPipeline`: the patch
    tokens and camera calibration are accepted and ignored, so the loops
    and CLIs take either model. ``generator`` drives PTv3's DropPath; None
    is JAX's ``deterministic=True``.
    """

    def __init__(self, config: PipelineConfig):
        super().__init__()
        self.config = config
        self.ptv3 = PointTransformerV3(config.ptv3)
        self.head = Dense(config.ptv3.out_channels, config.fusion.output_dim,
                          config.fusion.dtype)

    def forward(self, points, point_mask, patch_tokens=None,
                cam_intrinsics=None, lidar2cam=None, generator=None):
        cfg = self.config
        vox = voxelize(points, point_mask, cfg.voxel_size,
                       cfg.voxel_capacity, intensity_mode=cfg.intensity_mode)
        voxel_feats, voxel_mask = self.ptv3(vox.voxel_raw, vox.voxel_coords,
                                            vox.voxel_mask, generator)
        voxel_scores = self.head(voxel_feats) * voxel_mask[..., None]
        if cfg.devoxelize_mode == "own":
            point_scores, _ = devoxelize_own_voxel(
                vox.point_voxel, vox.point_ok, voxel_scores)
        else:
            point_scores, _ = devoxelize_nearest(
                points[..., :3], point_mask, vox.voxel_raw[..., :3],
                vox.voxel_mask, voxel_scores)
        return point_scores
