from tpu3dssf_torch.models.fusion import (
    FeatureFusionModel,
    FusionConfig,
    PipelineConfig,
    SegmentationPipeline,
)
from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
from tpu3dssf_torch.models.ptv3 import PointTransformerV3, PTv3Config
from tpu3dssf_torch.models.vit import ViTConfig, VisionTransformer

__all__ = [
    "PointTransformerV3",
    "PTv3Config",
    "VisionTransformer",
    "ViTConfig",
    "FeatureFusionModel",
    "FusionConfig",
    "PipelineConfig",
    "SegmentationPipeline",
    "LidarSegmentationModel",
]
