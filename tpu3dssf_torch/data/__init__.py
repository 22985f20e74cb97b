"""Host data: the synthetic scenes, the nuScenes reader and the batching
pipeline (the port's own copy of ``tpu3dssf/data``)."""

from tpu3dssf_torch.data.device import batch_to_device
from tpu3dssf_torch.data.nuscenes_index import (NUSCENES_CAM_VIEWS,
                                                NuScenesDataset)
from tpu3dssf_torch.data.pipeline import HostDataPipeline, pack_sample
from tpu3dssf_torch.data.synthetic import SyntheticNuScenes

__all__ = [
    "batch_to_device",
    "SyntheticNuScenes",
    "NuScenesDataset",
    "NUSCENES_CAM_VIEWS",
    "HostDataPipeline",
    "pack_sample",
]
