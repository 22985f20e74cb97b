from tpu3dssf_torch.voxel.voxelize import (
    VoxelizeResult,
    devoxelize_nearest,
    devoxelize_own_voxel,
    knn_intensity_transfer,
    topk_neighbors_reference,
    voxelize,
)

__all__ = [
    "VoxelizeResult",
    "voxelize",
    "devoxelize_nearest",
    "devoxelize_own_voxel",
    "knn_intensity_transfer",
    "topk_neighbors_reference",
]
