"""Multi-camera pinhole projection + patch indexing on tensors.

Port of ``tpu3dssf.geometry.projection`` with the reference contract:
validity ``(z > 0) & (0 <= u < W) & (0 <= v < H)``, invalid pixels and
depths forced to -1, per-axis rescale to the encoder resolution, and the
clamped row-major patch index. The 3x3 products are written elementwise in
float32: one pixel of error can move a voxel to another ViT patch, and an
elementwise product cannot take a TF32 path on the card.
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.utils.constants import device_constants


def multi_camera_projector(points, cam_intrinsics, lidar2cam_extrinsics,
                           image_size):
    """Project LiDAR-frame points into every camera.

    Args:
      points: (..., P, 3) xyz in the LiDAR frame.
      cam_intrinsics: (..., N_cam, 3, 3).
      lidar2cam_extrinsics: (..., N_cam, 4, 4).
      image_size: (H, W) of the raw images — Python ints or a (..., 2)
        tensor of per-sample sizes.

    Returns:
      pixel_coords (..., N_cam, P, 2) (u, v), -1 where invalid;
      depth (..., N_cam, P), -1 where invalid; valid (..., N_cam, P) bool.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    K = torch.as_tensor(cam_intrinsics, dtype=torch.float32)
    Rt = torch.as_tensor(lidar2cam_extrinsics, dtype=torch.float32)

    # R p + t for every camera: (..., N_cam, P, 3)
    R = Rt[..., :3, :3]
    xyz = ((R[..., None, :, :] * points[..., None, :, None, :]).sum(-1)
           + Rt[..., None, :3, 3])
    z = xyz[..., 2]
    pix = (K[..., None, :, :] * xyz[..., None, :]).sum(-1)
    denom = pix[..., 2].clamp_min(1e-12)
    u = pix[..., 0] / denom
    v = pix[..., 1] / denom

    if isinstance(image_size, (tuple, list)):
        img_h, img_w = float(image_size[0]), float(image_size[1])
    else:
        hw = torch.as_tensor(image_size, dtype=torch.float32)
        img_h = hw[..., 0][..., None, None]
        img_w = hw[..., 1][..., None, None]

    valid = (z > 0) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    pixel_coords = torch.where(valid[..., None], torch.stack([u, v], -1),
                               -1.0)
    depth = torch.where(valid, z, -1.0)
    return pixel_coords, depth, valid


@device_constants
def _scale(sx, sy, device):
    """(sx, sy) as an f32 tensor on ``device``, made once (a step holds no
    host-to-device copy, which a CUDA graph could not replay)."""
    with torch.inference_mode(False):
        return torch.tensor([sx, sy], dtype=torch.float32, device=device)


def scale_pixel_coords(pixel_coords, origin_size, new_size):
    """Rescale (u, v) from ``origin_size`` to ``new_size`` (H, W): factors
    (W_new / W_orig, H_new / H_orig)."""
    if isinstance(new_size, int):
        h_new = w_new = float(new_size)
    else:
        h_new, w_new = float(new_size[0]), float(new_size[1])
    if isinstance(origin_size, (tuple, list)):
        h_orig = max(float(origin_size[0]), 1e-6)
        w_orig = max(float(origin_size[1]), 1e-6)
        scale = _scale(w_new / w_orig, h_new / h_orig, pixel_coords.device)
    else:
        hw = torch.as_tensor(origin_size, dtype=torch.float32)
        scale = torch.stack([w_new / hw[..., 1].clamp_min(1e-6),
                             h_new / hw[..., 0].clamp_min(1e-6)], dim=-1)
        extra = pixel_coords.dim() - scale.dim()
        scale = scale.reshape(scale.shape[:-1] + (1,) * extra + (2,))
    return pixel_coords * scale


def pixel_to_patch_index(pixel_coords, patch_size, grid_h, grid_w):
    """Encoder-resolution (u, v) → flat ViT patch index
    ``clamp(v // patch) * grid_w + clamp(u // patch)``; invalid points
    (coords -1) land in patch 0 and are masked by the caller."""
    patch_xy = torch.floor(pixel_coords / float(patch_size)).to(torch.int64)
    u_idx = patch_xy[..., 0].clamp(0, grid_w - 1)
    v_idx = patch_xy[..., 1].clamp(0, grid_h - 1)
    return (v_idx * grid_w + u_idx).clamp(0, grid_h * grid_w - 1)
