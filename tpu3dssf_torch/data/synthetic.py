"""Synthetic nuScenes-like scenes for tests and benchmarks.

The port's own copy of ``tpu3dssf/data/synthetic.py``
(host code: the port imports nothing of the JAX package).

Generates samples with the exact output contract of the real dataset
(reference utils/dataloader.py:105-163): LiDAR points + 16-class labels +
6 surround cameras with plausible intrinsics/extrinsics. Geometry is
learnable (labels correlate with height, range, and cluster identity) so
training smoke-tests can show loss decreasing on it.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 16


def _camera_ring(rng, n_cam=6, jitter=0.0):
    """6 cameras in a yaw ring, each looking outward (like nuScenes).

    Returns K (n_cam, 3, 3) and T_lidar_cam (n_cam, 4, 4): LiDAR frame is
    x-forward/y-left/z-up; camera frames are the usual x-right/y-down/
    z-forward.
    """
    K = np.zeros((n_cam, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 1266.0
    K[:, 0, 2] = 800.0
    K[:, 1, 2] = 450.0
    K[:, 2, 2] = 1.0

    Rt = np.zeros((n_cam, 4, 4), np.float32)
    for c in range(n_cam):
        yaw = 2.0 * np.pi * c / n_cam + jitter * rng.normal()
        # forward direction of this camera in the LiDAR frame
        f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(f, up)
        down = -up
        # rows of R map lidar coords to camera (x=right, y=down, z=forward)
        R = np.stack([right, down, f], axis=0)
        t = -R @ (f * 1.5)  # camera 1.5 m out from the sensor
        Rt[c, :3, :3] = R
        Rt[c, :3, 3] = t
        Rt[c, 3, 3] = 1.0
    return K, Rt


# one visually distinct RGB color per class 0..16 (0 = noise, gray)
CLASS_PALETTE = np.array(
    [[96, 96, 96],
     [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [128, 128, 0]],
    dtype=np.uint8)


def _render_semantic_images(xyz, labels, K, Rt, image_hw, raw_size, rng):
    """Paint each point as a class-colored 2x2 splat in every camera.

    Far points are painted first so near ones overwrite them (poor man's
    z-buffer). The intrinsics assume ``raw_size`` capture resolution;
    splats are drawn at the rendered ``image_hw`` resolution.
    """
    H, W = image_hw
    n_cam = K.shape[0]
    su, sv = W / raw_size[1], H / raw_size[0]
    images = rng.integers(0, 40, (n_cam, H, W, 3)).astype(np.uint8)
    hom = np.concatenate([xyz, np.ones((xyz.shape[0], 1))], axis=1)
    colors = CLASS_PALETTE[labels]
    for c in range(n_cam):
        cam = (Rt[c].astype(np.float64) @ hom.T).T[:, :3]
        z = cam[:, 2]
        pix = (K[c].astype(np.float64) @ cam.T).T
        u = pix[:, 0] / np.maximum(pix[:, 2], 1e-12) * su
        v = pix[:, 1] / np.maximum(pix[:, 2], 1e-12) * sv
        ok = (z > 0.1) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        order = np.argsort(-z[ok])  # far -> near
        ui = u[ok].astype(np.int64)[order]
        vi = v[ok].astype(np.int64)[order]
        col = colors[ok][order]
        for dv in (0, 1):
            for du in (0, 1):
                images[c, vi + dv, ui + du] = col
    return images


class SyntheticNuScenes:
    """Deterministic synthetic dataset; index-addressable like the real one."""

    def __init__(self, num_samples=8, num_points=34000, image_hw=(90, 160),
                 seed=0, num_classes=NUM_CLASSES,
                 render_semantics=False, cache=False):
        self.num_samples = num_samples
        self.num_points = num_points
        self.image_hw = image_hw
        self.seed = seed
        self.num_classes = num_classes
        # paint class-colored point splats into the camera images so the
        # fusion branch has real signal to learn from (a frozen ViT's
        # patch tokens become class-discriminative); False -> pure noise
        # images (camera branch carries no information)
        self.render_semantics = render_semantics
        # in-memory sample cache: generation (and especially rendering)
        # is host-CPU-bound; multi-epoch training should pay it once
        self._cache = {} if cache else None
        # raw capture resolution the intrinsics assume (nuScenes cameras)
        self.raw_image_size = (900, 1600)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index):
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        out = self._generate(index)
        if self._cache is not None:
            self._cache[index] = out
        return out

    def _generate(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        P = self.num_points

        # ground plane + a few object clusters + scattered "vegetation"
        n_ground = P // 2
        n_cluster = P // 4
        n_rest = P - n_ground - n_cluster

        r = np.sqrt(rng.uniform(4.0, 2500.0, n_ground))
        th = rng.uniform(0, 2 * np.pi, n_ground)
        ground = np.stack(
            [r * np.cos(th), r * np.sin(th),
             rng.normal(0, 0.05, n_ground)], axis=1)
        ground_lab = np.full(n_ground, 11)  # driveable_surface

        k = 8
        centers = rng.uniform(-30, 30, (k, 3))
        centers[:, 2] = rng.uniform(0.5, 2.0, k)
        which = rng.integers(0, k, n_cluster)
        cluster = centers[which] + rng.normal(0, 0.8, (n_cluster, 3))
        cluster_lab = (which % 10) + 1  # classes 1..10 (objects)

        rest_r = np.sqrt(rng.uniform(25.0, 3600.0, n_rest))
        rest_th = rng.uniform(0, 2 * np.pi, n_rest)
        rest = np.stack(
            [rest_r * np.cos(rest_th), rest_r * np.sin(rest_th),
             rng.uniform(0.0, 6.0, n_rest)], axis=1)
        rest_lab = np.where(rest[:, 2] > 3.0, 16, 15)  # veg / manmade

        xyz = np.concatenate([ground, cluster, rest]).astype(np.float32)
        labels = np.concatenate(
            [ground_lab, cluster_lab, rest_lab]).astype(np.uint8)

        # ~2% noise class (label 0), like real lidarseg
        noise = rng.random(P) < 0.02
        labels = np.where(noise, 0, labels).astype(np.uint8)

        intensity = np.clip(
            rng.normal(0.3 + 0.02 * labels.astype(np.float32), 0.1),
            0, 1).astype(np.float32)
        points = np.concatenate([xyz, intensity[:, None]], axis=1)

        perm = rng.permutation(P)
        points, labels = points[perm], labels[perm]

        K, Rt = _camera_ring(rng)
        H, W = self.image_hw
        if self.render_semantics:
            images = _render_semantic_images(
                points[:, :3], labels, K, Rt, (H, W),
                self.raw_image_size, rng)
        else:
            images = rng.integers(0, 255, (6, H, W, 3), dtype=np.uint8)

        return {
            "points": points,                  # (P, 4) float32
            "labels": labels,                  # (P,) uint8 in [0, 16]
            "images": images,                  # (6, H, W, 3) uint8
            "cam_intrinsics": K,               # (6, 3, 3) float32
            "lidar2cam": Rt,                   # (6, 4, 4) float32
            "num_points": P,
        }
