"""The one traffic generator: a pool of seeded synthetic sweeps, made from
a traffic file's parameters and the run's ``--seed``.

A sweep is the scene of the program's synthetic nuScenes-like dataset,
frozen here so that later changes to the program cannot move the
yardstick: a ground plane (label 11), eight object clusters (labels 1-10),
scattered vegetation and man-made points (15, 16), 2% noise points
(label 0, ignored by the loss), intensities that follow the label, and
six outward cameras in a ring (nuScenes intrinsics at 900x1600). The
camera images are uniform noise drawn on the card from the seed, in one
call a sweep.

Every sweep has the traffic's ``valid_points`` points (cut to the
capacity where that is smaller, as the program's packing does), so seeds
differ in content and order and not in work. The pool is ``pool //
batch`` batches of pinned host tensors; a run visits them in a seeded
order, a fresh permutation every pass.
"""

from __future__ import annotations

import numpy as np
import torch

RAW_HW = (900, 1600)


def camera_ring(rng, n_cam=6, jitter=0.0):
    """K (n_cam, 3, 3) and lidar→camera (n_cam, 4, 4): cameras in a yaw
    ring 1.5 m out from the sensor, each looking outward."""
    K = np.zeros((n_cam, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 1266.0
    K[:, 0, 2] = 800.0
    K[:, 1, 2] = 450.0
    K[:, 2, 2] = 1.0
    Rt = np.zeros((n_cam, 4, 4), np.float32)
    for c in range(n_cam):
        yaw = 2.0 * np.pi * c / n_cam + jitter * rng.normal()
        f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        R = np.stack([np.cross(f, up), -up, f], axis=0)
        Rt[c, :3, :3] = R
        Rt[c, :3, 3] = -R @ (f * 1.5)
        Rt[c, 3, 3] = 1.0
    return K, Rt


def sweep(seed: int, index: int, num_points: int):
    """One scene: points (P, 4) f32, labels (P,) in [0, 16], K, Rt."""
    rng = np.random.default_rng([seed, index])
    P = num_points
    n_ground, n_cluster = P // 2, P // 4
    n_rest = P - n_ground - n_cluster
    r = np.sqrt(rng.uniform(4.0, 2500.0, n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(0, 0.05, n_ground)], axis=1)
    centers = rng.uniform(-30, 30, (8, 3))
    centers[:, 2] = rng.uniform(0.5, 2.0, 8)
    which = rng.integers(0, 8, n_cluster)
    cluster = centers[which] + rng.normal(0, 0.8, (n_cluster, 3))
    rest_r = np.sqrt(rng.uniform(25.0, 3600.0, n_rest))
    rest_th = rng.uniform(0, 2 * np.pi, n_rest)
    rest = np.stack([rest_r * np.cos(rest_th), rest_r * np.sin(rest_th),
                     rng.uniform(0.0, 6.0, n_rest)], axis=1)
    xyz = np.concatenate([ground, cluster, rest]).astype(np.float32)
    labels = np.concatenate([np.full(n_ground, 11), (which % 10) + 1,
                             np.where(rest[:, 2] > 3.0, 16, 15)])
    labels = np.where(rng.random(P) < 0.02, 0, labels).astype(np.int32)
    intensity = np.clip(rng.normal(0.3 + 0.02 * labels, 0.1), 0, 1)
    points = np.concatenate([xyz, intensity[:, None]], 1).astype(np.float32)
    perm = rng.permutation(P)
    K, Rt = camera_ring(rng)
    return points[perm], labels[perm], K, Rt


def make_pool(traffic: dict, seed: int, capacity: int, device,
              cameras: bool):
    """The pool of a traffic file: a list of ``pool // batch`` batches,
    each a dict of host tensors (pinned where ``device`` is a card):
    points (B, P, 4), point_valid, labels, mask, cam_intrinsics,
    lidar2cam and, with ``cameras``, images (B, 6, 900, 1600, 3) uint8.
    ``mask`` is the loaders' collate mask: a real point whose label is not
    0."""
    batch, pool = traffic["batch"], traffic["pool"]
    points = int(traffic["valid_points"])
    pin = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    hw = tuple(traffic.get("image_hw", RAW_HW))
    out = []
    for b0 in range(0, pool - batch + 1, batch):
        rows = [sweep(seed, j, points) for j in range(b0, b0 + batch)]
        pts = np.zeros((batch, capacity, 4), np.float32)
        lab = np.zeros((batch, capacity), np.int32)
        valid = np.zeros((batch, capacity), bool)
        for i, (p, lbl, _, _) in enumerate(rows):
            n = min(p.shape[0], capacity)
            pts[i, :n], lab[i, :n], valid[i, :n] = p[:n], lbl[:n], True
        host = {"points": pts, "point_valid": valid, "labels": lab,
                "mask": valid & (lab != 0),
                "cam_intrinsics": np.stack([r[2] for r in rows]),
                "lidar2cam": np.stack([r[3] for r in rows])}
        host = {k: torch.from_numpy(v) for k, v in host.items()}
        if cameras:
            host["images"] = torch.randint(
                0, 256, (batch, 6) + hw + (3,), generator=gen,
                dtype=torch.uint8, device=device).cpu()
        out.append({k: (v.pin_memory() if pin else v)
                    for k, v in host.items()})
    return out


def visit_order(seed: int, n_batches: int):
    """An endless seeded order over the pool's batches: a fresh
    permutation every pass."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from rng.permutation(n_batches).tolist()
