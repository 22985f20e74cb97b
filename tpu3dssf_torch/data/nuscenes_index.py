"""Minimal nuScenes reader — no nuscenes-devkit dependency.

The port's own copy of ``tpu3dssf/data/nuscenes_index.py``
(host code: the port imports nothing of the JAX package).

Rebuilds the data access of the reference dataset class
(utils/dataloader.py:14-163) directly from the nuScenes table JSONs
(``{dataroot}/{version}/*.json``), which is all the devkit does for this
workload:

  * scene/sample/sample_data/calibrated_sensor indexing
    (dataloader.py:50,83-103);
  * LiDAR ``.bin`` float32 (P,5)→(P,4) + lidarseg uint8 labels
    (dataloader.py:63-75);
  * 6 fixed camera views (dataloader.py:46-47);
  * label remap via the learning_map YAML (dataloader.py:39-41,108);
  * the keyframe calibration chain ``T_lidar_cam = inv(T_cam_ego) @
    T_lidar_ego`` (dataloader.py:123-152) — ego-pose records are fetched
    but unused upstream (SURVEY.md §3.4 note), and likewise not used here.

Splits: official mini splits are built in; trainval scene lists can be
supplied via config (``scene_names``) or default to a deterministic
85/15 split by scene index. The reference's missing 'test' split wiring
(SURVEY.md §3.2 latent defect) is fixed: all three splits resolve.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

NUSCENES_CAM_VIEWS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
)

# official v1.0-mini split scene names (public devkit constants)
MINI_TRAIN = (
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
)
MINI_VAL = ("scene-0103", "scene-0916")


def _quat_to_rot(q):
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _se3(rotation_quat, translation):
    T = np.eye(4)
    T[:3, :3] = _quat_to_rot(rotation_quat)
    T[:3, 3] = np.asarray(translation, dtype=np.float64)
    return T


class _Tables:
    """Token-indexed nuScenes tables loaded from JSON."""

    NAMES = ("scene", "sample", "sample_data", "calibrated_sensor",
             "sensor", "lidarseg")

    def __init__(self, dataroot: str, version: str):
        table_dir = os.path.join(dataroot, version)
        self.by_token: Dict[str, Dict[str, dict]] = {}
        for name in self.NAMES:
            path = os.path.join(table_dir, f"{name}.json")
            if not os.path.exists(path):
                if name == "lidarseg":
                    self.by_token[name] = {}
                    continue
                raise FileNotFoundError(
                    f"nuScenes table missing: {path}")
            with open(path) as f:
                rows = json.load(f)
            self.by_token[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self.by_token[table][token]

    def all(self, table: str):
        return self.by_token[table].values()


class NuScenesDataset:
    """Index-addressable nuScenes-lidarseg samples (points+labels+6 cams).

    Args:
      dataroot: nuScenes root (contains v1.0-*/ and samples/ etc).
      version: e.g. 'v1.0-mini' or 'v1.0-trainval'.
      split: 'train' | 'val' | 'test' | 'all'.
      learning_map: dict raw-label → train-label (from the label-mapping
        YAML, config/label_mapping/nuscenes.yaml:52-84).
      scene_names: explicit scene-name list overriding the split logic.
      num_vote: duplicate each sample N times (reference
        dataloader.py:94-103 test-time voting hook).
      load_images: set False for LiDAR-only workloads.
      check_files: verify each scene's first lidar file exists and drop
        scenes that fail (reference get_available_scenes,
        utils/dataloader.py:83-92).
    """

    def __init__(self, dataroot: str, version: str, split: str,
                 learning_map: Optional[Dict[int, int]] = None,
                 scene_names: Optional[Sequence[str]] = None,
                 num_vote: int = 1, load_images: bool = True,
                 train_fraction: float = 0.85,
                 point_capacity: Optional[int] = None,
                 check_files: bool = True):
        self.dataroot = dataroot
        self.version = version
        self.split = split
        self.num_vote = num_vote
        self.load_images = load_images
        # when set and csrc/libtpu3dssf_io.so is built, point IO + label
        # remap + fixed-capacity packing run in C
        # (tpu3dssf_torch.data.native)
        self.point_capacity = point_capacity
        self.tables = _Tables(dataroot, version)

        if learning_map is not None:
            lut = np.zeros(max(learning_map) + 1, dtype=np.uint8)
            for k, v in learning_map.items():
                lut[int(k)] = int(v)
            self.label_lut = lut
        else:
            self.label_lut = None

        scenes = sorted(self.tables.all("scene"),
                        key=lambda s: s["name"])
        if scene_names is not None:
            wanted = set(scene_names)
        elif version.endswith("mini"):
            wanted = set(MINI_TRAIN if split == "train" else MINI_VAL
                         if split in ("val", "test") else
                         MINI_TRAIN + MINI_VAL)
        elif split == "all":
            wanted = {s["name"] for s in scenes}
        else:
            n_train = int(len(scenes) * train_fraction)
            names = [s["name"] for s in scenes]
            wanted = set(names[:n_train] if split == "train"
                         else names[n_train:])
        scene_tokens = {s["token"] for s in scenes if s["name"] in wanted}
        # scene-validity filter (reference get_available_scenes,
        # utils/dataloader.py:83-92): drop scenes whose first lidar file
        # is not actually on disk, so an incomplete dataset download
        # fails at indexing time with a warning, not inside __getitem__
        if check_files:
            dropped = []
            for s in scenes:
                if s["token"] not in scene_tokens:
                    continue
                try:
                    first = self.tables.get("sample",
                                            s["first_sample_token"])
                    lt = first["data"]["LIDAR_TOP"]
                    sd = self.tables.get("sample_data", lt)
                    ok = os.path.exists(
                        os.path.join(dataroot, sd["filename"]))
                except KeyError:
                    ok = False
                if not ok:
                    scene_tokens.discard(s["token"])
                    dropped.append(s["name"])
            if dropped:
                print(f"[nuscenes_index] skipping {len(dropped)} scenes "
                      f"with missing lidar files: {sorted(dropped)}")

        # token list: one entry per keyframe sample in the chosen scenes
        self.token_list: List[dict] = []
        samples = sorted(self.tables.all("sample"),
                         key=lambda s: (s["scene_token"], s["timestamp"]))
        for sample in samples:
            if sample["scene_token"] not in scene_tokens:
                continue
            data = sample["data"] if "data" in sample else None
            if data is None:
                continue
            lidar_token = data.get("LIDAR_TOP")
            if lidar_token is None:
                continue
            cam_tokens = [data.get(v) for v in NUSCENES_CAM_VIEWS]
            if any(t is None for t in cam_tokens):
                continue
            for _ in range(self.num_vote):
                self.token_list.append(
                    {"lidar_token": lidar_token, "cam_token": cam_tokens})

        self.raw_image_size = (900, 1600)

    def __len__(self):
        return len(self.token_list)

    def _lidar_paths(self, lidar_token):
        sd = self.tables.get("sample_data", lidar_token)
        lidar_path = os.path.join(self.dataroot, sd["filename"])
        seg = self.tables.by_token["lidarseg"].get(lidar_token)
        seg_path = (os.path.join(self.dataroot, seg["filename"])
                    if seg else None)
        return lidar_path, seg_path

    def __getitem__(self, index):
        rec = self.token_list[index]
        lidar_token = rec["lidar_token"]

        lidar_path, seg_path = self._lidar_paths(lidar_token)

        native = None
        if self.point_capacity is not None:
            from tpu3dssf_torch.data.native import (get_native_loader,
                                                    load_sample_native)
            if get_native_loader() is not None:
                lut = (self.label_lut if self.label_lut is not None
                       else np.arange(256, dtype=np.uint8))
                native = load_sample_native(
                    lidar_path, seg_path, lut, self.point_capacity)
        if native is not None:
            points = native["points"]
            labels = native["labels"]
        else:
            raw = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)
            points = raw[:, :4].copy()
            if seg_path is not None and os.path.exists(seg_path):
                labels = np.fromfile(seg_path, dtype=np.uint8)
            else:
                labels = np.zeros(points.shape[0], dtype=np.uint8)
            if self.label_lut is not None:
                labels = self.label_lut[labels]

        sd_lidar = self.tables.get("sample_data", lidar_token)
        cs_lidar = self.tables.get("calibrated_sensor",
                                   sd_lidar["calibrated_sensor_token"])
        T_lidar_ego = _se3(cs_lidar["rotation"], cs_lidar["translation"])

        K_list, Rt_list, images = [], [], []
        for cam_token in rec["cam_token"]:
            sd_cam = self.tables.get("sample_data", cam_token)
            cs_cam = self.tables.get("calibrated_sensor",
                                     sd_cam["calibrated_sensor_token"])
            K_list.append(np.asarray(cs_cam["camera_intrinsic"],
                                     dtype=np.float32))
            T_cam_ego = _se3(cs_cam["rotation"], cs_cam["translation"])
            Rt_list.append(
                (np.linalg.inv(T_cam_ego) @ T_lidar_ego).astype(
                    np.float32))
            if self.load_images:
                from PIL import Image
                img = Image.open(
                    os.path.join(self.dataroot, sd_cam["filename"]))
                images.append(np.asarray(img.convert("RGB"),
                                         dtype=np.uint8))

        out = {
            "points": points,
            "labels": labels,
            "cam_intrinsics": np.stack(K_list),
            "lidar2cam": np.stack(Rt_list),
            "num_points": (native["num_points"] if native is not None
                           else points.shape[0]),
        }
        if native is not None:
            out["point_valid"] = native["point_valid"]
            out["mask"] = native["mask"]
            out["packed"] = True
        if self.load_images:
            out["images"] = np.stack(images)
        return out
