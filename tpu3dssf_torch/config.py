"""YAML config system — honors the reference schema, validates it.

The port's own copy of ``tpu3dssf/config.py``
(host code: the port imports nothing of the JAX package).

Same keys as the reference configs (config/nuscenesTestConfig22.yaml:1-88):
``debug``, ``dataset_params.*`` (class_weights, {train,val,test}_data_loader,
lidar.voxel_size, label_mapping), ``train_params.*`` (image_encoder,
mlp_class, optimizer, learning_rate, ...), ``test_params.checkpoint_path``.

Differences (documented):
  * dead reference keys are WIRED here instead of silently ignored:
    ``lr_scheduler`` builds a real optax schedule and ``nesterov`` reaches
    SGD (reference declares both but never uses them — SURVEY.md §5);
    ``lambda_seg2d`` / ``lambda_xm`` remain accepted-but-unused for config
    compatibility (the reference has no 2D/cross-modal aux losses either)
    and produce a warning;
  * new ``tpu_params`` section for static capacities / precision / mesh —
    absent keys get defaults, so reference configs load unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import yaml

OPTIMIZERS = ("SGD", "Adam", "AdamW")
SCHEDULERS = ("none", "StepLR", "ReduceLROnPlateau", "CosineAnnealingLR",
              "CosineAnnealingWarmRestarts")
IMAGE_ENCODERS = ("dinov2", "dinov3", "dinov3_large", "none")


@dataclasses.dataclass
class LoaderConfig:
    data_path: str = ""
    batch_size: int = 1
    shuffle: bool = False
    num_workers: int = 0  # accepted for schema parity; pipeline threads


@dataclasses.dataclass
class TPUParams:
    """TPU-native knobs (new section; defaults keep reference configs valid)."""
    point_capacity: int = 35840        # static P (multiple of 1024)
    voxel_capacity: int = 26624        # static V (multiple of window)
    window_size: int = 1024
    # Parity modes (see README "Recommended parity configuration"):
    # for reference comparisons use devoxelize_mode="nearest" and KEEP
    # intensity_mode="mean" — devox-only parity agrees 99.25% with
    # full-parity (PARITY_AB.md) while knn5 costs ~40% of a frame.
    intensity_mode: str = "mean"       # "mean" | "knn5" (bit-level audit)
    devoxelize_mode: str = "own"       # "own" | "nearest" (parity)
    use_pallas: bool = True
    remat: bool = False                # jax.checkpoint PTv3 blocks
    # recompute only each block's attention branch (qkv → windowed
    # attention → proj) in the backward — the branch holding the
    # largest per-block activations at a fraction of a full block's
    # recompute FLOPs (models/ptv3.py remat_attention; B=12 lever,
    # PERF.md "B=12 levers")
    remat_attention: bool = False
    # compile each PTv3 stage's blocks as ONE nn.scan over stacked
    # params (fewer block bodies → much less HLO for slow AOT
    # compilers). Changes the param-tree layout; convert existing
    # checkpoints either direction with scripts/convert_checkpoint.py
    # (exact — identical logits, tests/test_convert.py).
    scan_blocks: bool = False
    # The JAX package's per-layer ViT dispatch (a TPU compile workaround
    # for ViT-L). Parsed and validated for schema parity; the port runs
    # its ViT eagerly and this field has no effect.
    vit_looped: str = "auto"           # "auto" | "on" | "off"
    compute_dtype: str = "bfloat16"    # model compute dtype
    # split each optimizer step's batch into this many sequential
    # microbatches (lax.scan) and average their gradients — the exact
    # update a data-parallel mesh of this size would produce, at 1/Nth
    # the activation memory. The reference trains batch 12
    # (config/nuscenesTestConfig22.yaml:52); on one chip grad_accum=6
    # over B=2 microbatches beats the direct B=12 step (PERF.md
    # "Training batch scaling") because per-point throughput drifts
    # down with working-set size. batch_size % grad_accum must be 0.
    grad_accum: int = 1
    mesh_shape: Tuple[int, ...] = (1,)  # data-parallel mesh
    dataset: str = "nuscenes"          # "nuscenes" | "synthetic"
    # synthetic-dataset shape knobs (dataset == "synthetic" only)
    synthetic_samples: int = 0         # 0 -> debug-aware default (4/16)
    synthetic_points: int = 34000
    synthetic_image_hw: Tuple[int, int] = (90, 160)
    synthetic_render: bool = False     # paint class-colored splats


@dataclasses.dataclass
class Config:
    raw: Dict[str, Any]
    debug: bool
    # dataset_params
    label_mapping: str
    class_weights: Tuple[float, ...]
    train_loader: LoaderConfig
    val_loader: LoaderConfig
    test_loader: LoaderConfig
    voxel_size: float
    # train_params
    train_best_weights: bool
    best_model_path: str
    checkpoint_path: str
    image_encoder: str
    mlp_class: int
    max_num_epochs: int
    learning_rate: float
    optimizer: str
    lr_scheduler: str
    momentum: float
    nesterov: bool
    weight_decay: float
    lambda_lovasz: float
    grad_clip: Optional[float]
    skip_nonfinite: bool
    drop_path: float
    # test_params
    test_checkpoint_path: str
    # tpu_params
    tpu: TPUParams


def _loader(d: Dict[str, Any]) -> LoaderConfig:
    return LoaderConfig(
        data_path=d.get("data_path", ""),
        batch_size=int(d.get("batch_size", 1)),
        shuffle=bool(d.get("shuffle", False)),
        num_workers=int(d.get("num_workers", 0)),
    )


def load_config(path_or_dict) -> Config:
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        with open(path_or_dict) as f:
            raw = yaml.safe_load(f)

    ds = raw.get("dataset_params", {})
    tr = raw.get("train_params", {})
    te = raw.get("test_params", {})
    tp = raw.get("tpu_params", {})

    opt = tr.get("optimizer", "AdamW")
    if opt not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {opt}")
    sched = tr.get("lr_scheduler", "none") or "none"
    if sched not in SCHEDULERS:
        raise ValueError(
            f"lr_scheduler must be one of {SCHEDULERS}, got {sched}")
    enc = tr.get("image_encoder", "dinov3")
    if enc not in IMAGE_ENCODERS:
        raise ValueError(
            f"image_encoder must be one of {IMAGE_ENCODERS}, got {enc}")

    for dead in ("lambda_seg2d", "lambda_xm"):
        if dead in tr:
            warnings.warn(
                f"config key train_params.{dead} is accepted for reference "
                "compatibility but has no effect (the reference never reads "
                "it either)", stacklevel=2)

    mesh_shape = tuple(tp.get("mesh_shape", (1,)))
    tpu = TPUParams(
        point_capacity=int(tp.get("point_capacity", 35840)),
        voxel_capacity=int(tp.get("voxel_capacity", 26624)),
        window_size=int(tp.get("window_size", 1024)),
        intensity_mode=tp.get("intensity_mode", "mean"),
        devoxelize_mode=tp.get("devoxelize_mode", "own"),
        use_pallas=bool(tp.get("use_pallas", True)),
        remat=bool(tp.get("remat", False)),
        remat_attention=bool(tp.get("remat_attention", False)),
        scan_blocks=bool(tp.get("scan_blocks", False)),
        vit_looped=str(tp.get("vit_looped", "auto")),
        compute_dtype=tp.get("compute_dtype", "bfloat16"),
        grad_accum=int(tp.get("grad_accum", 1)),
        mesh_shape=mesh_shape,
        dataset=tp.get("dataset", "nuscenes"),
        synthetic_samples=int(tp.get("synthetic_samples", 0)),
        synthetic_points=int(tp.get("synthetic_points", 34000)),
        synthetic_image_hw=tuple(tp.get("synthetic_image_hw", (90, 160))),
        synthetic_render=bool(tp.get("synthetic_render", False)),
    )
    if tpu.voxel_capacity % tpu.window_size != 0:
        raise ValueError(
            "tpu_params.voxel_capacity must be a multiple of window_size")
    if tpu.grad_accum < 1:
        raise ValueError("tpu_params.grad_accum must be >= 1")
    if tpu.vit_looped not in ("auto", "on", "off"):
        raise ValueError(
            f"tpu_params.vit_looped must be auto|on|off, got "
            f"{tpu.vit_looped!r}")

    weights = tuple(float(w) for w in ds.get("class_weights", ()))
    mlp_class = int(tr.get("mlp_class", 16))
    if weights and len(weights) != mlp_class:
        raise ValueError(
            f"class_weights has {len(weights)} entries but mlp_class is "
            f"{mlp_class}")

    return Config(
        raw=raw,
        debug=bool(raw.get("debug", False)),
        label_mapping=ds.get("label_mapping", ""),
        class_weights=weights,
        train_loader=_loader(ds.get("train_data_loader", {})),
        val_loader=_loader(ds.get("val_data_loader", {})),
        test_loader=_loader(ds.get("test_data_loader", {})),
        voxel_size=float(ds.get("lidar", {}).get("voxel_size", 0.1)),
        train_best_weights=bool(tr.get("train_best_weights", False)),
        best_model_path=tr.get("best_model_path", ""),
        checkpoint_path=tr.get("checkpoint_path", "./checkpoints/"),
        image_encoder=enc,
        mlp_class=mlp_class,
        max_num_epochs=int(tr.get("max_num_epochs", 10)),
        learning_rate=float(tr.get("learning_rate", 5e-4)),
        optimizer=opt,
        lr_scheduler=sched,
        momentum=float(tr.get("momentum", 0.9)),
        nesterov=bool(tr.get("nesterov", False)),
        weight_decay=float(tr.get("weight_decay", 0.0)),
        lambda_lovasz=float(tr.get("lambda_lovasz", 1.0)),
        grad_clip=(float(tr["grad_clip"]) if tr.get("grad_clip")
                   else None),
        skip_nonfinite=bool(tr.get("skip_nonfinite", False)),
        # PTv3 stochastic depth (upstream trains with ~0.3; a submodule
        # default the reference configs never surface)
        drop_path=float(tr.get("drop_path", 0.0)),
        test_checkpoint_path=te.get("checkpoint_path",
                                    tr.get("checkpoint_path", "")),
        tpu=tpu,
    )


def load_label_mapping(path: str) -> Dict[str, Any]:
    """Load the label-mapping YAML (learning_map + class-name dicts)."""
    with open(path) as f:
        return yaml.safe_load(f)


def load_class_dict(config_path: str, use_16_classes: bool = True):
    """Reference utils/dataloader.py:272-283: int-keyed class-name dict."""
    m = load_label_mapping(config_path)
    d = m["labels_16"] if use_16_classes else m["labels"]
    return {int(k): v for k, v in d.items()}
