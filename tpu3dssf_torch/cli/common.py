"""Shared CLI wiring for the port: config → data, models, loss, state.

Port of ``tpu3dssf.cli.common``. The dataset and loader builders are the
JAX CLI's, over the port's own copies of the host modules
(``tpu3dssf_torch.config``, ``tpu3dssf_torch.data``). The model build
functions make the port's modules on an explicit ``device`` with seeded
random weights; the image encoder loads a local DINO checkpoint where one
exists (:mod:`tpu3dssf_torch.models.vit_port`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu3dssf_torch.config import (  # noqa: F401  (re-exported)
    Config,
    load_class_dict,
    load_config,
    load_label_mapping,
)
from tpu3dssf_torch.data import (  # noqa: F401  (re-exported)
    HostDataPipeline,
    NuScenesDataset,
    SyntheticNuScenes,
    batch_to_device,
)
from tpu3dssf_torch.models.ptv3 import _round_up
from tpu3dssf_torch.utils.logging import (  # noqa: F401  (re-exported)
    create_logger,
    tee_stdout,
)
from tpu3dssf_torch.utils.viz import plot_training_history  # noqa: F401

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_datasets(cfg: Config) -> Dict[str, object]:
    """All three splits (the JAX CLI's builder)."""
    if cfg.tpu.dataset == "synthetic":
        n = cfg.tpu.synthetic_samples or (4 if cfg.debug else 16)
        kw = dict(num_points=cfg.tpu.synthetic_points,
                  image_hw=tuple(cfg.tpu.synthetic_image_hw),
                  render_semantics=cfg.tpu.synthetic_render,
                  cache=cfg.max_num_epochs > 1)
        return {
            "train": SyntheticNuScenes(num_samples=n, seed=0, **kw),
            "val": SyntheticNuScenes(num_samples=max(2, n // 4), seed=1,
                                     **kw),
            "test": SyntheticNuScenes(num_samples=max(2, n // 4), seed=2,
                                      **kw),
        }

    mapping = load_label_mapping(cfg.label_mapping)
    learning_map = {int(k): int(v)
                    for k, v in mapping["learning_map"].items()}
    version = ("v1.0-mini" if cfg.debug else "v1.0-trainval")
    out = {}
    for split, loader in (("train", cfg.train_loader),
                          ("val", cfg.val_loader),
                          ("test", cfg.test_loader)):
        out[split] = NuScenesDataset(
            dataroot=loader.data_path or cfg.train_loader.data_path,
            version=version, split=split, learning_map=learning_map,
            point_capacity=cfg.tpu.point_capacity)
    return out


def build_dataloaders(cfg: Config, datasets=None) -> Dict[str, object]:
    datasets = datasets or build_datasets(cfg)
    loaders = {}
    for split, lcfg in (("train", cfg.train_loader),
                        ("val", cfg.val_loader),
                        ("test", cfg.test_loader)):
        loaders[split] = HostDataPipeline(
            datasets[split], batch_size=lcfg.batch_size,
            point_capacity=cfg.tpu.point_capacity,
            shuffle=lcfg.shuffle, drop_last=(split == "train"),
            num_workers=lcfg.num_workers)
    return loaders


def example_batch(cfg: Config, datasets) -> Dict:
    """One packed batch of the val split at batch size 1."""
    pipe = HostDataPipeline(datasets["val"], batch_size=1,
                            point_capacity=cfg.tpu.point_capacity)
    return next(iter(pipe))


def resolve_device(name: str) -> torch.device:
    """``--device`` → a torch device; raises for CUDA without a card (the
    CLIs never drop to the CPU on their own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            "--device cpu to run the plain PyTorch versions on the CPU)")
    return device


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.tpu.compute_dtype]


def build_vit(cfg: Config, device, seed: int = 0):
    """The frozen ViT of ``cfg.image_encoder`` on ``device``: (vit,
    vit_cfg).

    Weights, as the JAX CLI takes them: a local DINO checkpoint where one
    exists (``vit_port.try_load_pretrained``: ``TPU3DSSF_VIT_CHECKPOINT``,
    ``$TPU3DSSF_WEIGHTS/<name>.{safetensors,bin,pth}`` with ``./weights``
    by default, or the HF cache), else the seeded flax-style init; it says
    which. Then LayerScale is folded into the Dense weights, as the JAX CLI
    does for its frozen encoder.
    """
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (VisionTransformer, dinov2_small,
                                           dinov3_large, dinov3_small,
                                           fold_layerscale)
    from tpu3dssf_torch.models.vit_port import try_load_pretrained

    vit_cfg = {"dinov2": dinov2_small, "dinov3": dinov3_small,
               "dinov3_large": dinov3_large}[cfg.image_encoder]()
    vit_cfg = type(vit_cfg)(**{**vit_cfg.__dict__,
                               "dtype": compute_dtype(cfg)})
    vit = init_weights(VisionTransformer(vit_cfg), seed)
    if try_load_pretrained(cfg.image_encoder, vit) is None:
        print(f"[cli] no pretrained {cfg.image_encoder} weights found "
              "locally — using the seeded random-init frozen ViT")
    return fold_layerscale(vit).to(device).eval(), vit_cfg


def build_image_encoder(cfg: Config, device, seed: int = 0,
                        graph: bool = True):
    """Frozen ViT (:func:`build_vit`) + encode fn on ``device``; returns
    (encode_fn, vit_cfg), or (None, None) for the LiDAR-only path. With
    ``graph`` the encode fn is :func:`tpu3dssf_torch.train.graph.graphed`
    (one CUDA graph replay per call on the card), else the eager one."""
    from tpu3dssf_torch.train.graph import graphed
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    if cfg.image_encoder == "none":
        return None, None
    vit, vit_cfg = build_vit(cfg, device, seed)
    encode = make_image_encode_fn(vit, vit_cfg.image_size, vit_cfg.dtype)
    return (graphed(encode, "encode") if graph else encode), vit_cfg


def build_pipeline(cfg: Config, vit_cfg=None, device="cpu", seed: int = 1):
    """The model on ``device`` with seeded weights: the fusion
    ``SegmentationPipeline``, or ``LidarSegmentationModel`` for
    ``image_encoder: none`` (``vit_cfg`` None); returns (model,
    PipelineConfig)."""
    from tpu3dssf_torch.models.fusion import (FusionConfig, PipelineConfig,
                                              SegmentationPipeline)
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    from tpu3dssf_torch.models.ptv3 import PTv3Config

    dtype = compute_dtype(cfg)
    w = cfg.tpu.window_size
    if vit_cfg is None:
        fusion = FusionConfig(output_dim=cfg.mlp_class, dtype=dtype)
    else:
        fusion = FusionConfig(patch_tok_dim=vit_cfg.hidden_size,
                              patch_size=vit_cfg.patch_size,
                              encoder_size=vit_cfg.image_size,
                              output_dim=cfg.mlp_class, dtype=dtype)
    pipe = PipelineConfig(
        fusion=fusion,
        ptv3=PTv3Config(enc_window=(w,) * 5, dec_window=(w,) * 4,
                        use_pallas=cfg.tpu.use_pallas, remat=cfg.tpu.remat,
                        remat_attention=cfg.tpu.remat_attention,
                        drop_path=cfg.drop_path, dtype=dtype),
        voxel_size=cfg.voxel_size,
        voxel_capacity=_round_up(cfg.tpu.voxel_capacity, w),
        intensity_mode=cfg.tpu.intensity_mode,
        devoxelize_mode=cfg.tpu.devoxelize_mode,
    )
    cls = (LidarSegmentationModel if cfg.image_encoder == "none"
           else SegmentationPipeline)
    model = init_weights(cls(pipe), seed)
    return model.to(device).eval(), pipe


def init_state(cfg: Config, model, steps_per_epoch: int = 1):
    """The train state over ``model``'s parameters with the config's
    optimizer, schedule, clip and non-finite guard."""
    from tpu3dssf_torch.train.state import TrainState, create_optimizer
    opt = create_optimizer(
        model.parameters(), cfg.optimizer, cfg.learning_rate,
        weight_decay=cfg.weight_decay, momentum=cfg.momentum,
        nesterov=cfg.nesterov, lr_scheduler=cfg.lr_scheduler,
        steps_per_epoch=steps_per_epoch, num_epochs=cfg.max_num_epochs,
        grad_clip=cfg.grad_clip, skip_nonfinite=cfg.skip_nonfinite)
    return TrainState(model, opt)


def build_loss(cfg: Config):
    from tpu3dssf_torch.losses import CELSLoss
    weights = (np.asarray(cfg.class_weights, np.float32)
               if cfg.class_weights else None)
    return CELSLoss(weight=weights, ignore_index=0,
                    lamda_lovasz=cfg.lambda_lovasz)


def zero_tokens(cfg: Config, vit_cfg, batch_size: int, device="cpu"):
    """Placeholder patch tokens (the LiDAR-only path ignores them)."""
    if vit_cfg is None:
        return torch.zeros((batch_size, 1, 1, 1), device=device)
    return torch.zeros((batch_size, 6, vit_cfg.num_patches,
                        vit_cfg.hidden_size), device=device)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (raises where
    nvidia-smi does not run)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def config_copy(src, work, name, train=None, tpu=None):
    """A copy of config ``src`` as ``work/name`` whose checkpoint paths
    point at ``work/ckpt`` (a stock config's point at committed TPU
    records, which a run must not overwrite), ``train`` and ``tpu``
    updating its train_params and tpu_params. Returns (path, ckpt dir)."""
    import os

    import yaml
    with open(src) as f:
        raw = yaml.safe_load(f)
    ckpt = os.path.join(work, "ckpt")
    raw["train_params"].update(checkpoint_path=ckpt, best_model_path=ckpt,
                               **(train or {}))
    raw["test_params"]["checkpoint_path"] = ckpt
    raw["tpu_params"].update(tpu or {})
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, ckpt
