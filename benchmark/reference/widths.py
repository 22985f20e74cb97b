"""The widths of a configuration's models: one table, read by the reference
models, the benchmark's seeded weights and its counts of work.

It is resolved from the configuration as the program resolves it: the
image encoder by ``image_encoder`` (``none``: the LiDAR-only model), whose
widths are the file ``encoders/<image_encoder>.json``; PTv3 at the base
widths with the configuration's window; the fusion head's hidden layers
between the PTv3 feature joined to the patch token and the
configuration's classes. The program's models must take the weights drawn
from this table name for name and shape for shape
(:func:`benchmark.harness.weights.load`), so a table that drifts from the
program fails the run's set-up.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

from benchmark.reference.vit import ViTConfig

ENCODERS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "encoders")


def encoder(name: str) -> ViTConfig:
    """The widths of image encoder ``name``: ``encoders/<name>.json``, the
    fields of :class:`benchmark.reference.vit.ViTConfig` (and an
    ``about``)."""
    path = os.path.join(ENCODERS, name + ".json")
    if not os.path.isfile(path):
        raise NotImplementedError(
            f"the reference has no image encoder {name!r} (no {path})")
    with open(path) as f:
        raw = json.load(f)
    raw.pop("about", None)
    raw["image_size"] = tuple(raw["image_size"])
    return ViTConfig(**raw)


# the reference's FeatureFusionModel: the joined feature, 256, 64, classes
FUSION_HIDDEN = (256, 64)


@dataclasses.dataclass(frozen=True)
class PTv3Widths:
    """Point Transformer V3's base model (Wu et al., CVPR 2024)."""

    window: int = 1024
    in_channels: int = 4
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_heads: Tuple[int, ...] = (2, 4, 8, 16, 32)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_heads: Tuple[int, ...] = (4, 4, 8, 16)
    mlp_ratio: float = 4.0

    @property
    def stages(self) -> int:
        return len(self.enc_depths)

    @property
    def out_channels(self) -> int:
        return self.dec_channels[0]


@dataclasses.dataclass(frozen=True)
class Widths:
    ptv3: PTv3Widths
    vit: Optional[ViTConfig]      # None: the LiDAR-only model
    head: Tuple[int, ...]         # the head's dense widths, input to classes

    @property
    def fusion(self) -> bool:
        return self.vit is not None

    @property
    def classes(self) -> int:
        return self.head[-1]


def of(cfg) -> Widths:
    """The table of a loaded configuration (the program's ``Config``)."""
    ptv3 = PTv3Widths(window=cfg.tpu.window_size)
    if cfg.image_encoder == "none":
        return Widths(ptv3, None, (ptv3.out_channels, cfg.mlp_class))
    vit = encoder(cfg.image_encoder)
    return Widths(ptv3, vit, (ptv3.out_channels + vit.hidden_size,)
                  + FUSION_HIDDEN + (cfg.mlp_class,))
