"""JAX (flax) parameters → ``state_dict``s of the port's modules.

Takes the JAX package's parameter trees as nested dicts of numpy arrays
(``jax.device_get(params)``) and returns float32 tensors keyed like the
port's modules, whose submodule names follow the flax names. Layout rules:

* Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
* LayerNorm ``scale`` → ``weight``;
* ``_DepthwiseConv3`` ``kernel`` (3, 1, C) keeps its layout (the port also
  runs it as three shifted multiply-adds);
* the ViT patch-embed kernel (P, P, 3, C) flattens row-major as
  (kh, kw, cin) into ``patch_embed.weight`` (C, P·P·3);
* a W8A8 ``QuantDense`` (``quantize_vit``): ``kernel_q`` (in, out) int8 →
  ``kernel_q`` (out, in) int8, contiguous; its ``scale`` and ``bias`` stay
  f32 under their own names;
* everything else (``bias``, ``gamma``, tokens, ``pos_embed``) as it is.

A PTv3 tree in the JAX package's ``scan_blocks`` layout is unstacked on the
way in (:func:`pipeline_state_dict_from_flax`). This module needs neither
JAX nor flax.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from tpu3dssf_torch.train.convert import convert_tree

_VIT_BLOCK = re.compile(r"^block(\d+)$")


def _unwrap(params):
    if set(params) == {"params"}:
        return params["params"]
    return params


def _leaf(path, value) -> Dict[str, np.ndarray]:
    *mods, name = path
    value = np.asarray(value, dtype=np.float32)
    if name == "kernel" and value.ndim == 2:
        name, value = "weight", value.T
    elif name == "kernel" and value.ndim == 4:  # patch embed (P, P, 3, C)
        name, value = "weight", value.reshape(-1, value.shape[-1]).T
    elif name == "scale":
        name = "weight"
    return {".".join(mods + [name]): value}


def _quant_dense(path, tree) -> Dict[str, np.ndarray]:
    """A ``QuantDense``'s leaves: int8 ``kernel_q`` transposed to (out, in),
    f32 ``scale`` and ``bias``."""
    name = ".".join(path)
    return {f"{name}.kernel_q": np.ascontiguousarray(
                np.asarray(tree["kernel_q"], np.int8).T),
            f"{name}.scale": np.asarray(tree["scale"], np.float32),
            f"{name}.bias": np.asarray(tree["bias"], np.float32)}


def _flatten(tree: Mapping, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping) and "kernel_q" in value:
            out.update(_quant_dense(prefix + (key,), value))
        elif isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out.update(_leaf(prefix + (key,), value))
    return out


def _to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def pipeline_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """``SegmentationPipeline`` params (``ptv3`` + ``fusion``) →
    ``tpu3dssf_torch.models.SegmentationPipeline`` state_dict. PTv3 blocks
    may be unrolled (``enc{s}_blk{b}``) or stacked by the JAX package's
    ``scan_blocks`` (``enc{s}_scan``, a leading depth axis), which this
    unstacks first (:func:`tpu3dssf_torch.train.convert.convert_tree`)."""
    p = _unwrap(params)
    if any(k.endswith("_scan") for k in p.get("ptv3", {})):
        p = dict(p, ptv3=convert_tree(p["ptv3"], to_scan=False))
    return state_dict_from_flax(p)


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """Any unrolled module's params (``PointTransformerV3``,
    ``FeatureFusionModel``, a Dense, ...) → its state_dict."""
    return _to_torch(_flatten(_unwrap(params)))


def _unstack(tree: Mapping, i: int):
    """Layer ``i`` of a stacked (leading layer axis) subtree."""
    return {k: (_unstack(v, i) if isinstance(v, Mapping)
                else np.asarray(v)[i]) for k, v in tree.items()}


def vit_state_dict_from_flax(params, vit_cfg) -> Dict[str, torch.Tensor]:
    """``VisionTransformer`` params → the port's ViT state_dict.

    Accepts the stacked ``blocks`` tree (``scan_layers=True``, every leaf
    with a leading layer axis) and the unrolled ``block{i}`` tree, with or
    without LayerScale (before or after ``fold_layerscale``), float or W8A8
    (after ``quantize_vit``); the port's ViT must be built with the
    matching ``layerscale_init`` and ``quant_int8``.
    """
    p = dict(_unwrap(params))
    L = vit_cfg.num_layers
    if "blocks" in p:
        stacked = p.pop("blocks")
        layers = [_unstack(stacked, i) for i in range(L)]
    else:
        found = sorted(int(m.group(1)) for m in map(_VIT_BLOCK.match, p)
                       if m)
        if found != list(range(L)):
            raise ValueError(f"ViT tree has layers {found}, config says {L}")
        layers = [p.pop(f"block{i}") for i in range(L)]
    flat = _flatten(p)
    for i, layer in enumerate(layers):
        flat.update(_flatten(layer, ("blocks", str(i))))
    return _to_torch(flat)
