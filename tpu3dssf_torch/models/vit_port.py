"""Local DINO checkpoints (HF layout) into the port's ViT.

Port of ``tpu3dssf.models.vit_port``. The reference loads
``facebook/dinov2-small`` / ``facebook/dinov3-vits16-pretrain-lvd1689m``
through HF transformers (utils/camera.py:15-34). Nothing is downloaded
here: where a checkpoint exists locally (``TPU3DSSF_VIT_CHECKPOINT``, the
``TPU3DSSF_WEIGHTS`` directory, default ``./weights``, or the HF cache
under ``HF_HOME``), its state dict is mapped onto the JAX package's flax
tree, then onto the port's ``state_dict`` with
:func:`tpu3dssf_torch.convert.vit_state_dict_from_flax`; otherwise the
caller keeps its seeded random init.

Files are read without ``transformers`` or ``safetensors``: ``.bin`` and
``.pth`` with ``torch.load(weights_only=True)``, ``.safetensors`` with
:func:`load_safetensors`, a small reader of that format.

Mapping (HF Dinov2Model naming; DINOv3ViTModel's in
:func:`port_hf_state_dict`):
  embeddings.patch_embeddings.projection  → patch_embed (OIHW→HWIO)
  embeddings.cls_token / register_tokens  → cls_token / register_tokens
  embeddings.position_embeddings          → pos_embed
  encoder.layer.N.norm1/norm2             → blockN.norm1/norm2
  ...attention.{query,key,value}          → blockN.qkv (concatenated)
  ...attention.output.dense               → blockN.proj
  ...layer_scale{1,2}.lambda1             → blockN.ls{1,2}.gamma
  ...mlp.fc1/fc2                          → blockN.mlp_in/mlp_out
  layernorm                               → norm
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

HF_MODEL_IDS = {
    "dinov2": "facebook/dinov2-small",
    "dinov3": "facebook/dinov3-vits16-pretrain-lvd1689m",
    "dinov3_large": "facebook/dinov3-vitl16-pretrain-lvd1689m",
}


def _find_local_checkpoint(name: str) -> Optional[str]:
    """Locate a local torch checkpoint for the given encoder name."""
    explicit = os.environ.get("TPU3DSSF_VIT_CHECKPOINT")
    if explicit and os.path.exists(explicit):
        return explicit
    weights_dir = os.environ.get("TPU3DSSF_WEIGHTS", "./weights")
    for fname in (f"{name}.safetensors", f"{name}.bin", f"{name}.pth"):
        p = os.path.join(weights_dir, fname)
        if os.path.exists(p):
            return p
    # HF cache layout
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    model_id = HF_MODEL_IDS[name].replace("/", "--")
    snap_root = os.path.join(cache, "hub", f"models--{model_id}",
                             "snapshots")
    if os.path.isdir(snap_root):
        for snap in sorted(os.listdir(snap_root)):
            for fname in ("model.safetensors", "pytorch_model.bin"):
                p = os.path.join(snap_root, snap, fname)
                if os.path.exists(p):
                    return p
    return None


# safetensors dtype names → numpy dtypes; BF16 is read as uint16 and widened
_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
           "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (BF16 as
    float32): an 8-byte little-endian header length, a JSON header mapping
    each name to its dtype, shape and [begin, end) byte offsets after the
    header, then the raw little-endian tensors."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        x = np.frombuffer(data[begin:end], _DTYPES[info["dtype"]]).reshape(
            info["shape"])
        if info["dtype"] == "BF16":
            x = torch.from_numpy(x.copy()).view(torch.bfloat16).float().numpy()
        out[name] = x.copy()
    return out


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items()}


def port_hf_state_dict(sd, vit_cfg):
    """Map an HF Dinov2 or DINOv3 state dict onto the JAX package's flax
    param tree (unrolled ``block{i}``), as numpy arrays.

    Handles both naming conventions:

      Dinov2Model: ``embeddings.patch_embeddings.projection.*``,
        ``encoder.layer.N.attention.attention.{query,key,value}``,
        ``...attention.output.dense``, ``...mlp.fc{1,2}``, ``layernorm``.
      DINOv3ViTModel: ``embeddings.patch_embeddings.*`` (bare conv),
        ``layer.N.attention.{q,k,v,o}_proj`` (k_proj has NO bias —
        DINOv3ViTConfig key_bias=False), ``...mlp.{up,down}_proj``,
        ``norm``.
    """
    C = vit_cfg.hidden_size

    def get(*names, default=None):
        for n in names:
            if n in sd:
                return np.asarray(sd[n])
        if default is not None:
            return default
        raise KeyError(f"none of {names} in state dict "
                       f"(have e.g. {sorted(sd)[:5]})")

    params = {}
    w = get("embeddings.patch_embeddings.projection.weight",
            "embeddings.patch_embeddings.weight")
    params["patch_embed"] = {
        "kernel": np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
        "bias": get("embeddings.patch_embeddings.projection.bias",
                    "embeddings.patch_embeddings.bias"),
    }
    params["cls_token"] = get("embeddings.cls_token").reshape(1, 1, C)
    if vit_cfg.num_register_tokens:
        params["register_tokens"] = get(
            "embeddings.register_tokens").reshape(
            1, vit_cfg.num_register_tokens, C)
    if not vit_cfg.use_rope:
        pos = get("embeddings.position_embeddings")
        params["pos_embed"] = pos.reshape(1, -1, C)

    for i in range(vit_cfg.num_layers):
        pres = (f"encoder.layer.{i}.", f"layer.{i}.")

        def lget(*suffixes, default=None):
            names = [p + s for s in suffixes for p in pres]
            return get(*names, default=default)

        q_w = lget("attention.attention.query.weight",
                   "attention.q_proj.weight")
        k_w = lget("attention.attention.key.weight",
                   "attention.k_proj.weight")
        v_w = lget("attention.attention.value.weight",
                   "attention.v_proj.weight")
        zeros = np.zeros(C, q_w.dtype)
        q_b = lget("attention.attention.query.bias",
                   "attention.q_proj.bias", default=zeros)
        k_b = lget("attention.attention.key.bias",
                   "attention.k_proj.bias", default=zeros)
        v_b = lget("attention.attention.value.bias",
                   "attention.v_proj.bias", default=zeros)
        blk = {
            "norm1": {"scale": lget("norm1.weight"),
                      "bias": lget("norm1.bias")},
            "norm2": {"scale": lget("norm2.weight"),
                      "bias": lget("norm2.bias")},
            # torch Linear weight is (out, in) → flax kernel (in, out)
            "qkv": {"kernel": np.concatenate(
                        [q_w.T, k_w.T, v_w.T], axis=1),
                    "bias": np.concatenate([q_b, k_b, v_b])},
            "proj": {"kernel": lget("attention.output.dense.weight",
                                    "attention.o_proj.weight").T,
                     "bias": lget("attention.output.dense.bias",
                                  "attention.o_proj.bias")},
            "mlp_in": {"kernel": lget("mlp.fc1.weight",
                                      "mlp.up_proj.weight").T,
                       "bias": lget("mlp.fc1.bias",
                                    "mlp.up_proj.bias")},
            "mlp_out": {"kernel": lget("mlp.fc2.weight",
                                       "mlp.down_proj.weight").T,
                        "bias": lget("mlp.fc2.bias",
                                     "mlp.down_proj.bias")},
        }
        if vit_cfg.layerscale_init is not None:
            blk["ls1"] = {"gamma": lget("layer_scale1.lambda1")}
            blk["ls2"] = {"gamma": lget("layer_scale2.lambda1")}
        params[f"block{i}"] = blk

    params["norm"] = {"scale": get("layernorm.weight", "norm.weight"),
                      "bias": get("layernorm.bias", "norm.bias")}
    return {"params": params}


def try_load_pretrained(name: str, vit) -> Optional[str]:
    """Load the local checkpoint of encoder ``name`` (a key of
    :data:`HF_MODEL_IDS`) into the port's ViT ``vit`` (built with
    LayerScale, before ``fold_layerscale``); returns its path, or None
    where no local file exists (``vit`` keeps its weights)."""
    from tpu3dssf_torch.convert import vit_state_dict_from_flax

    path = _find_local_checkpoint(name)
    if path is None:
        return None
    print(f"[vit_port] porting {name} weights from {path}")
    params = port_hf_state_dict(_load_state_dict(path), vit.config)
    vit.load_state_dict(vit_state_dict_from_flax(params, vit.config))
    return path
