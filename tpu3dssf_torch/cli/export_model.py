"""Export the configured inference pipeline as a ``torch.export`` artifact.

Port of ``scripts/export_model.py``:

    python -m tpu3dssf_torch.cli.export_model --config <yaml> \
        --out model.pt2 [--checkpoint DIR] [--device cuda] [--package]

The artifact holds the pipeline's (checkpoint or seeded random-init)
weights and runs without any of the port's model code: load it with
:func:`tpu3dssf_torch.export.load_exported`, which needs ``torch`` and
:mod:`tpu3dssf_torch.kernels` only. With ``--package`` the file is
instead an AOTInductor package of the same program
(:func:`tpu3dssf_torch.export.compile_infer_package`), which
:func:`tpu3dssf_torch.export.load_package` loads in Python and
``csrc/aoti_runner.cpp`` in a process without Python. It takes ``(points, point_valid,
patch_tokens, cam_intrinsics, lidar2cam)`` at the shapes of one val batch
of batch size 1, patch tokens in the compute dtype; the frozen encoder
exports the same way. ``--device`` defaults to ``cuda`` (the artifact then
launches the Hopper kernels and needs a card); without a CUDA device the
CLI raises. ``--device cpu`` exports the plain versions, for tests.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def vit_geometry(cfg):
    """The encoder's config (token count and width for the fusion head),
    without building or loading the ViT; None for the LiDAR-only model."""
    if cfg.image_encoder == "none":
        return None
    from tpu3dssf_torch.models.vit import (dinov2_small, dinov3_large,
                                           dinov3_small)
    return {"dinov2": dinov2_small, "dinov3": dinov3_small,
            "dinov3_large": dinov3_large}[cfg.image_encoder]()


def pipeline_args(cfg, batch, device, checkpoint=None):
    """The pipeline of ``cfg`` on ``device`` and its example arguments on
    ``batch`` (a dict of tensors on ``device``) with zero patch tokens in
    the compute dtype: (the model, the arguments). With ``checkpoint`` the
    weights are restored from that directory."""
    from tpu3dssf_torch.cli import common

    vit_cfg = vit_geometry(cfg)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    # trace with the dtype the serving encoder emits: the artifact takes
    # the example's dtypes
    tokens = common.zero_tokens(cfg, vit_cfg, batch["points"].shape[0],
                                device).to(common.compute_dtype(cfg))
    if checkpoint:
        from tpu3dssf_torch.train.checkpoint import restore_checkpoint
        state, _extra, step = restore_checkpoint(
            checkpoint, None, common.init_state(cfg, model))
        print(f"restored checkpoint step {step}")
        model = state.model
    args = (batch["points"], batch["point_valid"], tokens,
            batch["cam_intrinsics"], batch["lidar2cam"])
    return model, args


def export_pipeline(cfg, batch, device, checkpoint=None):
    """:func:`pipeline_args`, exported: (artifact bytes, the model, the
    example arguments)."""
    from tpu3dssf_torch.export import export_infer_bytes
    model, args = pipeline_args(cfg, batch, device, checkpoint)
    return export_infer_bytes(model, args), model, args


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (default: random init)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--package", action="store_true",
                    help="write an AOTInductor package in place of the "
                         "torch.export archive")
    args = ap.parse_args(argv)

    from tpu3dssf_torch.cli import common

    cfg = common.load_config(args.config)
    device = common.resolve_device(args.device)
    batch = common.example_batch(cfg, common.build_datasets(cfg))
    batch.pop("images", None)
    batch = common.batch_to_device(batch, device)
    if args.package:
        from tpu3dssf_torch.export import compile_infer_package
        model, example = pipeline_args(cfg, batch, device, args.checkpoint)
        compile_infer_package(model, example, args.out)
        kind = " AOTInductor package"
    else:
        blob, _, _ = export_pipeline(cfg, batch, device, args.checkpoint)
        with open(args.out, "wb") as f:
            f.write(blob)
        kind = ""
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} "
          f"MB{kind}, platform={device.type})")


if __name__ == "__main__":
    main()
