"""Test-set evaluation on one GPU: ``python -m tpu3dssf_torch.cli.main_test
--config <yaml>``.

Port of ``tpu3dssf.cli.main_test``: restores the latest checkpoint under
``test_params.checkpoint_path`` (else ``checkpoint_path``) with the port's
``train.checkpoint.restore_checkpoint``, evaluates the test split, prints
the metric block and writes ``per_class_iou.png`` into that directory.
Without a checkpoint it evaluates the seeded random init and says so;
without matplotlib it skips the chart and says so. On the card the encode
and eval steps replay one CUDA graph per batch shape
(:mod:`tpu3dssf_torch.train.graph`).

``--device`` defaults to ``cuda``: without a CUDA device the CLI raises
(it never drops to the CPU). ``--device cpu`` runs the plain versions of
the kernels, for tests on a tiny config.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/nuscenes_default.yaml")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint
    from tpu3dssf_torch.train.graph import graphed
    from tpu3dssf_torch.train.loop import evaluate_model, make_eval_step
    from tpu3dssf_torch.utils.viz import plot_iou_per_class

    cfg = common.load_config(args.config)
    print(f"Loaded config from: {args.config}")
    device = common.resolve_device(args.device)

    loaders = common.build_dataloaders(cfg)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model)

    ckpt = cfg.test_checkpoint_path or cfg.checkpoint_path
    try:
        state, _, step = restore_checkpoint(ckpt, None, state)
        print(f"Loaded checkpoint from {ckpt} (step {step})")
    except FileNotFoundError:
        print(f"[warn] no checkpoint under {ckpt}; evaluating random init")

    def zero_tokens_fn(b):
        return common.zero_tokens(cfg, vit_cfg, b["points"].shape[0], device)

    metrics = evaluate_model(
        state.model, loaders["test"],
        graphed(make_eval_step(common.build_loss(cfg), cfg.mlp_class),
                "eval_step"), encode_fn,
        cfg.mlp_class, zero_tokens_fn=None if encode_fn else zero_tokens_fn)

    class_names = None
    if cfg.label_mapping and os.path.exists(cfg.label_mapping):
        class_names = common.load_class_dict(cfg.label_mapping)
    try:
        path = plot_iou_per_class(metrics["iou_per_class"], class_names,
                                  ckpt)
        print(f"Per-class IoU chart: {path}")
    except ImportError as e:  # matplotlib is optional: the chart only
        print(f"[warn] per_class_iou.png not written ({e})")
    return metrics


if __name__ == "__main__":
    main()
