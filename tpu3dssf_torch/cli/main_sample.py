"""Single-batch demo on one GPU: ``python -m tpu3dssf_torch.cli.main_sample
--config <yaml>``.

Port of ``tpu3dssf.cli.main_sample``: one batch of the test split through
the model (restored from ``test_params.checkpoint_path``, else
``checkpoint_path``, or the seeded random init, which it says), its metric
block, and the visualizations of its first sample into that directory:
``segmentation_result.html`` (GT vs prediction in 3D) and, when the batch
has camera images and PIL is installed, ``cam_{i}_prediction.png``.

``--device`` defaults to ``cuda``: without a CUDA device the CLI raises
(it never drops to the CPU). ``--device cpu`` runs the plain versions of
the kernels, for tests on a tiny config. It runs its one batch eagerly: a
CUDA graph pays for its capture only over many batches.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/nuscenes_default.yaml")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.metrics import (confusion_matrix,
                                        evaluate_from_confusion,
                                        format_metrics)
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint
    from tpu3dssf_torch.utils.viz import (plot_comparison_cloud,
                                          plot_images_with_point_cloud)

    cfg = common.load_config(args.config)
    print(f"Loaded config from: {args.config}")
    device = common.resolve_device(args.device)

    loaders = common.build_dataloaders(cfg)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device,
                                                    graph=False)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model)

    ckpt = cfg.test_checkpoint_path or cfg.checkpoint_path
    try:
        state, _, step = restore_checkpoint(ckpt, None, state)
        print(f"Loaded checkpoint from {ckpt} (step {step})")
    except FileNotFoundError:
        print(f"[warn] no checkpoint under {ckpt}; using random init")

    batches = iter(loaders["test"])
    host = next(batches)
    batches.close()   # stop the prefetch thread
    images = host.pop("images", None)
    batch = common.batch_to_device(host, device)
    if encode_fn is not None and images is not None:
        tokens = encode_fn(torch.as_tensor(images).to(device))
    else:
        tokens = common.zero_tokens(cfg, vit_cfg, batch["points"].shape[0],
                                    device)
    with torch.inference_mode():
        logits = state.model(batch["points"], batch["point_valid"], tokens,
                             batch["cam_intrinsics"], batch["lidar2cam"])
        out = common.build_loss(cfg)(logits, batch["labels"], batch["mask"])
        cm = confusion_matrix(out.predictions, batch["labels"],
                              cfg.mlp_class, out.valid)
    metrics = {k: v.cpu().numpy() for k, v in evaluate_from_confusion(
        cm.cpu().to(torch.float32), float(out.total), float(out.num_correct),
        float(out.num_valid), 1).items()}
    print(format_metrics(metrics))

    # visualization: the first sample of the batch, valid points only
    valid0 = out.valid[0].cpu().numpy()
    pts0 = host["points"][0][valid0]
    gt0 = host["labels"][0][valid0]
    pr0 = out.predictions[0].cpu().numpy()[valid0]
    save_dir = ckpt or "."
    html = plot_comparison_cloud(pts0, gt0, pr0, save_dir)
    print(f"3D comparison: {html}")
    if images is not None:
        try:
            paths = plot_images_with_point_cloud(
                np.asarray(images[0]), pts0, pr0, gt0,
                host["cam_intrinsics"][0], host["lidar2cam"][0], save_dir)
            print(f"Camera overlays: {paths}")
        except ImportError as e:  # PIL is optional: the overlays only
            print(f"[warn] camera overlays not written ({e})")
    return metrics


if __name__ == "__main__":
    main()
