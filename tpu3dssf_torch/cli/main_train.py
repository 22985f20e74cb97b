"""Training on one GPU: ``python -m tpu3dssf_torch.cli.main_train --config
<yaml>``.

Port of ``tpu3dssf.cli.main_train`` for a single device: the frozen ViT
encodes each batch's cameras, the fusion pipeline (voxelize → PTv3 →
fusion head → devoxelize) trains under CE + λ·Lovász with the config's
optimizer and schedule, and every epoch ends with a validation pass. It
prints the JAX CLI's per-window train lines, the val metric block and
``Best val Acc``, and writes checkpoints (best, and ``last/`` every epoch),
``training_history.json`` and the history plot under ``checkpoint_path``.

Flags: ``--config``, ``--resume`` (full train state from
``<checkpoint_path>/last``), ``--tee-log``, ``--profile-dir`` (a
``torch.profiler`` trace of train steps 10–13, ``train_trace.json``, with
the program's spans on from the first step: their ``tpu3dssf::`` ranges
in the trace and their sums by name in ``spans.json`` beside it; the
spans put event-record nodes into the train and encode graphs, about 64
and 6 beside their 5,695 and 327 kernels at the benchmark's batch-12
fusion step, so the trace is of those graphs: on an H100 they moved the
traced window's idle share by under 0.3 points, and a step's time without
the profiler within its run-to-run spread) and ``--device``, which
defaults to ``cuda``: without a CUDA device the CLI raises (it never drops
to the CPU). ``--device cpu`` runs the plain versions of the kernels, for
tests on a tiny config. ``tpu_params.mesh_shape`` is ignored, as the JAX
CLI ignores it: training runs on one device, and says so where the mesh is
larger than one. The model starts from seeded random weights; the
frozen image encoder from a local DINO checkpoint where one exists
(``common.build_vit``). On the card the encode, train and eval steps each
replay one CUDA graph per batch shape (:mod:`tpu3dssf_torch.train.graph`)
under every configuration: the plateau, the non-finite skip, the schedule
and SGD's momentum are device state, and the DropPath masks an input of
the graph.
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

DROPOUT_SEED = 42


def main(argv=None, seed=1):
    """The CLI on ``argv``; ``seed`` draws the model's initial weights
    (``common.build_pipeline``'s, not a flag: the JAX CLI has none).
    Returns (state, train history, val history)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/nuscenes_default.yaml",
                        help="Path to config YAML file")
    parser.add_argument("--tee-log", action="store_true",
                        help="tee stdout/stderr to <ckpt>/train.log")
    parser.add_argument("--resume", action="store_true",
                        help="resume full train state (weights + optimizer "
                             "+ schedule + epoch) from <ckpt>/last")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of train steps "
                             "10-13 (with the program's spans on) and the "
                             "spans' sums into this directory")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint
    from tpu3dssf_torch.train.loop import train_model

    cfg = common.load_config(args.config)
    print(f"Loaded config from: {args.config}")
    print("Start training in "
          + ("DEBUG mode" if cfg.debug else "FULL DATASET mode"))
    if args.tee_log:
        common.tee_stdout(cfg.checkpoint_path)
    device = common.resolve_device(args.device)
    if int(np.prod(cfg.tpu.mesh_shape)) > 1:
        # as the JAX CLI, which never reads the mesh: the data-parallel
        # step is a library function (train.loop.make_train_step(mesh=...))
        print(f"[warn] tpu_params.mesh_shape {list(cfg.tpu.mesh_shape)} is "
              "ignored: main_train trains on one device")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Using device: {device} ({name})")

    datasets = common.build_datasets(cfg)
    loaders = common.build_dataloaders(cfg, datasets)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device, seed=seed)
    loss_fn = common.build_loss(cfg)
    steps_per_epoch = max(1, len(loaders["train"]))
    state = common.init_state(cfg, model, steps_per_epoch)

    start_epoch, best_acc = 0, -1.0
    if args.resume:
        try:
            state, extra, step = restore_checkpoint(
                os.path.join(cfg.checkpoint_path, "last"), None, state)
            start_epoch = int(extra.get("epoch", step)) + 1
            best_acc = float(extra.get("best_acc", -1.0))
            print(f"Resumed full train state at epoch {start_epoch} "
                  f"(best_acc={best_acc:.4f})")
        except FileNotFoundError:
            print("[warn] --resume set but no last/ checkpoint; "
                  "training from scratch")
    elif cfg.train_best_weights and cfg.best_model_path:
        ckpt_dir = os.path.dirname(cfg.best_model_path) or \
            cfg.best_model_path
        try:
            state, extra, step = restore_checkpoint(ckpt_dir, None, state)
            print(f"Resumed from {ckpt_dir} step {step} "
                  f"(best_acc={extra.get('best_acc')})")
        except FileNotFoundError:
            print(f"[warn] train_best_weights set but no checkpoint at "
                  f"{ckpt_dir}; training from scratch")

    logger = common.create_logger(cfg.checkpoint_path, config=cfg.raw)

    def zero_tokens_fn(b):
        return common.zero_tokens(cfg, vit_cfg, b["points"].shape[0], device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tr_hist, val_hist = train_model(
        state, loaders, loss_fn, encode_fn,
        num_classes=cfg.mlp_class,
        num_epochs=cfg.max_num_epochs,
        save_dir=cfg.checkpoint_path,
        logger=logger,
        zero_tokens_fn=None if encode_fn else zero_tokens_fn,
        profile_dir=args.profile_dir,
        start_epoch=start_epoch,
        best_acc=best_acc,
        dropout_seed=DROPOUT_SEED if cfg.drop_path > 0 else None,
        grad_accum=cfg.tpu.grad_accum,
    )
    logger.finish()
    try:
        common.plot_training_history(tr_hist, val_hist, cfg.checkpoint_path)
    except ImportError as e:  # matplotlib is optional: the plot only
        print(f"[warn] training_history.png not written ({e})")
    print(f"Artifacts written to {cfg.checkpoint_path}")
    return state, tr_hist, val_hist


if __name__ == "__main__":
    main()
