"""End-to-end A/B of the reference-parity modes on one GPU:
``python -m tpu3dssf_torch.cli.parity_ab --config <yaml> --checkpoint
[LABEL=]DIR [--checkpoint ...]``.

Port of ``scripts/parity_ab.py``. One set of weights runs the full
pipeline over many frames in three variants, which differ only in the
voxelizer's intensity mode and the devoxelizer:

  default      intensity_mode=mean + devoxelize_mode=own
  devox-parity mean + nearest   (the devoxelize divergence alone)
  full-parity  knn5 + nearest   (adds the 5-NN intensity transfer)

Per frame it measures each variant's prediction agreement with full-parity
and its point accuracy (mean ± 1.96·σ/√N over the frames), and per class
the same aggregated over all valid points. The frames come from a stream
of their own (``SyntheticNuScenes(seed=7, cache=False)``, disjoint from
the train, val and test seeds), rounded up to the batch size; a real
dataset uses its val split. The report is the JAX script's markdown.

Each ``--checkpoint`` is a directory of the port's checkpoints
(``train.checkpoint``; ``main_train`` writes the best under
``checkpoint_path``), restored once into the config's model; the three
variants are copies of that model with their modes set, never re-drawn.
Given more than once (``LABEL=DIR``), the report opens with the
train-mode × eval-mode accuracy table. Without a checkpoint the variants
share the seeded random init, whose argmax is near noise.

On the card each variant's forward replays one CUDA graph per batch shape
(:func:`tpu3dssf_torch.train.graph.graphed`, the counterpart of the JAX
script's ``jax.jit(...apply)``). ``--device`` defaults to ``cuda``:
without a CUDA device the CLI raises; ``--device cpu`` runs the plain
versions of the kernels, for tests on a tiny config. ``--out`` defaults
to ``parity_ab.md`` in the first checkpoint directory (else the config's
``checkpoint_path``): the repository's ``PARITY_AB.md`` is the TPU's
record and is never written here.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu3dssf_torch.train.graph import graphed  # noqa: E402

VARIANTS = {
    "default": ("mean", "own"),
    "devox-parity": ("mean", "nearest"),
    "full-parity": ("knn5", "nearest"),
}
STREAM_SEED = 7
REPORT = "parity_ab.md"


def frame_stream(cfg, datasets, frames: int, batch_size: int):
    """The host pipeline over at least ``frames`` frames, rounded up to
    ``batch_size``: a synthetic stream of its own (seed 7, no cache), or
    the val split of a real dataset."""
    from tpu3dssf_torch.cli.common import HostDataPipeline, SyntheticNuScenes

    n_samples = ((frames + batch_size - 1) // batch_size) * batch_size
    if cfg.tpu.dataset == "synthetic":
        ds = SyntheticNuScenes(
            num_samples=n_samples, seed=STREAM_SEED,
            num_points=cfg.tpu.synthetic_points,
            image_hw=tuple(cfg.tpu.synthetic_image_hw),
            render_semantics=cfg.tpu.synthetic_render, cache=False)
    else:
        ds = datasets["val"]
    return HostDataPipeline(ds, batch_size=batch_size,
                            point_capacity=cfg.tpu.point_capacity)


def load_variants(cfg, vit_cfg, checkpoint, device):
    """The config's model, restored from ``checkpoint`` (a directory of
    port checkpoints; None keeps the seeded init), and one copy of it per
    variant with that variant's modes. Returns ({variant: model}, step or
    None)."""
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint

    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    step = None
    if checkpoint:
        state = common.init_state(cfg, model)
        state, _, step = restore_checkpoint(checkpoint, None, state)
        print(f"loaded trained params (step {step}) from {checkpoint}")
    models = {}
    for name, (intensity, devox) in VARIANTS.items():
        m = copy.deepcopy(model).eval()
        m.config = dataclasses.replace(m.config, intensity_mode=intensity,
                                       devoxelize_mode=devox)
        models[name] = m
    return models, step


@torch.inference_mode()
def forward(model, batch, tokens):
    """One variant's step: the pipeline's point logits."""
    return model(batch["points"], batch["point_valid"], tokens,
                 batch["cam_intrinsics"], batch["lidar2cam"])


def mci(xs):
    """(mean, 1.96·σ/√N) of per-frame samples (σ with N − 1)."""
    xs = np.asarray(xs)
    m = xs.mean()
    ci = 1.96 * xs.std(ddof=1) / np.sqrt(len(xs)) if len(xs) > 1 else 0.0
    return m, ci


def run(config_path, checkpoint, frames, batch_size, device="cuda"):
    """The three variants of one set of weights over ``frames`` frames:
    the JAX script's result dict (``trained``, ``frames``, ``batch_size``,
    ``rows``, ``acc_full``, ``per_class``) and the per-frame samples
    (``agree_frames``, ``acc_frames``), the kernel launches of each
    variant over the run (``launches``, with ``batches``) and the seconds
    spent waiting for host frames and on the device's forwards
    (``host_s``, ``device_s``)."""
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.kernels.modules import launch_counts

    device = common.resolve_device(str(device))
    cfg = common.load_config(config_path)
    datasets = (common.build_datasets(cfg) if cfg.tpu.dataset != "synthetic"
                else None)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device)
    pipe = frame_stream(cfg, datasets, frames, batch_size)
    models, step = load_variants(cfg, vit_cfg, checkpoint, device)
    steps = {name: graphed(forward, f"parity_ab {name}")
             for name in VARIANTS}

    n_cls = cfg.mlp_class
    # per-frame agreement / accuracy samples
    agree = {"default": [], "devox-parity": []}
    acc = {name: [] for name in VARIANTS}
    # per-class aggregates over ALL valid points
    cls_agree_hit = {v: np.zeros(n_cls) for v in agree}   # pred match
    cls_ref_count = np.zeros(n_cls)                        # full-parity pred c
    cls_acc_hit = {v: np.zeros(n_cls) for v in VARIANTS}
    cls_lab_count = np.zeros(n_cls)
    launches = {name: {} for name in VARIANTS}

    done, batches, host_s, device_s = 0, 0, 0.0, 0.0
    it = iter(pipe)
    while done < frames:
        t0 = time.perf_counter()
        batch = next(it, None)
        host_s += time.perf_counter() - t0
        if batch is None:
            break
        t0 = time.perf_counter()
        images = batch.pop("images", None)
        tb = common.batch_to_device(batch, device)
        tokens = (encode_fn(torch.as_tensor(images).to(device))
                  if encode_fn is not None and images is not None
                  else common.zero_tokens(cfg, vit_cfg,
                                          tb["points"].shape[0], device))
        preds = {}
        for name, fn in steps.items():
            before = launch_counts()
            logits = fn(models[name], tb, tokens)
            after = launch_counts()
            for k, n in after.items():
                if n - before[k]:
                    launches[name][k] = launches[name].get(k, 0) \
                        + n - before[k]
            preds[name] = logits.float().cpu().numpy().argmax(-1)
        device_s += time.perf_counter() - t0
        batches += 1
        valid = batch["point_valid"] & (batch["labels"] != 0)
        labels = batch["labels"] - 1
        for b in range(valid.shape[0]):
            if done >= frames:
                break
            m = valid[b]
            ref = preds["full-parity"][b][m]
            lab = labels[b][m]
            cls_ref_count += np.bincount(ref, minlength=n_cls)
            cls_lab_count += np.bincount(lab, minlength=n_cls)
            for name in VARIANTS:
                p = preds[name][b][m]
                acc[name].append(float((p == lab).mean()))
                cls_acc_hit[name] += np.bincount(
                    lab[p == lab], minlength=n_cls)
                if name in agree:
                    agree[name].append(float((p == ref).mean()))
                    cls_agree_hit[name] += np.bincount(
                        ref[p == ref], minlength=n_cls)
            done += 1
        if (batches - 1) % 8 == 0:
            print(f"  frame {done}/{frames}")
    it.close()
    print(f"parity_ab: {done} frames in {batches} batches; host frames "
          f"{host_s:.2f} s waited, device forwards {device_s:.2f} s")

    rows = []
    for name in ("default", "devox-parity"):
        m, ci = mci(agree[name])
        am, aci = mci(acc[name])
        rows.append({"variant": name, "agree_mean": m, "agree_ci": ci,
                     "agree_min": float(np.min(agree[name])),
                     "acc_mean": am, "acc_ci": aci})
    fm, fci = mci(acc["full-parity"])
    per_class = []
    for c in range(n_cls):
        per_class.append({
            "cls": c + 1,
            "ref_n": int(cls_ref_count[c]),
            "agree_default": (cls_agree_hit["default"][c]
                              / max(cls_ref_count[c], 1)),
            "agree_devox": (cls_agree_hit["devox-parity"][c]
                            / max(cls_ref_count[c], 1)),
            "acc_default": (cls_acc_hit["default"][c]
                            / max(cls_lab_count[c], 1)),
            "acc_full": (cls_acc_hit["full-parity"][c]
                         / max(cls_lab_count[c], 1)),
        })
    return {"trained": step is not None, "frames": done,
            "batch_size": batch_size, "rows": rows,
            "acc_full": (fm, fci), "per_class": per_class,
            "agree_frames": agree, "acc_frames": acc,
            "launches": launches, "batches": batches,
            "host_s": host_s, "device_s": device_s}


def section(label, r):
    """The markdown section of one checkpoint's result."""
    lines = [
        f"## {label}",
        "",
        f"- params: {'TRAINED' if r['trained'] else 'random init'}; "
        f"N = {r['frames']} frames (batch size {r['batch_size']}), "
        f"per-frame statistics, CI = 1.96·σ/√N",
        "",
        "| variant | pred agreement vs full-parity (mean ± CI) | worst "
        "frame | point acc (mean ± CI) |",
        "|---|---|---|---|",
    ]
    for row in r["rows"]:
        lines.append(
            f"| {row['variant']} | {row['agree_mean']:.4f} ± "
            f"{row['agree_ci']:.4f} | {row['agree_min']:.4f} | "
            f"{row['acc_mean']:.4f} ± {row['acc_ci']:.4f} |")
    fm, fci = r["acc_full"]
    lines += [
        f"| full-parity | 1.0 (reference point) | — | {fm:.4f} ± "
        f"{fci:.4f} |",
        "",
        "Per-class (aggregated over all valid points of all frames; "
        "`agree` = fraction of full-parity predictions of that class "
        "the variant reproduces):",
        "",
        "| class | full-parity preds | agree default | agree "
        "devox-parity | acc default | acc full-parity |",
        "|---|---|---|---|---|---|",
    ]
    for pc in r["per_class"]:
        lines.append(
            f"| {pc['cls']} | {pc['ref_n']} | {pc['agree_default']:.4f} "
            f"| {pc['agree_devox']:.4f} | {pc['acc_default']:.4f} | "
            f"{pc['acc_full']:.4f} |")
    return lines


def conclusion(results):
    """What the train-mode × eval-mode table of [(label, result)] shows,
    computed from it, as lines: each checkpoint's best eval modes, how far
    the other columns lie below (in accuracy points, beside their 95%
    half-widths), whether that cell leads its column too, whether the
    diagonal dominates (each checkpoint's best cell leads its column, in a
    column of its own), and devox-parity's agreement with full-parity.
    (The JAX script states a fixed conclusion, drawn from its own run.)"""
    acc = {}
    for lbl, r in results:
        acc[lbl] = {row["variant"]: (row["acc_mean"], row["acc_ci"])
                    for row in r["rows"]}
        acc[lbl]["full-parity"] = tuple(r["acc_full"])
    lines, best, leads = ["**Measured (computed from the table above):**"
                          ], {}, {}
    for lbl, a in acc.items():
        best[lbl] = b = max(a, key=lambda v: a[v][0])
        leads[lbl] = all(a[b][0] >= other[b][0] for other in acc.values())
        below = ", ".join(f"{v} {100 * (a[b][0] - m):.2f} (± {100 * ci:.2f})"
                          for v, (m, ci) in a.items() if v != b)
        lines.append(f"- {lbl}: best under {b} ({a[b][0]:.4f}); below it "
                     f"by {below} points; "
                     + ("leads" if leads[lbl] else "does not lead")
                     + " its column.")
    dominates = (len(set(best.values())) == len(best)
                 and all(leads.values()))
    agree = [row["agree_mean"] for _, r in results for row in r["rows"]
             if row["variant"] == "devox-parity"]
    lines += [f"- The diagonal dominates its rows and columns: "
              f"{'yes' if dominates else 'no'}.",
              f"- devox-parity reproduces {100 * min(agree):.2f}% to "
              f"{100 * max(agree):.2f}% of full-parity's predictions.", ""]
    return lines


def report(results):
    """The whole markdown report of [(label, result)], as lines: the JAX
    script's, with :func:`conclusion` in place of its fixed one."""
    lines = [
        "# Strict-parity A/B — reference-parity modes vs fast defaults",
        "",
        "Same params, full pipeline (voxelize → PTv3 → head → "
        "devoxelize). Reference point: `full-parity` = "
        "`intensity_mode=knn5` (sklearn 5-NN semantics, "
        "utils/lidar.py:97-105) + `devoxelize_mode=nearest` "
        "(cdist-argmin semantics, utils/lidar.py:147-155).",
        "",
    ]
    if len(results) > 1:
        # train-mode x eval-mode accuracy matrix: each checkpoint
        # evaluated under every variant's modes
        lines += [
            "## Train-mode × eval-mode point accuracy",
            "",
            "| checkpoint \\ eval modes | default (mean+own) | "
            "devox-parity (mean+nearest) | full-parity (knn5+nearest) |",
            "|---|---|---|---|",
        ]
        for lbl, r in results:
            by = {row["variant"]: row for row in r["rows"]}
            fm, fci = r["acc_full"]
            lines.append(
                f"| {lbl} | {by['default']['acc_mean']:.4f} ± "
                f"{by['default']['acc_ci']:.4f} | "
                f"{by['devox-parity']['acc_mean']:.4f} ± "
                f"{by['devox-parity']['acc_ci']:.4f} | "
                f"{fm:.4f} ± {fci:.4f} |")
        lines += [""] + conclusion(results)
    for lbl, r in results:
        lines += section(lbl, r) + [""]
    lines += [
        "Per-component parity of the knn5/nearest modes themselves is "
        "oracle-tested in tests/test_voxel.py; the tables above bound "
        "the end-to-end effect of running the fast defaults instead.",
    ]
    return lines


def checkpoints(given):
    """``--checkpoint`` values → [(label, directory or None)]."""
    out = []
    for c in (given or [None]):
        if c and "=" in c:
            out.append(tuple(c.split("=", 1)))
        else:
            out.append(("trained" if c else "random init", c))
    return out


def default_out(config_path, ckpts):
    """``parity_ab.md`` in the first checkpoint directory, else in the
    config's ``checkpoint_path``."""
    first = next((path for _, path in ckpts if path), None)
    if first is None:
        from tpu3dssf_torch.cli.common import load_config
        first = load_config(config_path).checkpoint_path
    return os.path.join(first, REPORT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="configs/synthetic_convergence_lidar.yaml")
    ap.add_argument("--checkpoint", action="append", default=None,
                    help="directory of port checkpoints with trained "
                         "params; repeatable as LABEL=DIR to compare "
                         "checkpoints trained under different modes")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help=f"report path (default: {REPORT} in the first "
                         "checkpoint directory, else in the config's "
                         "checkpoint_path)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    ckpts = checkpoints(args.checkpoint)
    out = args.out or default_out(args.config, ckpts)
    results = [(lbl, run(args.config, path, args.frames, args.batch_size,
                         args.device))
               for lbl, path in ckpts]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(report(results)) + "\n")
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
