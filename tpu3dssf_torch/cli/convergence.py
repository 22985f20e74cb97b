"""Convergence of the LiDAR-only model on one GPU, beside the TPU's records.

    python -m tpu3dssf_torch.cli.convergence --out DIR [--nearest-only]
        [--device cuda]

Trains both LiDAR-only convergence configs uncut
(``configs/synthetic_convergence_lidar_parity.yaml``, knn5/nearest, and
``configs/synthetic_convergence_lidar.yaml``, mean/own) at each init seed,
each on a copy of its config whose checkpoint paths point into a
temporary directory (the stock ones are the committed TPU records, which
must not change: ``common.config_copy``). Every run is
``main_train.main`` itself, the CLI's seed (1) as the CLI runs it and the
other through its ``seed`` argument. Then, per seed, the port's ``parity_ab``
on that seed's two best checkpoints (64 frames at batch 2, as the TPU's
``PARITY_AB.md``), and one graphed train step of each config profiled.

``--nearest-only`` counts instead, over the same 64 frames, the points
whose nearest voxel centroid is their own voxel's
(:func:`nearest_is_own`), with f32 distances and with a bf16 dot.

Writes into ``--out``: each run's ``training_history.json`` and log, each
seed's ``parity_ab`` report, and ``convergence.json``: per config the
port's curves (train loss, val acc, val mIoU per epoch) beside the TPU's
(``checkpoints/synthetic/<name>/training_history.json``), the seed spread,
the first epoch where the port's mean parts from the TPU's curve by more
than that spread, the best val acc and last-epoch mIoU against the TPU's
(``LIMIT``), each run's wall time, ms per step and peak memory; the
parity_ab tables; and the train steps' profiles (wall and device ms per
step, launches per replay, device time by kernel group). Every number
stands beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# name: (config, the TPU's record of its 30 epochs, parity_ab label)
CONFIGS = {
    "lidar_parity": ("configs/synthetic_convergence_lidar_parity.yaml",
                     "checkpoints/synthetic/convergence_lidar_parity",
                     "parity-trained (knn5+nearest)"),
    "lidar": ("configs/synthetic_convergence_lidar.yaml",
              "checkpoints/synthetic/convergence_lidar",
              "default-trained (mean+own)"),
}
CLI_SEED = 1          # main_train.main's default seed
SEEDS = (CLI_SEED, 2)
FRAMES, BATCH = 64, 2  # parity_ab's stream, as the TPU's PARITY_AB.md
LIMIT = 0.02          # |port − TPU| of best val acc and last-epoch mIoU
CURVES = ("train_loss", "overall_acc", "mean_iou")
# device kernels of a train step by group (first match wins)
GROUPS = (
    ("K2/K4 attention forward (LSE)", r"fap_fwd_d16_\w+<(\d+, ?)?true>"),
    ("K3/K5 attention backward", r"fap_bwd_d16_"),
    ("K7 k-NN", r"knn_(pack|kernel|merge)"),
    ("matmul (cuBLAS)", r"gemm|nvjet|xmma|cutlass|Kernel2"),
    ("optimizer + clip (multi_tensor_apply)", r"multi_tensor_apply"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("sort", r"[Ss]ort|radix"),
    ("index, gather, scatter", r"index|gather|scatter"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def tpu_history(record_dir):
    """The TPU's per-epoch record (the committed training_history.json)."""
    with open(os.path.join(ROOT, record_dir, "training_history.json")) as f:
        return json.load(f)


def curves(history):
    """{curve: [value per epoch]} of a training_history.json dict."""
    return {k: [float(e[k]) for e in history["epochs"]] for k in CURVES}


def first_parting(port, tpu):
    """The first epoch where the port's seed mean differs from the TPU's
    value by more than the port's seed spread (max − min over the seeds),
    or None. ``port``: [[value per epoch] per seed]; ``tpu``: [value per
    epoch]."""
    for e in range(min(len(tpu), *map(len, port))):
        vals = [p[e] for p in port]
        spread = max(vals) - min(vals)
        if abs(statistics.fmean(vals) - tpu[e]) > spread:
            return e
    return None


def compare(runs, tpu):
    """The port's runs ({seed: history}) of one config against the TPU's
    record: per-epoch curves, seed spread, first parting, best val acc and
    last mIoU with their differences to the TPU's."""
    seeds = sorted(runs)
    port = {s: curves(runs[s]) for s in seeds}
    ref = curves(tpu)
    out = {"tpu": ref, "port": port, "first_parting": {}, "seed_spread": {}}
    for k in CURVES:
        per_seed = [port[s][k] for s in seeds]
        n = min(map(len, per_seed))
        out["seed_spread"][k] = [max(p[e] for p in per_seed)
                                 - min(p[e] for p in per_seed)
                                 for e in range(n)]
        out["first_parting"][k] = (first_parting(per_seed, ref[k])
                                   if len(seeds) > 1 else None)
    out["best_val_acc"] = {s: float(runs[s]["best_val_acc"]) for s in seeds}
    out["last_miou"] = {s: port[s]["mean_iou"][-1] for s in seeds}
    out["tpu_best_val_acc"] = float(tpu["best_val_acc"])
    out["tpu_last_miou"] = ref["mean_iou"][-1]
    out["within_limit"] = {
        s: abs(out["best_val_acc"][s] - out["tpu_best_val_acc"]) <= LIMIT
        and abs(out["last_miou"][s] - out["tpu_last_miou"]) <= LIMIT
        for s in seeds}
    return out


class _Tee:
    """Write to a log file and keep the lines that match ``keep``."""

    def __init__(self, f, keep):
        self.f, self.keep, self.kept, self._line = f, keep, [], ""

    def write(self, s):
        self.f.write(s)
        self._line += s
        *lines, self._line = self._line.split("\n")
        self.kept += [x for x in lines if re.search(self.keep, x)]
        return len(s)

    def flush(self):
        self.f.flush()


def train_run(name, seed, work, out, device):
    """One training run of config ``name`` at ``seed`` on a config copy;
    its log and training_history.json go to ``out``. Returns its record."""
    from tpu3dssf_torch.cli import common, main_train

    src, _, _ = CONFIGS[name]
    tag = f"{name}_s{seed}"
    path, ckpt = common.config_copy(os.path.join(ROOT, src),
                                    os.path.join(work, tag), "config.yaml")
    log = os.path.join(out, f"{tag}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        tee = _Tee(f, r"ms/step\)|Best val Acc|\[graph\]")
        with contextlib.redirect_stdout(tee):
            state = main_train.main(["--config", path,
                                     "--device", str(device)], seed=seed)[0]
    wall = time.perf_counter() - t0
    del state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with open(os.path.join(ckpt, "training_history.json")) as f:
        history = json.load(f)
    shutil.copy(os.path.join(ckpt, "training_history.json"),
                os.path.join(out, f"{tag}_training_history.json"))
    # the CLI's window lines: mean host ms per step over an epoch's first
    # 10 steps (batch wait included); epoch 0 also captures the graphs
    ms = [float(m.group(1)) for m in (re.search(r"\((\d+) ms/step\)", x)
                                      for x in tee.kept) if m]
    record = dict(config=src, seed=seed, wall_s=wall, epochs=len(history["epochs"]),
                  window_ms_per_step=ms,
                  ms_per_step_after_epoch0=(statistics.median(ms[1:])
                                            if len(ms) > 1 else None),
                  peak_mib=history["epochs"][-1]["peak_hbm_mb"],
                  best_val_acc=history["best_val_acc"], ckpt=ckpt)
    print(f"trained {tag}: {record['epochs']} epochs in "
          f"{wall:.1f} s, best val acc {history['best_val_acc']:.4f}, last "
          f"mIoU {history['epochs'][-1]['mean_iou']:.4f}, CLI ms/step "
          f"{ms}, peak {record['peak_mib']:,.0f} MiB", flush=True)
    return record, history


def group_kernels(kernels):
    """{group: [device ms, kernels]} of a profiler table
    ({name: (µs, count)})."""
    out = {}
    for name, (us, n) in kernels.items():
        group = next((g for g, pat in GROUPS if re.search(pat, name)),
                     "other")
        ms, c = out.get(group, (0.0, 0))
        out[group] = (ms + us / 1e3, c + n)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def profile_train_step(name, work, device):
    """One train step of config ``name`` as main_train runs it (graphed):
    wall ms per step (CUDA events, 10 after 3) graphed and eager, device
    ms and kernels per step from the profiler, by group, the launches per
    replay."""
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.kernels.modules import launch_counts
    from tpu3dssf_torch.train.graph import graph_train_step
    from tpu3dssf_torch.train.loop import make_train_step
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

    path, _ = common.config_copy(os.path.join(ROOT, CONFIGS[name][0]),
                                 os.path.join(work, f"{name}_profile"),
                                 "config.yaml")
    cfg = common.load_config(path)
    model, _ = common.build_pipeline(cfg, None, device)
    loaders = common.build_dataloaders(cfg)
    state = common.init_state(cfg, model, len(loaders["train"]))
    step = make_train_step(common.build_loss(cfg))
    g_step = graph_train_step(step)
    batches = iter(loaders["train"])
    host = next(batches)
    batches.close()
    host.pop("images", None)
    points = int(host["point_valid"].sum())
    batch = common.batch_to_device(host, device)
    tokens = common.zero_tokens(cfg, None, batch["points"].shape[0], device)

    def graphed():
        return g_step(state, batch, tokens)

    def eager():
        return step(state, batch, tokens)

    graphed()                               # eager call + capture
    before = launch_counts()
    graphed()
    torch.cuda.synchronize()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] - before[k]}
    torch.cuda.reset_peak_memory_stats()
    wall = {"graphed": cuda_ms(graphed, reps=10, warmup=3),
            "eager": cuda_ms(eager, reps=10, warmup=3)}
    wall["graphed_2"] = cuda_ms(graphed, reps=10, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    _, kernels, _ = profile_kernels(graphed, reps=3)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    row = dict(config=CONFIGS[name][0], points=points, wall_ms=wall,
               device_ms=device_ms,
               kernels=sum(c for _, c in kernels.values()),
               wall_over_device=wall["graphed"] / device_ms,
               launches_per_replay=launches, peak_bytes=peak,
               groups=group_kernels(kernels),
               top=[(k[:100], us / 1e3, c) for k, (us, c) in top])
    print(f"train step {name}: graphed {wall['graphed']:.3f} / "
          f"{wall['graphed_2']:.3f} ms, eager {wall['eager']:.3f} ms, device "
          f"{device_ms:.3f} ms in {row['kernels']:g} kernels (wall/device "
          f"{row['wall_over_device']:.3f}); launches per replay {launches}; "
          f"groups {json.dumps(row['groups'])}", flush=True)
    del state, model, g_step
    torch.cuda.empty_cache()
    return row


def nearest_is_own(config_path, frames, batch_size, device):
    """Over ``parity_ab``'s stream of ``frames`` frames: the share of valid
    points whose nearest voxel centroid is their own voxel's (what
    ``devoxelize_mode`` nearest and own disagree on), with the distances
    of the port's k-NN (K7 on the card: f32, bit-identical to its plain
    version) and with the q·r term of |q|² − 2 q·r + |r|² taken from
    inputs rounded to bf16 and summed in f32 (one pass of a bf16 matrix
    unit; norms in f32), per frame."""
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.cli.parity_ab import frame_stream
    from tpu3dssf_torch.kernels import knn
    from tpu3dssf_torch.models.ptv3 import _round_up
    from tpu3dssf_torch.voxel import voxelize
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference

    cfg = common.load_config(config_path)
    cap = _round_up(cfg.tpu.voxel_capacity, cfg.tpu.window_size)
    out = {"f32": [], "bf16_dot": []}
    it = iter(frame_stream(cfg, None, frames, batch_size))
    for host in it:
        b = common.batch_to_device(
            {k: host[k] for k in ("points", "point_valid")}, device)
        pts, mask = b["points"], b["point_valid"]
        vox = voxelize(pts, mask, cfg.voxel_size, cap, intensity_mode="none")
        q = pts[..., :3].contiguous()
        r = vox.voxel_raw[..., :3].contiguous()
        search = knn.knn if q.is_cuda else topk_neighbors_reference
        nearest = search(q, r, vox.voxel_mask, 1)[1][..., 0]
        ok = vox.point_ok & mask
        for i in range(q.shape[0]):
            if len(out["f32"]) == frames:
                break
            rn = (r[i] * r[i]).sum(-1)
            best = []
            for s in range(0, q.shape[1], 4096):
                qs = q[i, s:s + 4096]
                d = ((qs * qs).sum(-1, keepdim=True) - 2 * (
                    qs.bfloat16().float() @ r[i].bfloat16().float().T)
                    + rn[None])
                best.append(torch.where(vox.voxel_mask[i][None], d,
                                        float("inf")).argmin(-1))
            for key, idx in (("f32", nearest[i]),
                             ("bf16_dot", torch.cat(best))):
                same = (idx == vox.point_voxel[i])[ok[i]]
                out[key].append(float(same.float().mean()))
    it.close()
    print("nearest centroid == own voxel, per frame: " + json.dumps(out),
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--nearest-only", action="store_true",
                    help="only count the points whose nearest centroid is "
                         "their own voxel's (nearest_is_own)")
    args = ap.parse_args(argv)

    from tpu3dssf_torch.cli import common, parity_ab

    device = common.resolve_device(args.device)
    card = common.card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.nearest_only:
        counts = dict(card=card, nearest_is_own=nearest_is_own(
            os.path.join(ROOT, CONFIGS["lidar"][0]), FRAMES, BATCH, device))
        with open(os.path.join(args.out, "nearest_is_own.json"), "w") as f:
            json.dump(counts, f, indent=1)
        return counts
    if device.type == "cuda":
        from concurrent.futures import ThreadPoolExecutor
        from tpu3dssf_torch.kernels import _build
        sources = ("flash_attention_packed.cu",
                   "flash_attention_packed_bwd.cu", "knn.cu")
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            list(pool.map(_build.load_library, sources))
    work = tempfile.mkdtemp(prefix="tpu3dssf_convergence_")
    summary = dict(card=card, runs={}, compare={}, parity_ab={},
                   train_step={})
    try:
        ckpts = {}
        for name, (_, record_dir, _) in CONFIGS.items():
            hists = {}
            for seed in SEEDS:
                rec, hists[seed] = train_run(name, seed, work, args.out,
                                             device)
                summary["runs"][f"{name}_s{seed}"] = rec
                ckpts[(name, seed)] = rec["ckpt"]
            summary["compare"][name] = compare(hists,
                                               tpu_history(record_dir))
        for seed in SEEDS:
            out = os.path.join(args.out, f"parity_ab_s{seed}.md")
            argv = ["--config", common.config_copy(
                os.path.join(ROOT, CONFIGS["lidar"][0]),
                os.path.join(work, "parity_ab"), "config.yaml")[0],
                "--frames", str(FRAMES),
                "--batch-size", str(BATCH), "--out", out,
                "--device", str(device)]
            for name in ("lidar", "lidar_parity"):
                argv += ["--checkpoint",
                         f"{CONFIGS[name][2]}={ckpts[(name, seed)]}"]
            t0 = time.perf_counter()
            results = parity_ab.main(argv)
            summary["parity_ab"][seed] = dict(
                wall_s=time.perf_counter() - t0, report=out, results=[
                    dict(label=lbl, rows=r["rows"], acc_full=r["acc_full"],
                         frames=r["frames"], launches=r["launches"],
                         batches=r["batches"], host_s=r["host_s"],
                         device_s=r["device_s"]) for lbl, r in results])
            print(f"parity_ab seed {seed}: " + "; ".join(
                f"{lbl}: " + ", ".join(
                    f"{row['variant']} acc {row['acc_mean']:.4f} agree "
                    f"{row['agree_mean']:.4f}" for row in r["rows"])
                + f", full-parity acc {r['acc_full'][0]:.4f}"
                for lbl, r in results), flush=True)
        if device.type == "cuda":
            for name in CONFIGS:
                summary["train_step"][name] = profile_train_step(
                    name, work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for run in summary["runs"].values():
        run.pop("ckpt")
    with open(os.path.join(args.out, "convergence.json"), "w") as f:
        json.dump(summary, f, indent=1, default=float)
    for name, cmp in summary["compare"].items():
        print(f"{name}: best val acc {cmp['best_val_acc']} (TPU "
              f"{cmp['tpu_best_val_acc']:.4f}), last mIoU "
              f"{cmp['last_miou']} (TPU {cmp['tpu_last_miou']:.4f}), "
              f"within {LIMIT}: {cmp['within_limit']}, first parting "
              f"{cmp['first_parting']} [{card}]")
    return summary


if __name__ == "__main__":
    main()
