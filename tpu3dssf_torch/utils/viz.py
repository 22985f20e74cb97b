"""Result visualization — history curves, IoU bars, 3D cloud, overlays.

The port's own copy of ``tpu3dssf/utils/viz.py``
(host code: the port imports nothing of the JAX package).

Rebuilds reference utils/plot.py artifact-for-artifact:
  * ``plot_training_history`` → training_history.png (plot.py:13-30);
  * ``plot_iou_per_class`` → per_class_iou.png, sorted bars colored by
    value (plot.py:96-162);
  * ``plot_comparison_cloud`` → segmentation_result.html, GT-vs-pred 3D
    scatter (plot.py:42-93) — upstream uses plotly (absent in this
    image), so the HTML embeds a small self-contained canvas renderer;
  * ``plot_images_with_point_cloud`` → cam_{i}_prediction.png, per-camera
    GT/pred point overlays (plot.py:165-297), drawn with PIL instead of
    cv2.

The 19-color map mirrors plot.py:34-39's palette role (index = class id).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

# class-id → RGB (0: noise, 1..16 the nuScenes-lidarseg classes)
COLOR_MAP = np.array([
    (0, 0, 0), (112, 128, 144), (220, 20, 60), (255, 127, 80),
    (255, 158, 0), (233, 150, 70), (255, 61, 99), (0, 0, 230),
    (47, 79, 79), (255, 140, 0), (255, 99, 71), (0, 207, 191),
    (175, 0, 75), (75, 0, 75), (112, 180, 60), (222, 184, 135),
    (0, 175, 0), (30, 144, 255), (128, 0, 128),
], dtype=np.uint8)


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_history(train_acc: Sequence[float],
                          val_acc: Sequence[float],
                          save_dir: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "training_history.png")
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(range(len(train_acc)), [float(a) for a in train_acc],
            label="train acc")
    ax.plot(range(len(val_acc)), [float(a) for a in val_acc],
            label="val acc")
    ax.set_xlabel("epoch")
    ax.set_ylabel("overall accuracy")
    ax.set_title("Training history")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    # merge into (don't clobber) the richer per-epoch record train_model
    # writes to the same file
    jpath = os.path.join(save_dir, "training_history.json")
    record = {}
    if os.path.exists(jpath):
        try:
            with open(jpath) as f:
                record = json.load(f)
        except (OSError, ValueError):
            record = {}
    record.update({"train_acc": [float(a) for a in train_acc],
                   "val_acc": [float(a) for a in val_acc]})
    with open(jpath, "w") as f:
        json.dump(record, f, indent=1)
    return path


def plot_iou_per_class(iou_per_class: Sequence[float],
                       class_names: Optional[Dict[int, str]],
                       save_dir: str,
                       filename: str = "per_class_iou.png") -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename)
    iou = np.asarray([float(v) for v in iou_per_class])
    names = ([class_names.get(i + 1, f"class_{i + 1}")
              for i in range(len(iou))] if class_names
             else [f"class_{i + 1}" for i in range(len(iou))])
    order = np.argsort(iou)
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 6))
    colors = plt.cm.viridis(iou[order])
    ax.barh(np.arange(len(iou)), iou[order], color=colors)
    ax.set_yticks(np.arange(len(iou)))
    ax.set_yticklabels([names[i] for i in order])
    ax.set_xlabel("IoU")
    ax.set_xlim(0, 1)
    ax.set_title(f"Per-class IoU (mean {iou.mean():.4f})")
    for i, v in enumerate(iou[order]):
        ax.text(v + 0.01, i, f"{v:.3f}", va="center", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>3DSSF segmentation</title>
<style>body{margin:0;background:#111;color:#eee;font-family:sans-serif}
.row{display:flex}.panel{flex:1;text-align:center}</style></head>
<body><div class="row">
<div class="panel"><h3>Ground truth</h3><canvas id="gt" width="640" height="560"></canvas></div>
<div class="panel"><h3>Prediction</h3><canvas id="pr" width="640" height="560"></canvas></div>
</div>
<p style="text-align:center">drag to rotate &middot; wheel to zoom</p>
<script>
const pts = __POINTS__;  // [x,y,z]
const gtC = __GT_COLORS__, prC = __PR_COLORS__;
let yaw=0.7, pitch=0.5, zoom=7.0;
function draw(id, cols){
  const cv=document.getElementById(id), ctx=cv.getContext('2d');
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  for(let i=0;i<pts.length;i++){
    const p=pts[i];
    const x= p[0]*cy + p[1]*sy, y=-p[0]*sy + p[1]*cy, z=p[2];
    const yy= y*cp + z*sp, zz=-y*sp + z*cp;
    const s=zoom; const u=cv.width/2 + x*s, v=cv.height/2 - yy*s - zz*s*0.2;
    if(u<0||u>=cv.width||v<0||v>=cv.height) continue;
    ctx.fillStyle=cols[i]; ctx.fillRect(u,v,2,2);
  }
}
function redraw(){draw('gt',gtC);draw('pr',prC);}
let drag=false,lx=0,ly=0;
document.addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY});
document.addEventListener('mouseup',()=>drag=false);
document.addEventListener('mousemove',e=>{if(!drag)return;
  yaw+=(e.clientX-lx)*0.01; pitch+=(e.clientY-ly)*0.01; lx=e.clientX;ly=e.clientY; redraw();});
document.addEventListener('wheel',e=>{zoom*=e.deltaY<0?1.1:0.9; redraw();});
redraw();
</script></body></html>
"""


def plot_comparison_cloud(points, gt_labels, pred_labels, save_dir: str,
                          max_points: int = 40000,
                          filename: str = "segmentation_result.html") -> str:
    """GT-vs-pred interactive 3D scatter (self-contained HTML)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename)
    points = np.asarray(points)[:, :3]
    gt = np.asarray(gt_labels).astype(int)
    pr = np.asarray(pred_labels).astype(int)
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(
            len(points), max_points, replace=False)
        points, gt, pr = points[sel], gt[sel], pr[sel]

    def css(lab):
        c = COLOR_MAP[np.clip(lab, 0, len(COLOR_MAP) - 1)]
        return [f"rgb({r},{g},{b})" for r, g, b in c]

    html = (_HTML_TEMPLATE
            .replace("__POINTS__",
                     json.dumps(np.round(points, 2).tolist()))
            .replace("__GT_COLORS__", json.dumps(css(gt)))
            .replace("__PR_COLORS__", json.dumps(css(pr))))
    with open(path, "w") as f:
        f.write(html)
    return path


def plot_images_with_point_cloud(images, points, pred_labels, gt_labels,
                                 cam_intrinsics, lidar2cam,
                                 save_dir: str,
                                 raw_image_size=(900, 1600)) -> list:
    """Per-camera GT/pred overlay PNGs (reference plot.py:165-297).

    images: (n_cam, H, W, 3) uint8; points: (P, >=3); labels: (P,).
    """
    from PIL import Image
    from tpu3dssf_torch.geometry import multi_camera_projector

    os.makedirs(save_dir, exist_ok=True)
    images = np.asarray(images)
    points = np.asarray(points)[:, :3]
    pred = np.asarray(pred_labels).astype(int)
    gt = np.asarray(gt_labels).astype(int)

    pix, _, valid = multi_camera_projector(
        points, np.asarray(cam_intrinsics), np.asarray(lidar2cam),
        raw_image_size)
    pix, valid = np.asarray(pix), np.asarray(valid)

    n_cam, H, W = images.shape[0], images.shape[1], images.shape[2]
    sx, sy = W / raw_image_size[1], H / raw_image_size[0]
    paths = []
    for c in range(n_cam):
        canvas = np.concatenate([images[c], images[c]], axis=1).copy()
        ok = valid[c]
        u = (pix[c, ok, 0] * sx).astype(int).clip(0, W - 1)
        v = (pix[c, ok, 1] * sy).astype(int).clip(0, H - 1)
        canvas[v, u] = COLOR_MAP[np.clip(gt[ok], 0, 18)]
        canvas[v, u + W] = COLOR_MAP[np.clip(pred[ok], 0, 18)]
        path = os.path.join(save_dir, f"cam_{c}_prediction.png")
        Image.fromarray(canvas).save(path)
        paths.append(path)
    return paths
