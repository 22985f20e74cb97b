"""The configurations' two segmentation models in plain float32 PyTorch,
and their loss and confusion counts.

* The fusion model: voxelize → PTv3 → per voxel, the patch token of every
  camera that sees its centroid (pinhole projection of the 900x1600 raw
  image, rescaled to the encoder's input, floored to its patch),
  averaged over those cameras, concatenated to the PTv3 feature, an MLP
  (448→256→64→16 at ViT-S/16) with ReLU → devoxelize.
* The LiDAR-only model: voxelize → PTv3 → a dense head (64→16) →
  devoxelize.
* The loss: class-weighted cross-entropy plus λ·Lovász-Softmax over the
  points whose label is not 0 (the ignore class) and whose mask is set;
  predictions argmax + 1.

Widths come from :mod:`benchmark.reference.widths`. Parameter names are
the program's, so one state dict loads into both.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.nn import Dense
from benchmark.reference.ptv3 import PTv3
from benchmark.reference.voxel import devoxelize, voxelize

RAW_HW = (900, 1600)


def project(xyz, K, Rt, raw_hw=RAW_HW):
    """(B, V, 3) LiDAR points into (B, N_cam) cameras: pixel (u, v) and
    validity, each (B, N_cam, V, ...), products elementwise in f32."""
    R = Rt[..., :3, :3]
    cam = (R[..., None, :, :] * xyz[:, None, :, None, :]).sum(-1) \
        + Rt[..., None, :3, 3]
    pix = (K[..., None, :, :] * cam[..., None, :]).sum(-1)
    denom = pix[..., 2].clamp_min(1e-12)
    u, v = pix[..., 0] / denom, pix[..., 1] / denom
    valid = ((cam[..., 2] > 0) & (u >= 0) & (u < raw_hw[1]) & (v >= 0)
             & (v < raw_hw[0]))
    return u, v, valid


def fused_image_features(tokens, xyz, K, Rt, patch, enc_hw):
    """(B, V, D): the mean, over the cameras that see each point, of the
    token of the patch it falls in (0 where no camera does)."""
    gh, gw = enc_hw[0] // patch, enc_hw[1] // patch
    u, v, valid = project(xyz, K, Rt)
    scale = torch.tensor([enc_hw[1] / RAW_HW[1], enc_hw[0] / RAW_HW[0]],
                         device=xyz.device)
    u, v = u * scale[0], v * scale[1]
    u = torch.where(valid, u, -1.0)
    v = torch.where(valid, v, -1.0)
    col = torch.floor(u / patch).long().clamp(0, gw - 1)
    row = torch.floor(v / patch).long().clamp(0, gh - 1)
    idx = (row * gw + col).clamp(0, gh * gw - 1)          # (B, N_cam, V)
    D = tokens.shape[-1]
    g = torch.gather(tokens.float(), 2, idx[..., None].expand(-1, -1, -1, D))
    w = valid[..., None].float()
    return (g * w).sum(1) / w.sum(1).clamp_min(1.0)


class FusionHead(nn.Module):
    """ReLU MLP over ``dims``' widths, the last the classes."""

    def __init__(self, dims):
        super().__init__()
        for i in range(len(dims) - 2):
            self.add_module(f"mlp{i}", Dense(dims[i], dims[i + 1]))
        self.mlp_out = Dense(dims[-2], dims[-1])
        self.depth = len(dims) - 2

    def forward(self, x):
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"mlp{i}")(x))
        return self.mlp_out(x)


class Segmentation(nn.Module):
    """Either model, at the widths of ``widths`` (a
    :class:`benchmark.reference.widths.Widths`): its encoder selects the
    camera branch."""

    def __init__(self, widths, voxel_size, voxel_capacity, intensity_mode,
                 devoxelize_mode):
        super().__init__()
        self.ptv3 = PTv3(widths.ptv3)
        self.vit_cfg = widths.vit
        if widths.fusion:
            self.fusion = FusionHead(widths.head)
        else:
            self.head = Dense(*widths.head)
        self.voxel_size, self.capacity = voxel_size, voxel_capacity
        self.intensity_mode = intensity_mode
        self.devoxelize_mode = devoxelize_mode

    def forward(self, points, point_mask, tokens=None, K=None, Rt=None):
        vox = voxelize(points, point_mask, self.voxel_size, self.capacity,
                       self.intensity_mode)
        feats = self.ptv3(vox.raw, vox.coords, vox.mask)
        if self.vit_cfg is not None:
            img = fused_image_features(tokens, vox.raw[..., :3], K, Rt,
                                       patch=self.vit_cfg.patch_size,
                                       enc_hw=self.vit_cfg.image_size)
            scores = self.fusion(torch.cat([feats, img], -1))
        else:
            scores = self.head(feats)
        scores = scores * vox.mask[..., None]
        return devoxelize(self.devoxelize_mode, vox, points, point_mask,
                          scores)


def lovasz_softmax(probs, labels0, valid):
    """Lovász-Softmax (Berman et al., 2018) over flattened points, the mean
    over the classes present."""
    N, C = probs.shape
    losses, present = [], []
    for c in range(C):
        fg = (valid & (labels0 == c)).float()
        err = torch.where(valid, (fg - probs[:, c]).abs(), 0.0)
        err_s, order = torch.sort(err, descending=True, stable=True)
        fg_s = fg[order]
        gts = fg_s.sum()
        inter = gts - torch.cumsum(fg_s, 0)
        union = gts + torch.arange(1, N + 1, device=probs.device) \
            - torch.cumsum(fg_s, 0)
        jac = 1.0 - inter / union.clamp_min(1e-12)
        grad = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append((err_s * grad).sum())
        present.append(gts > 0)
    losses, present = torch.stack(losses), torch.stack(present).float()
    return (losses * present).sum() / present.sum().clamp_min(1.0)


def loss_and_counts(logits, labels, mask, class_weights, lambda_lovasz,
                    classes=16):
    """(loss, valid points, (C, C) confusion) of one batch: labels in
    [0, C], 0 ignored."""
    logits = logits.float()
    labels = labels.long()
    valid = (labels != 0) & mask
    labels0 = (labels - 1).clamp(0, classes - 1)
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, labels0[..., None])[..., 0]
    w = torch.as_tensor(class_weights, device=logits.device)[labels0]
    w = w * valid.float()
    ce = (w * nll).sum() / w.sum().clamp_min(1e-12)
    lov = lovasz_softmax(torch.softmax(logits, -1).reshape(-1, classes),
                         labels0.reshape(-1), valid.reshape(-1))
    preds = logits.argmax(-1)
    cm = torch.zeros(classes * classes, dtype=torch.int64,
                     device=logits.device)
    cm.index_add_(0, (classes * labels0 + preds)[valid],
                  torch.ones_like(preds[valid]))
    return ce + lambda_lovasz * lov, int(valid.sum()), cm.reshape(
        classes, classes)
