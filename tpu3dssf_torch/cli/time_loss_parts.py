"""The CE + Lovász loss, piece by piece at train shapes, on the card: the
port of ``scripts/time_loss_parts.py``.

    python3 tpu3dssf_torch/cli/time_loss_parts.py [--out FILE]
    python -m tpu3dssf_torch.cli.time_loss_parts --device cpu --tiny

At B = 2, P = 34,816, C = 16 (N = B·P = 69,632 flattened points), labels
in [0, 16] and every point valid, each piece timed as a CUDA graph of
``--r`` repeats (:mod:`tpu3dssf_torch.cli.pieces`): the parts of
:func:`tpu3dssf_torch.losses.lovasz_softmax` — the softmax, the error
construction ((C, N) errors and foreground), the stable descending sort of
the errors, the foreground gather by its order, the cumsums and Jaccard
with its difference, and the gradient dot with the mean over present
classes — then the whole Lovász forward and forward + backward (gradient
of the probabilities), the weighted CE, and ``CELSLoss``'s total forward
and forward + backward (gradient of the logits). The parts, chained, are
the Lovász forward; the record holds their largest difference from it.

Not ported: the script's sort-formulation variants (``sort2``/``sort4``,
the bf16 key, the quantised key packed above its payload, the class
budget; ``:55-128``). They choose among XLA formulations of the JAX
loss's sort, whose default quantises the key to 13 bits; the port sorts
the exact f32 errors (``torch.sort(stable=True)``), so there is no
formulation to choose.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

B, P, C = 2, 34816, 16


def softmax(logits):
    """The (N, C) probabilities of (B, P, C) logits."""
    return torch.softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])


def errors(probs, labels0, valid):
    """(errors, fg), each (C, N): |fg − p| on valid points, 0 elsewhere."""
    classes = torch.arange(probs.shape[1], device=probs.device)[:, None]
    fg = (valid[None, :] & (labels0[None, :] == classes)).to(torch.float32)
    return torch.where(valid[None, :], (fg - probs.float().T).abs(), 0.0), fg


def sort_errors(err):
    """The stable descending sort of each class's errors: (sorted,
    order)."""
    return torch.sort(err, dim=1, descending=True, stable=True)


def fg_gather(fg, order):
    return torch.gather(fg, 1, order)


def jaccard(fg_s):
    """(gradient, gts): the Jaccard of each prefix and its difference."""
    n = fg_s.shape[1]
    gts = fg_s.sum(dim=1, keepdim=True)
    cfg = torch.cumsum(fg_s, dim=1)
    union = gts + torch.arange(1, n + 1, dtype=torch.float32,
                               device=fg_s.device)[None, :] - cfg
    jac = 1.0 - (gts - cfg) / union.clamp_min(1e-12)
    return torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1), gts


def gradient_dot(errors_s, grad, gts):
    """The loss: Σ errors · gradient per class, mean over present
    classes."""
    losses = (errors_s * grad).sum(dim=1)
    present = (gts[:, 0] > 0).to(torch.float32)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


def lovasz_parts(probs, labels0, valid):
    """The parts above chained: :func:`~tpu3dssf_torch.losses.
    lovasz_softmax`'s forward."""
    err, fg = errors(probs, labels0, valid)
    err_s, order = sort_errors(err)
    grad, gts = jaccard(fg_gather(fg, order))
    return gradient_dot(err_s, grad, gts)


def main(argv=None):
    from tpu3dssf_torch.cli.bench_train import loss_fn
    from tpu3dssf_torch.cli.pieces import Pieces, arguments, no_grad
    from tpu3dssf_torch.losses import lovasz_softmax, weighted_cross_entropy

    args = arguments(__doc__.splitlines()[0], r=10).parse_args(argv)
    p = Pieces("time_loss_parts", args)
    points = 300 if args.tiny else P
    rng = np.random.default_rng(0)
    logits = p.tensor(rng.normal(size=(B, points, C)), torch.float32)
    labels = p.tensor(rng.integers(0, 17, (B, points)).astype(np.int32))
    mask = torch.ones((B, points), dtype=torch.bool, device=p.device)
    with torch.no_grad():
        probs = softmax(logits)
        labels0 = (labels - 1).clamp(0, C - 1).reshape(-1)
        valid = ((labels != 0) & mask).reshape(-1)
        err, fg = errors(probs, labels0, valid)
        err_s, order = sort_errors(err)
        fg_s = fg_gather(fg, order)
        grad, gts = jaccard(fg_s)
        whole = lovasz_softmax(probs, labels0, valid)
        parts_err = (lovasz_parts(probs, labels0, valid)
                     - whole).abs().item()

    n = B * points
    info = dict(N=n, C=C)
    for name, fn, args_, kind in (
            ("softmax (N, C)", softmax, (logits,), "part"),
            ("errors construction ((N, C).T + abs)",
             lambda pr: errors(pr, labels0, valid), (probs,), "part"),
            ("stable descending sort (C, N)", sort_errors, (err,), "part"),
            ("fg gather (C, N)", fg_gather, (fg, order), "part"),
            ("cumsums + jaccard + diff (C, N)", jaccard, (fg_s,), "part"),
            ("gradient dot + present mean", gradient_dot,
             (err_s, grad, gts), "part"),
            ("lovasz_softmax fwd", lambda pr: lovasz_softmax(
                pr, labels0, valid), (probs,), "lovasz"),
            ("weighted CE fwd", lambda lg: weighted_cross_entropy(
                lg, (labels - 1).clamp(0, C - 1), (labels != 0) & mask),
             (logits,), "ce")):
        p.time(name, no_grad(fn), *args_, kind=kind, **info)

    def lovasz_fb(pr):
        q = pr.detach().requires_grad_(True)
        value = lovasz_softmax(q, labels0, valid)
        return value, torch.autograd.grad(value, q)

    p.time("lovasz fwd+bwd", lovasz_fb, probs, kind="lovasz_fwd_bwd", **info)
    loss = loss_fn()
    p.time("CELSLoss total fwd", no_grad(
        lambda lg: loss(lg, labels, mask).total), logits, kind="total",
        **info)

    def total_fb(lg):
        q = lg.detach().requires_grad_(True)
        value = loss(q, labels, mask).total
        return value, torch.autograd.grad(value, q)

    p.time("CELSLoss total fwd+bwd", total_fb, logits,
           kind="total_fwd_bwd", **info)
    parts = p.weighted(lambda r: r.get("kind") == "part")
    lovasz = p.value("lovasz_softmax fwd")
    print(f"sum of the Lovász parts {parts:.3f} ms vs its forward "
          f"{lovasz:.3f} ms; parts chained vs lovasz_softmax: "
          f"|difference| {parts_err:.3g}", flush=True)
    return p.record(config=dict(batch=B, points=points, classes=C),
                    sums=dict(lovasz_parts=parts, lovasz_fwd=lovasz,
                              remainder=lovasz - parts,
                              parts_vs_whole_abs_diff=parts_err))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
