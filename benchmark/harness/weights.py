"""Seeded random weights, made on the card in one call a model.

One flat normal draw from a ``torch.Generator`` on ``device`` is cut into
the model's parameters by name, in float32: a matrix (a dense kernel) at
std 1/sqrt(fan-in), the depthwise kernel-3 taps at 1/sqrt(3), the CLS and
register tokens at 0.02, LayerNorm scales at 1 + 0.02·n and every other
vector (biases, LayerNorm shifts) at 0.02·n. LayerScale gammas are 1, not
DINO's 1e-5 init, so that every ViT block reaches the patch tokens and the
check sees it. The same dict loads into the program's modules and into the
reference's, whose parameter names are the program's.
"""

from __future__ import annotations

import math

import torch

_SMALL = 0.02


def _rule(name, shape, owner):
    """(std, mean) of one parameter."""
    kind = type(owner).__name__
    if kind == "LayerScale":
        return 0.0, 1.0
    if "Norm" in kind:
        return _SMALL, (1.0 if name.endswith("weight") else 0.0)
    if name.endswith("depthwise.kernel"):
        return 1.0 / math.sqrt(3.0), 0.0
    if name.endswith("_token") or name.endswith("_tokens"):
        return _SMALL, 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    return _SMALL, 0.0


def make_weights(model: torch.nn.Module, seed: int, device):
    """{name: float32 tensor on ``device``} for every parameter of
    ``model`` (its structure only is read: it may live on the meta
    device)."""
    owners = dict(model.named_modules())
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, p in params:
        owner = owners[name.rpartition(".")[0]]
        std, mean = _rule(name, tuple(p.shape), owner)
        out[name] = (flat[at:at + p.numel()].view(p.shape) * std + mean)
        at += p.numel()
    return out


def load(model: torch.nn.Module, weights: dict):
    """Copy ``weights`` into ``model``'s parameters (the names and shapes
    must match exactly), each cast to the parameter's dtype and device."""
    state = dict(model.named_parameters())
    if set(state) != set(weights):
        raise KeyError("the weights do not name this model's parameters: "
                       f"{sorted(set(state) ^ set(weights))[:6]}")
    bad = [(n, tuple(weights[n].shape), tuple(p.shape))
           for n, p in state.items() if weights[n].shape != p.shape]
    if bad:
        raise ValueError("the weights' widths are not this model's "
                         f"(name, drawn, model): {bad[:6]}")
    with torch.no_grad():
        for name, p in state.items():
            p.copy_(weights[name])
    return model
