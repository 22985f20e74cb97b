"""Building blocks shared by the port's models, with flax's semantics.

* :class:`Dense` — ``flax.linen.Dense(dtype=...)``: float32 master weights,
  the product computed in the module's compute dtype.
* :class:`LayerNorm` — ``flax.linen.LayerNorm``: statistics and the affine
  map in float32, the result cast to the compute dtype; epsilon defaults
  to flax's 1e-6 (PyTorch's default is 1e-5). One kernel on a card
  (:func:`tpu3dssf_torch.kernels.layer_norm.layer_norm`).
* :func:`init_weights` — a seeded random init that mirrors flax's
  initializers (lecun-normal kernels, zero biases, unit LayerNorm scales),
  drawn from one ``torch.Generator`` in module registration order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu3dssf_torch.kernels.layer_norm import layer_norm

# std of a standard normal truncated to [-2, 2]; flax divides by it
_TRUNC_STD = 0.87962566103423978


def trunc_normal(shape, std, generator):
    """N(0, 1) truncated to [-2, 2], times ``std`` (inverse-CDF sampling)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (1.0 - 2.0 * lo) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x.clamp(-2.0, 2.0) * std).to(torch.float32)


def lecun_normal(shape, fan_in, generator):
    """flax ``lecun_normal``: truncated normal of variance 1/fan_in."""
    return trunc_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                        generator)


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters, run in ``dtype``."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if generator is None:  # nn.Linear's constructor calls this
            return super().reset_parameters()
        self.weight.copy_(lecun_normal(
            (self.out_features, self.in_features), self.in_features,
            generator))
        self.bias.zero_()


class LayerNorm(nn.Module):
    """flax LayerNorm: f32 statistics, output in ``dtype``.

    The rows go to the op ``tpu3dssf::layer_norm`` in the input's dtype
    where that is ``dtype`` (the kernel rounds once, to it), else in f32
    with the result cast to ``dtype``; on the CPU this is
    ``F.layer_norm(x.float(), ...).to(dtype)`` bit for bit."""

    def __init__(self, features, eps=1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if x.dtype != self.dtype:
            x = x.float()
        y = layer_norm(x.reshape(-1, x.shape[-1]).contiguous(),
                       self.weight.float(), self.bias.float(), self.eps)
        return y.reshape(x.shape).to(self.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded flax-style init: every submodule's
    ``reset_parameters(generator)``, in registration order, from one
    generator. Each module resets only its own parameters. Returns
    ``model``."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return model
