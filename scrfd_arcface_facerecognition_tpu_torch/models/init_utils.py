"""Seeded initialization, the same distributions as the JAX package's
``cpu_init``: identity BatchNorm (scale 1, bias 0, mean 0, var 1), unit
GroupNorm, PReLU slope 0.25, per-level head scales 1, zero biases, and
He fan-out normal conv/dense kernels (std sqrt(2 / (out * kh * kw))).

The draws come from an explicit ``torch.Generator``; they are not the JAX
package's numbers (the tests carry Flax weights across instead).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import PReLU, set_compute_dtype
from .scrfd import SCRFDHead


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize ``model`` in place from ``seed``; returns it.

    Draws on the CPU (module order), so a seed gives the same weights on
    every device: initialize before moving the model. A model computing in
    bfloat16 gets the new weights rounded again.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            std = math.sqrt(2.0 / max(m.out_channels * kh * kw, 1))
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = math.sqrt(2.0 / max(m.out_features, 1))
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
        if isinstance(m, SCRFDHead):
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("scale"):
                    p.fill_(1.0)
    return set_compute_dtype(model)     # the new weights, rounded
