"""Shared building blocks (NCHW)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F


class PReLU(nn.Module):
    """Channel-wise PReLU, one slope per channel (``alpha``, shape (C,))."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.alpha)


class ConvBN(nn.Module):
    """Conv + BatchNorm (+ ReLU or PReLU), inference mode.

    ``padding`` is symmetric per side, as the JAX package's explicit pads.
    Without BN the conv carries a bias, as there.
    """

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Union[int, Tuple[int, int]] = 3, stride: int = 1,
                 padding: int = 1, groups: int = 1, use_bn: bool = True,
                 act: Optional[str] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias=not use_bn)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5) if use_bn else None
        if act == "prelu":
            self.prelu = PReLU(out_ch)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "prelu":
            x = self.prelu(x)
        elif self.act == "relu":
            x = F.relu(x)
        return x
