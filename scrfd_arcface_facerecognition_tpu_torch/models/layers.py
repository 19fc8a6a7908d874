"""Shared building blocks (NCHW), with a compute dtype.

Parameters stay float32. The casts sit where Flax's ``dtype=`` puts them
in the JAX package: a conv, a dense layer and a PReLU compute in the
compute dtype (bfloat16 on the card's serving path) on weights rounded to
it once, by ``set_compute_dtype``, not on every call; BatchNorm and
GroupNorm compute in float32 from their input in the compute dtype and
hand back the compute dtype (``flax.linen.normalization._normalize``
promotes ``x - mean`` to float32 and casts only the result).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F


class RoundedWeights:
    """A layer that computes in ``compute_dtype``. ``rounded`` names the
    parameters used in that dtype; below float32 each gets a copy rounded
    to it, a non-persistent buffer ``<name>_c`` (so state dicts and the
    weights carrier see only the float32 parameters)."""

    rounded: Sequence[str] = ("weight", "bias")
    compute_dtype = torch.float32

    def round_weights(self, dtype: torch.dtype) -> None:
        self.compute_dtype = dtype
        for name in self.rounded:
            p = getattr(self, name, None)
            copy = (None if p is None or dtype == torch.float32
                    else p.detach().to(dtype))
            self.register_buffer(f"{name}_c", copy, persistent=False)

    def w(self, name: str) -> Optional[torch.Tensor]:
        """The parameter ``name`` as the layer computes with it."""
        copy = getattr(self, f"{name}_c", None)
        return getattr(self, name) if copy is None else copy


class Conv2d(RoundedWeights, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.compute_dtype), self.w("weight"),
                                  self.w("bias"))


class Linear(RoundedWeights, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self.w("weight"),
                        self.w("bias"))


class _F32BatchNorm:
    """BatchNorm in float32, the result in the input's dtype. In inference
    PyTorch's batch_norm takes a bfloat16 input with float32 statistics
    and affine as it is, computes in float32 and rounds once: the same
    numbers as on ``x.float()``, without a float32 copy of the
    activation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.training:
            return super().forward(x.float()).to(x.dtype)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BatchNorm2d(_F32BatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_F32BatchNorm, nn.BatchNorm1d):
    pass


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 (statistics and affine), the result in the
    input's dtype: mixed-dtype group_norm is not on every backend."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class PReLU(RoundedWeights, nn.Module):
    """Channel-wise PReLU, one slope per channel (``alpha``, shape (C,))."""

    rounded = ("alpha",)

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.w("alpha"))


def set_compute_dtype(model: nn.Module,
                      dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Round ``model``'s weights for computing in ``dtype`` (float32 or
    bfloat16); ``None`` re-rounds them at each layer's current dtype, as
    the weight loaders do after they write new weights. Returns the
    model."""
    if dtype is not None and dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    for m in model.modules():
        if isinstance(m, RoundedWeights):
            m.round_weights(m.compute_dtype if dtype is None else dtype)
    if dtype is not None:
        model.compute_dtype = dtype
    return model


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
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, groups=groups, bias=not use_bn)
        self.bn = BatchNorm2d(out_ch, eps=1e-5) if use_bn else None
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
