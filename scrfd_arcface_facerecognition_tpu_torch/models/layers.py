"""Shared building blocks (NCHW), with a compute dtype.

Parameters stay float32 (float64 only where a trainer checks its steps in
double). The casts sit where Flax's ``dtype=`` puts them in the JAX
package: a conv, a dense layer and a PReLU compute in the compute dtype
(bfloat16 on the card's serving path) on weights rounded to it once, by
``set_compute_dtype``, not on every call; BatchNorm and GroupNorm compute
in float32 (or wider) from their input in the compute dtype and hand back
the compute dtype (``flax.linen.normalization._normalize`` promotes ``x -
mean`` to at least float32 and casts only the result).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from ..parallel import collectives


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class RoundedWeights:
    """A layer that computes in ``compute_dtype``. ``rounded`` names the
    parameters used in that dtype; in a dtype other than the parameter's
    each gets a copy rounded to it, a non-persistent buffer ``<name>_c``
    (so state dicts and the weights carrier see only the parameters)."""

    rounded: Sequence[str] = ("weight", "bias")
    compute_dtype = torch.float32

    def round_weights(self, dtype: torch.dtype) -> None:
        self.compute_dtype = dtype
        for name in self.rounded:
            p = getattr(self, name, None)
            copy = (None if p is None or dtype == p.dtype
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
    activation.

    In training it normalizes with the batch's statistics and moves the
    running ones as Flax does: ``(1 - momentum) * running + momentum *
    batch`` with the biased batch variance (PyTorch's own update takes the
    unbiased one, n / (n - 1) larger). ``hold_stats`` leaves them alone
    while ``remat_call`` recomputes the forward in the backward pass.

    In a meshed training step (a thread of ``parallel.collectives``' slot
    group) the batch is the global one, as under GSPMD: the statistics are
    the mean and the biased variance over every slot's N * H * W, two
    exchanges of per-slot sums (the mean first, then the centred sum of
    squares), and the slot of rank 0 moves the running statistics once."""

    hold_stats = False

    def _global_batch(self, x: torch.Tensor, ctx) -> torch.Tensor:
        """Training mode over the step's global batch, in explicit ops
        (``F.batch_norm``'s backward assumes local statistics); Flax's
        ``_normalize``: ``(x - mean) * (scale * rsqrt(var + eps)) +
        bias``."""
        xf = at_least_f32(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = xf.numel() // xf.shape[1] * ctx.size
        mean = ctx.all_sum(xf.sum(dims)) / n
        d = xf - mean.reshape(shape)
        var = ctx.all_sum((d * d).sum(dims)) / n
        if ctx.leader and not self.hold_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = d * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            ctx = collectives.current()
            if ctx is not None:
                return self._global_batch(x, ctx)
            xf = at_least_f32(x)
            if not self.hold_stats:
                dims = [0] + list(range(2, x.dim()))
                with torch.no_grad():
                    var, mean = torch.var_mean(xf, dims, correction=0)
                    m = self.momentum
                    self.running_mean.copy_(
                        (1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_(
                        (1 - m) * self.running_var + m * var)
            return F.batch_norm(xf, None, None, self.weight, self.bias, True,
                                0.0, self.eps).to(x.dtype)
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BatchNorm2d(_F32BatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_F32BatchNorm, nn.BatchNorm1d):
    pass


@contextlib.contextmanager
def _stats_held(block: nn.Module) -> Iterator[None]:
    norms = [m for m in block.modules() if isinstance(m, _F32BatchNorm)]
    for m in norms:
        m.hold_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.hold_stats = False


@contextlib.contextmanager
def _recomputing(block: nn.Module, replay) -> Iterator[None]:
    with replay, _stats_held(block):
        yield


def remat_call(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward pass
    instead of kept (``jax.checkpoint``); the recomputation does not move
    BatchNorm's running statistics a second time, so they move once a
    step with remat as without it. In a meshed step it does not exchange
    them a second time either: it takes the sums the forward exchanged
    (``collectives.remat_contexts``)."""
    def contexts():
        record, replay = collectives.remat_contexts()
        return record, _recomputing(block, replay)

    return _checkpoint.checkpoint(block, x, use_reentrant=False,
                                  context_fn=contexts)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 (statistics and affine; float64 for a float64
    input), the result in the input's dtype: mixed-dtype group_norm is not
    on every backend."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(at_least_f32(x)).to(x.dtype)


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
    bfloat16; float64 for a model whose parameters are float64, as a
    trainer's check in double); ``None`` re-rounds them at each layer's
    current dtype, as the weight loaders do after they write new weights.
    Returns the model."""
    double = dtype == torch.float64 and all(
        p.dtype == torch.float64 for p in model.parameters())
    if dtype is not None and dtype not in (torch.float32, torch.bfloat16) \
            and not double:
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16 "
                         "(float64 for a model whose parameters are)")
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
