"""Precision of the reference and of its lower-precision control.

``f32_exact``: float32 products without TF32 (cuDNN's flag and the matmul
precision), restored after the block: the reference's precision.

``fp8_emulated``: the control of a configuration that computes in
bfloat16 (convolutions, dense layers and PReLU on bfloat16 weights and
activations, the norms in float32) is the reference one step lower, the
same layers in fp8 (e4m3): a copy of a module whose every convolution,
dense layer and PReLU rounds its weights (once), its input and its output
(each call) to e4m3 with one scale a tensor (the largest magnitude maps to
448), the arithmetic between in float32; the norms stay float32.
``tf32_round`` rounds float32 to TF32's 10-bit mantissa, the control of a
float32 match.

Imports torch only.
"""
from __future__ import annotations

import contextlib
import copy

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def f32_exact():
    tf32 = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(x.dtype)


FP8_LAYERS = (torch.nn.Conv2d, torch.nn.Linear, torch.nn.PReLU)


def fp8_emulated(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose convolutions, dense layers and PReLUs
    take e4m3-rounded weights and inputs and give e4m3-rounded outputs."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, FP8_LAYERS):
            with torch.no_grad():
                m.weight.copy_(to_e4m3(m.weight))
            m.register_forward_pre_hook(
                lambda mod, args: (to_e4m3(args[0]),) + tuple(args[1:]))
            m.register_forward_hook(lambda mod, args, out: to_e4m3(out))
    return model


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa
    bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
