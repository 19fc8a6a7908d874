"""Device selection for the port's entry points.

The port serves on a CUDA card. ``device=None`` means the card; running on
the CPU takes an explicit ``device="cpu"`` (the CPU tests pass it). There
is no silent fallback: asking for the card on a machine without one raises.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> ``cuda``; a CUDA request without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return dev


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """f32 matmuls without TF32 inside the block: the JAX package's
    ``Precision.HIGHEST``. That is PyTorch's default, so this only acts when
    a caller has lowered the process-wide matmul precision."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 convolutions and matmuls without TF32 inside the block (cuDNN's
    flag and the matmul precision), the settings restored after it."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with full_f32_matmul():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def on_device(device: torch.device):
    """A block whose work goes to ``device``: ``torch.cuda.device`` for a
    CUDA device (the current device is what the kernels' C launchers, the
    current stream and a new event refer to), nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
