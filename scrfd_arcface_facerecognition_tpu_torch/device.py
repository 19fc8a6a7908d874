"""Device selection for the port's entry points.

The port serves on a CUDA card. ``device=None`` means the card; running on
the CPU takes an explicit ``device="cpu"`` (the CPU tests pass it). There
is no silent fallback: asking for the card on a machine without one raises.
"""
from __future__ import annotations

from typing import Optional, Union

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
