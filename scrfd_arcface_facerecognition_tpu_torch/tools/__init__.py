"""Ports of the JAX repository's concluded kernel experiments under
``tools/``: each module is named after the script it ports, holds the
experiment's kernel wrapper and plain version, and keeps the script's
workload, reference check and timing as functions (``main`` runs them on
the card: ``python -m scrfd_arcface_facerecognition_tpu_torch.tools.<name>``).

- ``exp_warp2``: kernel K3, the 5-pass band-mix face warp
  (``csrc/warp_band.cu``);
- ``exp_pallas_conv``: kernel K4, the narrow-channel 3x3 conv
  (``csrc/conv3x3.cu``).
"""
import time

import torch


def device_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms of fn() over ``iters`` calls after a warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters
