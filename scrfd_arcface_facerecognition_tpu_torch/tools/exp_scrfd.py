"""SCRFD det_10g's forward split into its parts, at padded widths and in
f32, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_scrfd \
        [--batch 32] [--iters 20] [--device cpu]

Port of the JAX repository's ``tools/exp_scrfd.py``: det_10g seeded at
bf16 on B x 640 x 640 random inputs, then the port's ``Backbone``,
``PAFPN`` and ``SCRFDHead`` alone, each on the previous part's outputs
(the parts of the one seeded ``SCRFDNet``, so they compose to its
forward); then det_10g at two padded widths (the JAX tool's configs field
for field: every width a multiple of 32, then 64/128/256 throughout), whether
the tensor cores' tile alignment matters to cuDNN at det_10g's 56 / 144 /
248 channels; then the f32 control (cuDNN's convs in TF32, PyTorch's
default). The JAX tool builds every config with ``s2d_stem=True``, a
space-to-depth stem that is a TPU layout trick; the port builds only the
plain 3x3 stride-2 stem, so every row here runs that stem (the rows keep
the JAX tool's labels). Each row is the mean of ``--iters`` calls after a
warm-up, CUDA events. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional

import numpy as np

from . import card_line, device_ms

STEM_NOTE = ("stem: plain 3x3 stride 2 in every row (the JAX tool's "
             "s2d_stem is a TPU layout trick the port does not build)")


def padded_configs():
    """The JAX tool's padded-width configs, ``s2d_stem`` aside: (label,
    config)."""
    from ..models.scrfd import SCRFDConfig

    return (("det_10g widths padded to mult-of-32",
             SCRFDConfig("det_10g_pad", 64, (3, 5, 2, 3), (64, 64, 160, 256),
                         neck_filters=64, head_stacks=3, head_filters=96)),
            ("det_10g widths 64/128/256",
             SCRFDConfig("det_10g_128", 64, (3, 5, 2, 3),
                         (64, 128, 128, 256), neck_filters=128,
                         head_stacks=3, head_filters=128)))


def make_net(cfg, device, dtype=None):
    """``SCRFDNet(cfg)`` seeded (seed 0) at ``dtype`` (bf16 by default)
    on ``device``, in inference mode."""
    import torch

    from ..models.init_utils import seeded_init_
    from ..models.scrfd import SCRFDNet

    net = SCRFDNet(cfg, dtype=torch.bfloat16 if dtype is None else dtype)
    seeded_init_(net, 0)
    return net.eval().requires_grad_(False).to(device)


def make_input(batch: int, size: int = 640, seed: int = 0):
    """The JAX tool's input, ``default_rng(seed).normal`` (B, 640, 640, 3)
    f32, as NCHW."""
    x = np.random.default_rng(seed).normal(size=(batch, size, size, 3))
    return np.ascontiguousarray(x.astype(np.float32).transpose(0, 3, 1, 2))


def run(batch: int = 32, iters: int = 20, size: int = 640, device=None,
        emit: Callable[[str], None] = print) -> Dict:
    """Every row: {label: ms}, printed through ``emit``; also "outputs"
    (``SCRFDNet``'s and the parts' head outputs for the check)."""
    import torch

    from ..device import resolve_device
    from ..models.scrfd import SCRFD_CONFIGS

    dev = resolve_device(device)
    x = torch.from_numpy(make_input(batch, size)).to(dev)
    rows: Dict[str, float] = {}

    def timeit(name, fn):
        out = fn()
        ms = rows[name.strip()] = device_ms(fn, iters, dev)
        emit(f"{name:<46s} {ms:8.2f} ms")
        return out

    emit(STEM_NOTE)
    cfg = SCRFD_CONFIGS["det_10g"]
    with torch.inference_mode():
        net = make_net(cfg, dev)
        whole = timeit("det_10g full (bf16, s2d)", lambda: net(x))
        feats = timeit("  backbone only", lambda: net.backbone(x))
        # each part's outputs handed on as float32, as the JAX tool does
        f32 = [a.float() for a in feats]
        nf = timeit("  neck only", lambda: net.neck(f32))
        nf32 = [a.float() for a in nf]
        head = timeit("  head only", lambda: net.head(nf32))
        del net
        for label, pcfg in padded_configs():
            pnet = make_net(pcfg, dev)
            timeit(label, lambda: pnet(x))
            del pnet
        net32 = make_net(cfg, dev, torch.float32)
        timeit("det_10g full (f32, s2d)", lambda: net32(x))
    return dict(rows=rows, outputs=(whole, head))


def compose_gap(whole, head) -> Dict[str, float]:
    """The parts' head outputs against ``SCRFDNet``'s: per output kind,
    the largest absolute difference over the levels."""
    return {k: max(float((a - b).abs().max()) for a, b in
                   zip(whole[k], head[k])) for k in whole}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    print(f"card: {card_line(dev)}")
    run(args.batch, args.iters, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
