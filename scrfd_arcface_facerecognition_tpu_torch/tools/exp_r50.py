"""iResNet-50 forward at the production shape, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_r50 \
        [--device cpu]

Port of the JAX repository's ``tools/exp_r50.py``: w600k_r50 seeded at
bf16 on 960 crops of 112 x 112 (96 frames x 10 face slots), NCHW as the
port's model takes them. Rows, under the JAX tool's numbers:

1. the forward's device ms, its TFLOPS and share of the card's 989
   TFLOP/s bf16 peak (the FLOPs counted by
   ``torch.utils.flop_counter.FlopCounterMode``, the counterpart of XLA's
   cost analysis), us a crop;
5. B = 240 and 480;
2. cumulative prefixes of the port's own ``IResNet`` (the same modules
   and weights run up to a stage group: stem, then layer1..layer4), each
   group's difference, and the head as the full forward minus the trunk;
3. the layout: the model and input in ``torch.channels_last`` against the
   NCHW default, and their ratio (the JAX tool's NCHW entry);
4. the f32 control, twice: at PyTorch's defaults (cuDNN's convs in TF32,
   the FC in full f32) and with TF32 off for that row alone.

Every time is the mean of 10 calls after a warm-up, CUDA events
(``tools.device_ms``). Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import copy
import sys
from typing import Callable, Dict, Optional

import numpy as np

from . import card_line, device_ms

BF16_PEAK = 989e12          # dense bf16 FLOP/s of an H100 SXM at 700 W
CROPS = 960
SWEEP = (240, 480)
GROUPS = ("stem", "layer1(64ch,56^2)", "layer2(128ch,28^2)",
          "layer3(256ch,14^2,x14)", "layer4(512ch,7^2)")


def make_input(n: int = CROPS, seed: int = 0):
    """The JAX tool's crops, ``default_rng(seed).normal`` (n, 112, 112, 3)
    f32, as NCHW."""
    x = np.random.default_rng(seed).normal(size=(n, 112, 112, 3))
    return np.ascontiguousarray(x.astype(np.float32).transpose(0, 3, 1, 2))


def make_model(device, dtype=None):
    """w600k_r50 at ``dtype`` (bf16 by default), seeded (seed 0), on
    ``device``, in inference mode."""
    import torch

    from ..models import build_arcface
    from ..models.init_utils import seeded_init_

    model = build_arcface("w600k_r50",
                          torch.bfloat16 if dtype is None else dtype)
    seeded_init_(model, 0)
    return model.eval().requires_grad_(False).to(device)


def prefix(model, x, upto: int):
    """The model's stem, then its stage groups 1..``upto`` (0 = the stem
    alone): the trunk's activation after that group."""
    x = model.stem_prelu(model.stem_bn(model.stem_conv(x)))
    for name in model.blocks:
        if int(name[len("layer"):].split("_")[0]) > upto:
            break
        x = getattr(model, name)(x)
    return x


def flops(fn) -> float:
    """The FLOPs of one ``fn()`` as ``FlopCounterMode`` counts them (2 per
    multiply-add of the convs and the FC)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def run(n: int = CROPS, sweep=SWEEP, iters: int = 10, device=None,
        model=None, emit: Callable[[str], None] = print) -> Dict:
    """Every row, printed through ``emit`` and returned: {"ms", "flops",
    "tflops", "peak_share", "us_crop", "sweep": {B: ms}, "prefix": [ms
    cumulative], "head_ms", "channels_last_ms", "f32_tf32_ms",
    "f32_ms"}."""
    import torch

    from ..device import full_f32, resolve_device
    from ..models.layers import set_compute_dtype

    dev = resolve_device(device) if model is None else next(
        model.parameters()).device
    if model is None:
        model = make_model(dev)
    x = torch.from_numpy(make_input(n)).to(dev)
    out: Dict = {}

    def ms(fn, *args):
        return device_ms(lambda: fn(*args), iters, dev)

    with torch.inference_mode():
        fl = flops(lambda: model(x))
        base = ms(model, x)
        out.update(ms=base, flops=fl, tflops=fl / base / 1e9,
                   peak_share=fl / base / 1e-3 / BF16_PEAK,
                   us_crop=base / n * 1e3)
        emit(f"[1] r50 bf16 NCHW B={n}: {base:.1f} ms   "
             f"{out['tflops']:.1f} TFLOPS (FlopCounterMode {fl / 1e12:.2f}"
             f" TF; {out['peak_share']:.3f} of 989 TFLOP/s bf16)   "
             f"{out['us_crop']:.1f} us/crop")
        out["sweep"] = {}
        for b in sweep:
            t = ms(model, x[:b])
            out["sweep"][b] = t
            emit(f"[5] B={b}: {t:.1f} ms  {t / b * 1e3:.1f} us/crop")
        prev, out["prefix"] = 0.0, []
        for upto, name in enumerate(GROUPS):
            t = ms(prefix, model, x, upto)
            out["prefix"].append(t)
            emit(f"[2] +{name}: cumulative {t:.1f} ms  "
                 f"(group {max(t - prev, 0):+.1f} ms)")
            prev = t
        out["head_ms"] = base - prev
        emit(f"[2] head (full - trunk): {out['head_ms']:+.1f} ms")
        cl = copy.deepcopy(model).to(memory_format=torch.channels_last)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        t = out["channels_last_ms"] = ms(cl, x_cl)
        del cl
        emit(f"[3] channels_last: {t:.1f} ms ({t / base:.2f}x of NCHW)")
        m32 = set_compute_dtype(copy.deepcopy(model), torch.float32)
        t = out["f32_tf32_ms"] = ms(m32, x)
        emit(f"[4] f32 (PyTorch's defaults: cuDNN convs TF32 "
             f"{torch.backends.cudnn.allow_tf32}, FC matmul TF32 "
             f"{torch.backends.cuda.matmul.allow_tf32}): {t:.1f} ms "
             f"({t / base:.2f}x of bf16)")
        with full_f32():
            t = out["f32_ms"] = ms(m32, x)
        emit(f"[4] f32 (TF32 off): {t:.1f} ms ({t / base:.2f}x of bf16)")
    return out


def check(model, x) -> float:
    """The full prefix (stem through layer4) then the head equals the
    forward: the largest absolute difference (expected 0)."""
    import torch

    from ..models.arcface import _flatten_nhwc
    from ..models.layers import at_least_f32

    with torch.inference_mode():
        t = prefix(model, x, 4)
        head = at_least_f32(model.features_bn(model.fc(_flatten_nhwc(
            model.head_bn(t)))))
        return float((head - model(x)).abs().max())


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    print(f"card: {card_line(dev)}")
    run(device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
