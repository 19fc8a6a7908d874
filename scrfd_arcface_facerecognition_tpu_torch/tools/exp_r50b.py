"""Four equal formulations of the ArcFace embedding head, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_r50b \
        [--device cpu]

Port of the JAX repository's ``tools/exp_r50b.py``. The head is BN ->
flatten -> Dense(25088, 512) -> BN over the trunk's (B, 512, 7, 7)
activation, NCHW in the port. The dense weight ``w`` is (25088, 512) with
its rows in the reference's NHWC (h, w, c) order. Variants, all equal to
A up to rounding:

- A: production: ``_flatten_nhwc`` (a permute to NHWC, then a copy) and
  the ``Linear``;
- B: ``einsum("bchw,hwcd->bd")`` with the weight reshaped once;
- C: a 7x7 VALID conv with the weight reshaped to (512, 512, 7, 7);
- D: the NCHW flatten with the weight's rows permuted once to (c, h, w)
  order: no permute of the activation.

First the four are held to A at float32's tolerance (1e-4 of A's largest
magnitude, TF32 off), then each is timed alone on a trunk-shaped bf16
input and inside the full model (the port's trunk through ``head_bn``,
the variant, ``features_bn``) at B = 960 and 480, against the port's
``IResNet`` forward. Times are the mean of 20 (head) and 10 (full) calls
after a warm-up, CUDA events. Runs on the card unless given ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional

import numpy as np

from . import card_line, device_ms

EMB = 512
BATCHES = (960, 480)
AGREE_RTOL = 1e-4           # of A's largest |value|, float32, TF32 off


def _w4(w):
    """(25088, D) in (h, w, c) row order -> (7, 7, 512, D)."""
    return w.reshape(7, 7, -1, w.shape[-1])


def head_a(x, w, b):
    """Production: NHWC flatten, then the dense layer."""
    import torch.nn.functional as F

    from ..models.arcface import _flatten_nhwc

    return F.linear(_flatten_nhwc(x), w.t().to(x.dtype), b.to(x.dtype))


def head_b(x, w, b):
    """einsum over (c, h, w) with the weight reshaped (HWC order kept)."""
    import torch

    return torch.einsum("bchw,hwcd->bd", x, _w4(w).to(x.dtype)) + b.to(
        x.dtype)


def head_c(x, w, b):
    """A 7x7 VALID conv."""
    import torch.nn.functional as F

    wc = _w4(w).permute(3, 2, 0, 1).to(x.dtype)      # (D, C, 7, 7)
    return F.conv2d(x, wc).reshape(x.shape[0], -1) + b.to(x.dtype)


def permuted_rows(w):
    """The weight's rows from (h, w, c) to (c, h, w) order, the NCHW
    flatten's."""
    return _w4(w).permute(2, 0, 1, 3).reshape(-1, w.shape[-1])


def head_d(x, w, b, wp=None):
    """NCHW flatten with the weight's rows permuted (``wp``, made once by
    ``permuted_rows``): no permute of the activation."""
    import torch.nn.functional as F

    wp = permuted_rows(w) if wp is None else wp
    return F.linear(x.flatten(1), wp.t().to(x.dtype), b.to(x.dtype))


HEADS = dict(A=head_a, B=head_b, C=head_c, D=head_d)


def make_head_weights(rng):
    """The JAX tool's (w_flat, bias): (25088, 512) * 0.01, then (512,)."""
    w = (rng.normal(size=(7 * 7 * 512, EMB)).astype(np.float32) * 0.01)
    return w, rng.normal(size=(EMB,)).astype(np.float32)


def agreement(x, w, b) -> Dict[str, float]:
    """Each variant's largest difference from A, relative to A's largest
    magnitude, in float32 with TF32 off."""
    import torch

    from ..device import full_f32

    with torch.inference_mode(), full_f32():
        ref = head_a(x, w, b)
        scale = float(ref.abs().max())
        return {k: float((h(x, w, b) - ref).abs().max()) / scale
                for k, h in HEADS.items()}


def full(model, name: str, wp):
    """The full model with head variant ``name``: the trunk through
    ``head_bn``, the variant on the FC's bf16 weight, ``features_bn``."""
    from ..models.arcface import _run_blocks
    from ..models.layers import at_least_f32

    w = model.fc.w("weight").t()              # (25088, 512), HWC rows
    b = model.fc.w("bias")

    def f(x):
        t = model.stem_prelu(model.stem_bn(model.stem_conv(x)))
        t = model.head_bn(_run_blocks(model, t, False))
        t = t.to(model.fc.compute_dtype)
        y = (head_d(t, w, b, wp) if name == "D"
             else HEADS[name](t, w, b))
        return at_least_f32(model.features_bn(y))
    return f


def run(batches=BATCHES, device=None, model=None,
        emit: Callable[[str], None] = print) -> Dict:
    """The agreement check, then every row: {"agreement": {k: rel},
    "head": {(k, B): ms}, "full": {(k, B): ms}, "baseline": {B: ms}}."""
    import torch

    from ..device import resolve_device
    from .exp_r50 import make_model

    dev = resolve_device(device) if model is None else next(
        model.parameters()).device
    rng = np.random.default_rng(0)
    w_np, b_np = make_head_weights(rng)
    w, b = torch.from_numpy(w_np).to(dev), torch.from_numpy(b_np).to(dev)
    xs = torch.from_numpy(np.ascontiguousarray(
        rng.normal(size=(4, 7, 7, 512)).astype(np.float32)
        .transpose(0, 3, 1, 2))).to(dev)
    agree = agreement(xs, w, b)
    bad = {k: v for k, v in agree.items() if not v <= AGREE_RTOL}
    if bad:
        raise RuntimeError(f"exp_r50b: head variants {bad} differ from A by "
                           f"more than {AGREE_RTOL} of its largest value")
    emit("variant agreement ok ("
         + ", ".join(f"{k} {v:.2e}" for k, v in agree.items())
         + f" of A's largest value, float32, TF32 off; tolerance "
         f"{AGREE_RTOL})")
    out = dict(agreement=agree, head={}, full={}, baseline={})
    wp = permuted_rows(w)
    with torch.inference_mode():
        for bsz in batches:
            x = torch.from_numpy(np.ascontiguousarray(
                rng.normal(size=(bsz, 7, 7, 512)).astype(np.float32)
                .transpose(0, 3, 1, 2))).to(dev).to(torch.bfloat16)
            for k, h in HEADS.items():
                fn = ((lambda: head_d(x, w, b, wp)) if k == "D"
                      else (lambda h=h: h(x, w, b)))
                t = out["head"][(k, bsz)] = device_ms(fn, 20, dev)
                emit(f"[head-only {k}] B={bsz}: {t:.2f} ms")
        if model is None:
            model = make_model(dev)
        wpm = permuted_rows(model.fc.w("weight").t())
        for bsz in batches:
            x = torch.from_numpy(np.ascontiguousarray(
                rng.normal(size=(bsz, 112, 112, 3)).astype(np.float32)
                .transpose(0, 3, 1, 2))).to(dev)
            base = out["baseline"][bsz] = device_ms(lambda: model(x), 10,
                                                    dev)
            emit(f"[full baseline IResNet] B={bsz}: {base:.1f} ms")
            for k in HEADS:
                f = full(model, k, wpm)
                t = out["full"][(k, bsz)] = device_ms(lambda: f(x), 10, dev)
                emit(f"[full {k}] B={bsz}: {t:.1f} ms ({t / base:.2f}x)")
    return out


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
