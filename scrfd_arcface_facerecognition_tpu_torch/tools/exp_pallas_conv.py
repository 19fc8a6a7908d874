"""Kernel K4: the narrow-channel 3x3 stride-1 conv, and its experiment's path.

Counterpart of the JAX repository's ``tools/exp_pallas_conv.py`` (Pallas
``pallas_conv3x3``, body ``_kern``), written for det_10g's 56-channel
backbone convs. Its function, on x (B, C, H, Wp) bf16 and packed weights
w3 (3, 3C, F) bf16 (``w3[dy]`` rows ordered (dx, c), ``pack_weights``):

    P_dy[b, f, h, w] = sum_{dx, c} w3[dy, dx * C + c, f]
                                   * x[b, c, h + dy - 1, (w + dx - 1) mod Wp]
    y = round_bf16(act(((P_0 + P_1) + P_2) * scale[f] + bias[f]))

in f32, rows zero-padded and lanes circular: every one of the Wp lanes is
computed, and lane Wp - 1 reads lane 0 as its right neighbour (the TPU
kernel's dx roll). ``act`` is ReLU or the identity; ``scale`` and ``bias``
default to ones and zeros. H must be a multiple of 8, as there.

``conv3x3`` launches the CUDA kernel (``csrc/conv3x3.cu``, on the tensor
cores) for CUDA tensors and runs the plain PyTorch version
(``conv3x3_plain``) for CPU tensors, and only for them. ``launches``
counts the kernel's launches. The plain version sums each P_dy in f32
over k = dx * C + c in order (the products of bf16 values are exact);
the kernel's tensor cores sum in an order of their own. So the two are
held to a tolerance on the f32 sum, not to bit equality:
``sum_tolerance_ratio`` allows one bf16 step at the larger of the two
outputs plus |scale[f]| * 2^-12 * A, where A = ``tap_abs_sum`` is the
sum of |w| |x| over the 9C taps. A reordered f32 sum of the 9C exact
products errs by at most about 9C * 2^-24 * A (2^-15 * A at C=56), so
2^-12 leaves room for the tensor cores' own rounding, while one wrong or
dropped tap (about A / 9C, 2^-9 * A at C=56) stands far above it.

The script's path (``run`` / ``main``) runs the kernel at the script's
shapes, B=64, H=96, W=160 (Wp=256), C=F=56, against the plain version and
cuDNN's bf16 ``conv2d``, both on the W real lanes and, for the same work
as the kernel, on all Wp lanes::

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_pallas_conv
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import device_ms

NAME = "conv3x3"
SHAPES = dict(b=64, h=96, w=160, c=56, f=56, wp=256)
launches = 0
_launch_fn = None


def pack_weights(k: np.ndarray) -> np.ndarray:
    """(3, 3, C, F) HWIO -> (3, 3C, F): w3[dy] rows ordered (dx, c)."""
    return np.ascontiguousarray(k.reshape(3, 3 * k.shape[2], k.shape[3]))


def _check_height(h: int) -> None:
    if h % 8:
        raise ValueError(f"height {h} must be a multiple of 8")


def _affine(f: int, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
            dev: torch.device):
    scale = (torch.ones((f,), dtype=torch.float32, device=dev) if scale is None
             else torch.as_tensor(scale, dtype=torch.float32, device=dev))
    bias = (torch.zeros((f,), dtype=torch.float32, device=dev) if bias is None
            else torch.as_tensor(bias, dtype=torch.float32, device=dev))
    return scale.contiguous(), bias.contiguous()


def _tap_sums(x: torch.Tensor, w3: torch.Tensor):
    """[P_0, P_1, P_2], each summed in f32 over k = dx * C + c in order."""
    b, c, h, wp = x.shape
    _check_height(h)
    f = w3.shape[2]
    xf = F.pad(x.to(torch.float32), (0, 0, 1, 1))          # zero rows
    # lane w of copy dx holds x[(w + dx - 1) mod Wp]
    xs = [torch.roll(xf, 1, dims=3), xf, torch.roll(xf, -1, dims=3)]
    wf = w3.to(torch.float32)
    p = []
    for dy in range(3):
        acc = torch.zeros((b, f, h, wp), dtype=torch.float32, device=x.device)
        for dx in range(3):
            rows = xs[dx][:, :, dy:dy + h]
            for ci in range(c):
                acc = acc + rows[:, ci:ci + 1] * wf[dy, dx * c + ci][:, None,
                                                                   None]
        p.append(acc)
    return p


def conv3x3_plain(x: torch.Tensor, w3: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """The plain version: each P_dy summed in f32 over k = dx * C + c in
    order (the products of bf16 values are exact), then (P0 + P1) + P2,
    the affine, ReLU and bf16 rounding."""
    p = _tap_sums(x, w3)
    scale, bias = _affine(w3.shape[2], scale, bias, x.device)
    out = ((p[0] + p[1]) + p[2]) * scale[:, None, None] + bias[:, None, None]
    if relu:
        out = torch.relu(out)
    return out.to(torch.bfloat16)


def tap_abs_sum(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """A[b, f, h, w] = sum over the 9C taps of |w| * |x|, in f32, from the
    plain version's loop: the scale of the sum's rounding error."""
    p = _tap_sums(x.abs(), w3.abs())
    return (p[0] + p[1]) + p[2]


def sum_tolerance_ratio(got: torch.Tensor, want: torch.Tensor,
                        a: torch.Tensor,
                        scale: Optional[torch.Tensor] = None) -> float:
    """The worst ratio of |got - want| to what the sum's order may change:
    one bf16 step at max(|got|, |want|) + |scale[f]| * 2^-12 * a, with a
    from ``tap_abs_sum``. At most 1 passes. -1 when the NaN positions
    differ; equal values (the same infinity too) count as exact."""
    g, w = got.float(), want.float()
    nan = torch.isnan(g)
    if not torch.equal(nan, torch.isnan(w)):
        return -1.0
    scale, _ = _affine(got.shape[1], scale, None, got.device)
    m = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(m)                    # m = mant * 2^e, mant in [0.5, 1)
    step = torch.ldexp(torch.ones_like(m), e - 8)
    allowed = step + scale.abs()[:, None, None] * 2.0 ** -12 * a.float()
    ratio = torch.where(g == w, torch.zeros_like(g), (g - w).abs() / allowed)
    ratio = ratio[~nan]
    ratio = torch.where(torch.isnan(ratio), float("inf"), ratio)   # inf / inf
    return float(ratio.max()) if ratio.numel() else 0.0


def launch_function(lib: ctypes.CDLL):
    """``conv3x3_launch`` of a library built from ``csrc/conv3x3.cu``,
    typed for ctypes."""
    fn = lib.conv3x3_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind():
    """The C launch function, built and loaded at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ..cuda_build import library

        _launch_fn = launch_function(library(NAME))
    return _launch_fn


def conv3x3(x: torch.Tensor, w3: torch.Tensor,
            scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            relu: bool = False) -> torch.Tensor:
    """x (B, C, H, Wp) bf16, w3 (3, 3C, F) bf16, optional per-channel
    scale / bias (F,) f32 -> (B, F, H, Wp) bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise.
    """
    _check_height(x.shape[2])
    if x.device.type == "cpu":
        return conv3x3_plain(x, w3, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (B, C, H, Wp) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, c, h, wp = x.shape
    if w3.dtype != torch.bfloat16 or w3.dim() != 3 or w3.shape[:2] != (3, 3 * c):
        raise ValueError(f"conv3x3: w3 must be (3, {3 * c}, F) bfloat16, got "
                         f"{tuple(w3.shape)} {w3.dtype}")
    f = w3.shape[2]
    scale, bias = _affine(f, scale, bias, x.device)
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"conv3x3: scale and bias must be ({f},)")
    if w3.device != x.device:
        raise ValueError("conv3x3: x and w3 on different devices")
    if not (x.is_contiguous() and w3.is_contiguous()):
        raise ValueError("conv3x3: inputs must be contiguous")
    y = torch.empty((b, f, h, wp), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    fn = _bind()
    # the C launcher works on the current device (the launch, and any
    # shared-memory attribute or limit it sets or reads): make the tensor's
    # device current, so that a shard on another card is launched there
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w3.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), b, c, h, wp, f, int(relu),
                stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {rc} "
                           f"(B={b}, C={c}, H={h}, Wp={wp}, F={f})")
    global launches
    launches += 1
    return y


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance, in bf16 steps, between two bf16 tensors of one
    shape (+0 and -0 are one value; NaN positions must agree, else -1)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return -1
    if a.numel() == 0:
        return 0

    def key(t):
        bits = t[~na].view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((key(a) - key(b)).abs().max()) if bool((~na).any()) else 0


def workload(rng: np.random.Generator, b: int, h: int, w: int, c: int,
             f: int, wp: int, device=None):
    """The script's inputs: x (B, C, H, Wp) bf16 with zero lanes >= W and
    packed w3 (3, 3C, F) bf16, from N(0, 1) pixels and N(0, 0.1) taps; plus
    the HWIO kernel."""
    dev = resolve_device(device)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = rng.normal(scale=0.1, size=(3, 3, c, f)).astype(np.float32)
    xp = np.zeros((b, c, h, wp), np.float32)
    xp[:, :, :, :w] = x.transpose(0, 3, 1, 2)
    xt = torch.from_numpy(xp).to(dev).to(torch.bfloat16)
    w3 = torch.from_numpy(pack_weights(k)).to(dev).to(torch.bfloat16)
    return xt, w3, k


def cudnn_conv(x: torch.Tensor, k: torch.Tensor, w: int,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, relu: bool = False):
    """The library yardstick: one bf16 ``conv2d`` (cuDNN on the card) on
    the first w lanes, zero-padded, then the affine and ReLU; k is the
    (F, C, 3, 3) bf16 weight. Equal to K4 on lanes < W when x's lanes >= W
    are zero; with w = Wp it does K4's work (flops and bytes), with zero
    lanes at the edges in place of the circular ones."""
    y = F.conv2d(x[..., :w], k, padding=1).to(torch.float32)
    if scale is not None:
        y = y * scale[:, None, None]
    if bias is not None:
        y = y + bias[:, None, None]
    return (torch.relu(y) if relu else y).to(torch.bfloat16)


def run(shapes: Optional[Dict[str, int]] = None, iters: int = 30,
        seed: int = 0, device=None) -> Dict[str, float]:
    """The script's path: K4 at ``shapes`` (default the script's), against
    its plain version on all Wp lanes (``sum_tolerance_ratio``, and the
    bf16 steps apart) and cuDNN's bf16 conv (max abs difference on the W
    lanes), each timed; cuDNN on the W lanes and on all Wp lanes."""
    s = dict(SHAPES, **(shapes or {}))
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x, w3, k = workload(rng, s["b"], s["h"], s["w"], s["c"], s["f"], s["wp"],
                        device=dev)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(dev).to(
        torch.bfloat16)
    y = conv3x3(x, w3)
    want = conv3x3_plain(x, w3)
    ratio = sum_tolerance_ratio(y, want, tap_abs_sum(x, w3))
    ulps = bf16_ulps(y, want)
    lib = cudnn_conv(x, kt, s["w"])
    ref = y[..., :s["w"]].float()
    lib_err = float((lib.float() - ref).abs().max())
    ms = device_ms(lambda: conv3x3(x, w3), iters, dev)
    lib_ms = device_ms(lambda: cudnn_conv(x, kt, s["w"]), iters, dev)
    lib_wp_ms = device_ms(lambda: cudnn_conv(x, kt, s["wp"]), iters, dev)
    gflop = 2 * s["b"] * s["h"] * s["wp"] * 9 * s["c"] * s["f"] / 1e9
    return dict(ms=ms, cudnn_ms=lib_ms, cudnn_wp_ms=lib_wp_ms, ratio=ratio,
                ulps=ulps, cudnn_max_abs=lib_err,
                scale=float(ref.abs().max()), gflop=gflop)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    r = run(device=args.device)
    where = resolve_device(args.device)
    name = (torch.cuda.get_device_name(where) if where.type == "cuda"
            else "CPU, host clock")
    print(f"K4 vs its plain version: tolerance ratio {r['ratio']:.4g} "
          f"(at most 1 passes), at most {r['ulps']} bf16 steps apart; vs "
          f"cuDNN bf16 conv2d: max abs {r['cudnn_max_abs']:.4f} (scale "
          f"{r['scale']:.2f})")
    print(f"K4 conv3x3: {r['ms']:.3f} ms  {r['gflop'] / r['ms']:.1f} TFLOP/s "
          f"over all {SHAPES['wp']} lanes; cuDNN bf16 conv2d on all "
          f"{SHAPES['wp']} lanes {r['cudnn_wp_ms']:.3f} ms, on the "
          f"{SHAPES['w']} real lanes {r['cudnn_ms']:.3f} ms  [{name}]")

if __name__ == "__main__":
    main()
