"""int8 against bf16 on det_10g's conv geometry, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_int8 \
        [--device cpu]

Port of the JAX repository's ``tools/exp_int8.py``. PyTorch has no int8
convolution on CUDA, so both dtypes run each 3x3 conv (stride 1, pad 1,
NHWC activations, HWIO weights, as the JAX tool) as the same im2col GEMM:
the nine shifted views of the padded input side by side ((B*H*W, 9*C),
``F.unfold`` has no int8 kernel), K and N zero-padded to multiples of 8
(``torch._int_mm``'s rule on CUDA; zero rows and columns leave the sums
exact), then

- int8: ``torch._int_mm``, int8 x int8 -> int32 (cuBLASLt);
- bf16: ``torch.matmul`` on bf16 with f32 accumulation (cuBLAS's compute
  type; the reduced-precision reduction turned off for the call), the
  output in bf16;

and, as the library yardstick, cuDNN's bf16 conv in ``channels_last`` (the
JAX tool's NHWC). Rows: the det_10g hot conv (64, 160, 160, 56 -> 56),
two wider geometries, the 8192 x 8192 GEMM in both dtypes as TOP/s
against the card's 1,979 int8 and 989 bf16 dense peaks at 700 W, then the
det_10g-backbone-shaped chain at B = 16 (the JAX tool's ``bench_chain``
shapes: 28 convs, though its label says 38): int8 conv -> scale + BN +
ReLU -> requantize ``clip(round(y * 12.7), -127, 127)`` against bf16 conv
-> BN + ReLU, each ending in the full-tensor sums, and the chain's
speedup. Each time is the
mean of 10 calls after a warm-up, CUDA events. Runs on the card unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import card_line, device_ms

INT8_PEAK = 1979e12         # dense int8 OP/s of an H100 SXM at 700 W
BF16_PEAK = 989e12
CONVS = ((64, 160, 160, 56, 56), (64, 160, 160, 128, 128),
         (32, 80, 80, 256, 256))
MATMUL = 8192
CHAIN_BATCH = 16
REQUANT = 12.7


def chain_shapes() -> List[Tuple[int, int, int, int, int]]:
    """The JAX tool's backbone-shaped chain: (H, W, Cin, Cout, stride) of
    each of its convs (det_10g's trunk at a 640 x 640 canvas; 28, though
    the JAX tool's label says 38)."""
    shapes = [(320, 320, 28, 28, 1), (320, 320, 28, 56, 1)]
    stage_hw = {1: 160, 2: 80, 3: 40, 4: 20}
    blocks = {1: (3, 56, 56), 2: (5, 56, 56), 3: (2, 56, 144),
              4: (3, 144, 248)}
    for si in (1, 2, 3, 4):
        nb, cin, cout = blocks[si]
        hw = stage_hw[si]
        for bi in range(nb):
            c0 = cin if bi == 0 else cout
            shapes.append((hw, hw, c0, cout, 1))
            shapes.append((hw, hw, cout, cout, 1))
    return shapes


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def im2col(x):
    """(B, H, W, C) NHWC -> (B*H*W, Kp) with the 3x3 window's nine views
    (dy, dx, c order: HWIO's rows), K = 9*C zero-padded to a multiple of
    8; any dtype."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3)
            for dx in range(3)]
    k = 9 * c
    if _up8(k) != k:
        cols.append(x.new_zeros((b, h, w, _up8(k) - k)))
    return torch.cat(cols, dim=-1).reshape(b * h * w, _up8(k))


def gemm_weight(w):
    """(3, 3, C, F) HWIO -> the (Kp, Np) GEMM operand, K and N zero-padded
    to multiples of 8, column-major (cuBLASLt's int8 layout)."""
    import torch.nn.functional as F

    kh, kw, c, f = w.shape
    m = w.reshape(kh * kw * c, f)
    m = F.pad(m, (0, _up8(f) - f, 0, _up8(kh * kw * c) - kh * kw * c))
    return m.t().contiguous().t()


@contextlib.contextmanager
def f32_accumulate():
    """bf16 GEMMs with f32 reductions throughout (no reduced-precision
    split-K), restored after."""
    import torch

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


def conv(x, wmat, f: int):
    """The 3x3 conv of (B, H, W, C) ``x`` by ``gemm_weight``'s operand:
    (B, H, W, F), int32 from int8, bf16 from bf16."""
    import torch

    b, h, w, _ = x.shape
    cols = im2col(x)
    y = (torch._int_mm(cols, wmat) if x.dtype == torch.int8
         else torch.matmul(cols, wmat))
    return y[:, :f].reshape(b, h, w, f)


def requantize(y):
    """The JAX tool's requantization for the next layer:
    ``clip(round(y * 12.7), -127, 127)`` as int8 (round half to even)."""
    import torch

    return torch.clamp(torch.round(y * REQUANT), -127, 127).to(torch.int8)


def conv_inputs(rng, shape, int8: bool, device):
    """The JAX tool's draws for one conv: x (B, H, W, C) and w (3, 3, C,
    F), int8 in [-127, 127) or bf16 normals."""
    import torch

    b, h, w, c, f = shape
    if int8:
        x = rng.integers(-127, 127, (b, h, w, c), dtype=np.int8)
        wt = rng.integers(-127, 127, (3, 3, c, f), dtype=np.int8)
        return torch.from_numpy(x).to(device), torch.from_numpy(wt).to(
            device)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = rng.normal(size=(3, 3, c, f)).astype(np.float32)
    return (torch.from_numpy(x).to(device).to(torch.bfloat16),
            torch.from_numpy(wt).to(device).to(torch.bfloat16))


def bench_conv(rng, shape, int8: bool, dev, emit, n: int = 10):
    """One conv's row; returns (ms, x, w, output) for the checks."""
    b, h, w, c, f = shape
    x, wt = conv_inputs(rng, shape, int8, dev)
    wmat = gemm_weight(wt)
    with f32_accumulate():
        out = conv(x, wmat, f)
        dt = device_ms(lambda: conv(x, wmat, f), n, dev)
    fl = 2 * b * h * w * c * f * 9
    emit(f"{'int8' if int8 else 'bf16'} conv B{b} {h}x{w} C{c}F{f}: "
         f"{dt:.2f} ms  {fl / dt / 1e9:.1f} T(FL)OPS")
    return dt, x, wt, out


def bench_cudnn(x, wt, dev, emit, n: int = 10):
    """cuDNN's bf16 conv in channels_last on the bf16 row's inputs."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = x.shape
    f = wt.shape[-1]
    xc = x.permute(0, 3, 1, 2)                       # NCHW view, NHWC data
    wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dt = device_ms(lambda: F.conv2d(xc, wc, padding=1), n, dev)
    fl = 2 * b * h * w * c * f * 9
    emit(f"cudnn bf16 conv channels_last B{b} {h}x{w} C{c}F{f}: {dt:.2f} ms"
         f"  {fl / dt / 1e9:.1f} TFLOPS")
    return dt


def bench_matmul(rng, n_dim: int, int8: bool, dev, emit, n: int = 10):
    """The n x n GEMM; returns (ms, a, output)."""
    import torch

    if int8:
        a = torch.from_numpy(rng.integers(-127, 127, (n_dim, n_dim),
                                          dtype=np.int8)).to(dev)
        b = a.t().contiguous().t()          # column-major, as cuBLASLt's

        def fn():
            return torch._int_mm(a, b)
    else:
        a = torch.from_numpy(rng.normal(size=(n_dim, n_dim)).astype(
            np.float32)).to(dev).to(torch.bfloat16)

        def fn():
            return torch.matmul(a, a)
    with f32_accumulate():
        out = fn()
        dt = device_ms(fn, n, dev)
    ops = 2 * n_dim ** 3 / dt / 1e-3
    peak = INT8_PEAK if int8 else BF16_PEAK
    emit(f"{'int8' if int8 else 'bf16'} {n_dim}x{n_dim} matmul: {dt:.2f} ms"
         f"  {ops / 1e12:.0f} TOPS ({ops / peak:.3f} of "
         f"{peak / 1e12:,.0f} {'TOP/s int8' if int8 else 'TFLOP/s bf16'})")
    return dt, a, out


def make_chain(rng, int8: bool, dev, shapes, batch: int):
    """The JAX tool's chain draws: each conv's weight, scale and BN, then
    each conv's own input (the chain skips resampling between stages)."""
    import torch

    ws, bns = [], []
    for (h, w, ci, co, s) in shapes:
        if int8:
            wt = torch.from_numpy(rng.integers(-127, 127, (3, 3, ci, co),
                                               dtype=np.int8))
        else:
            wt = torch.from_numpy(
                rng.normal(size=(3, 3, ci, co)).astype(np.float32) * 0.05
            ).to(torch.bfloat16)
        ws.append(wt.to(dev))
        bns.append(tuple(torch.from_numpy(
            rng.normal(size=co).astype(np.float32)).to(dev)
            for _ in range(2)))
    xs = []
    for (h, w, ci, co, s) in shapes:
        if int8:
            x = torch.from_numpy(rng.integers(-127, 127, (batch, h, w, ci),
                                              dtype=np.int8))
        else:
            x = torch.from_numpy(rng.normal(size=(batch, h, w, ci)).astype(
                np.float32)).to(torch.bfloat16)
        xs.append(x.to(dev))
    return xs, ws, bns


def chain_total(xs, wmats, bns, fs, int8: bool):
    """The chain: each conv, scale + BN + ReLU in f32, then the int8
    requantization (int8) and a full-tensor sum, summed over the convs."""
    import torch

    tot = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for x, wmat, (g, b), f in zip(xs, wmats, bns, fs):
        acc = conv(x, wmat, f)
        y = acc.float() * (0.01 if int8 else 1.0)
        y = torch.clamp_min(y * g + b, 0.0)
        tot = tot + (requantize(y).float().sum() if int8 else y.sum())
    return tot


def bench_chain(rng, int8: bool, dev, emit, shapes, batch: int,
                n: int = 10):
    """The chain's row; returns (ms, xs, ws) for the checks."""
    xs, ws, bns = make_chain(rng, int8, dev, shapes, batch)
    wmats = [gemm_weight(w) for w in ws]
    fs = [s[3] for s in shapes]
    with f32_accumulate():
        dt = device_ms(lambda: chain_total(xs, wmats, bns, fs, int8), n, dev)
    fl = sum(2 * batch * h * w * ci * co * 9 for (h, w, ci, co, s) in shapes)
    emit(f"{'int8' if int8 else 'bf16'} backbone-shaped chain "
         f"({len(shapes)} convs + BN/ReLU{' + requant' if int8 else ''}): "
         f"{dt:.2f} ms  {fl / dt / 1e9:.1f} T(FL)OPS")
    return dt, xs, ws


def exact_conv_gap(x, w, got) -> int:
    """The int8 conv's int32 output against a float64 conv of the same
    integers on the same device (exact: every sum is below 2^53): the
    largest absolute difference."""
    import torch
    import torch.nn.functional as F

    want = F.conv2d(x.permute(0, 3, 1, 2).double(),
                    w.permute(3, 2, 0, 1).double(), padding=1)
    return int((got.permute(0, 3, 1, 2).double() - want).abs().max())


def exact_matmul_gap(a, got) -> int:
    """The int8 GEMM's output against a float64 matmul of the same
    integers."""
    ad = a.double()
    return int((got.double() - ad @ ad).abs().max())


def run(convs=CONVS, matmul: int = MATMUL, chain_batch: int = CHAIN_BATCH,
        device=None, check: bool = False,
        emit: Callable[[str], None] = print) -> Dict:
    """Every row: {"convs": [(shape, bf16 ms, int8 ms, cudnn ms)],
    "matmul": (bf16 ms, int8 ms), "chain": (bf16 ms, int8 ms),
    "speedup"}; with ``check``, "exact": the largest gap of every int8
    conv and the int8 GEMM from float64 (must be 0)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out: Dict = dict(convs=[], exact={})
    with torch.inference_mode():
        for shape in convs:
            t_bf, xb, wb, _ = bench_conv(rng, shape, False, dev, emit)
            t_i8, x, w, y = bench_conv(rng, shape, True, dev, emit)
            t_dnn = bench_cudnn(xb, wb, dev, emit)
            out["convs"].append((shape, t_bf, t_i8, t_dnn))
            if check:
                out["exact"][f"conv {shape}"] = exact_conv_gap(x, w, y)
            del xb, wb, x, w, y
        t_bf, _, _ = bench_matmul(rng, matmul, False, dev, emit)
        t_i8, a, y = bench_matmul(rng, matmul, True, dev, emit)
        out["matmul"] = (t_bf, t_i8)
        if check:
            out["exact"]["matmul"] = exact_matmul_gap(a, y)
        del a, y
        shapes = chain_shapes()
        c_bf, _, _ = bench_chain(rng, False, dev, emit, shapes, chain_batch)
        c_i8, xs, ws = bench_chain(rng, True, dev, emit, shapes,
                                   chain_batch)
        if check:
            out["exact"]["chain"] = max(
                exact_conv_gap(x, w, conv(x, gemm_weight(w), w.shape[-1]))
                for x, w in zip(xs, ws))
        out["chain"] = (c_bf, c_i8)
        out["speedup"] = c_bf / c_i8
        emit(f"chain speedup int8/bf16: {out['speedup']:.2f}x")
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
