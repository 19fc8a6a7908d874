"""Where kernel K4's time goes: ``csrc/conv3x3.cu`` built with one part
taken out, each variant timed at the experiment's shapes on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.conv3x3_ablate

Each variant is a text edit of the source, checked to apply exactly once,
built with nvcc (``cuda_build.build_variants``) into
``build/torch_kernels/ablate/`` and bound with ctypes like the kernel:

- ``full``: the kernel as it is;
- ``no_stream``: no row streams in while a row computes (a band's first
  three rows are staged, the rest of the ring is left as it is);
- ``no_store``: the epilogue's global stores removed (the tile is still
  written to shared memory);
- ``mma_only``: no staging and no epilogue: the mma.sync loop over
  whatever shared memory holds, its sums kept live by a store that never
  runs.

Only ``full`` computes the conv; the others give wrong outputs, and only
their times are read. Times are device ms per call, warm, back to back
(``tools.device_ms``), the variants in turns, over two rounds.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..device import resolve_device
from . import device_ms, exp_pallas_conv

_NO_STREAM = ("    const bool stream = src.vec",
              "    const bool stream = false && src.vec")
_SINK = ("    {\n      float s_ = 0.f;\n#pragma unroll\n"
         "      for (int a_ = 0; a_ < 64; ++a_) s_ += (&acc[0][0][0])[a_];\n"
         "      if (s_ == 1234.5f) y[threadIdx.x] = __float2bfloat16_rn(s_);\n"
         "    }\n    continue;\n")

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_stream": [_NO_STREAM],
    "no_store": [("    const int nf = min(kMT, F - f0);",
                  "    const int nf = 0;")],
    "mma_only": [
        _NO_STREAM,
        ("        stage_weights<CP>(wsm, w3, C, F, f0, src.c0, src.cc);\n"
         "        for (int r = h - 1; r <= h + 1; ++r)\n"
         "          if (r >= 0 && r < H) stage_row<CP>(slot_of(r), raw, src, "
         "r);\n", ""),
        ("    // epilogue: the block's", _SINK + "    // epilogue: the block's"),
    ],
}


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s edits applied; raises
    if an edit's text is not found exactly once."""
    src = cuda_build.source_path(exp_pallas_conv.NAME).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit target found "
                             f"{src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names=tuple(VARIANTS)) -> Dict[str, Callable]:
    """Build the variants with nvcc, all at once; returns each one's
    launch function, typed as ``conv3x3_launch``."""
    libs = cuda_build.build_variants(
        exp_pallas_conv.NAME, {n: variant_source(n) for n in names})
    return {n: exp_pallas_conv.launch_function(ctypes.CDLL(str(p)))
            for n, p in libs.items()}


def run(iters: int = 20, device=None) -> Dict[str, float]:
    """Device ms per call of each variant at the experiment's shapes
    (affine + ReLU), the mean of two rounds taken in turns."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv3x3_ablate times the kernel on the card")
    fns = build()
    s = exp_pallas_conv.SHAPES
    x, w3, _ = exp_pallas_conv.workload(np.random.default_rng(0), s["b"],
                                        s["h"], s["w"], s["c"], s["f"],
                                        s["wp"], device=dev)
    sc = torch.ones(s["f"], dtype=torch.float32, device=dev)
    bi = torch.zeros(s["f"], dtype=torch.float32, device=dev)
    y = torch.empty((s["b"], s["f"], s["h"], s["wp"]), dtype=torch.bfloat16,
                    device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn):
        rc = fn(x.data_ptr(), w3.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                y.data_ptr(), s["b"], s["c"], s["h"], s["wp"], s["f"], 1,
                stream)
        if rc != 0:
            raise RuntimeError(f"conv3x3 variant launch failed: CUDA error "
                               f"{rc}")

    ms = {n: 0.0 for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            ms[n] += device_ms(lambda: call(fns[n]), iters, dev) / 2
    return ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    ms = run(args.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    name = card[0] if card else torch.cuda.get_device_name(0)
    s = exp_pallas_conv.SHAPES
    print(f"K4 variants at B={s['b']} C={s['c']} H={s['h']} Wp={s['wp']} "
          f"F={s['f']}, affine + ReLU, device ms a call (warm) [{name}]:")
    for n, t in ms.items():
        print(f"  {n:10s} {t:.4f}  (full - {n}: {ms['full'] - t:+.4f})")


if __name__ == "__main__":
    main()
