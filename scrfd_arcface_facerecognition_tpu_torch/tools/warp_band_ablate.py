"""Where kernel K3's time goes: ``csrc/warp_band.cu`` built with one part
taken out, each variant timed at the experiment's shapes on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.warp_band_ablate

Each variant is a text edit of the source, checked to apply exactly once,
built with nvcc (``cuda_build.build_variants``) into
``build/torch_kernels/ablate/`` and bound with ctypes like the kernel:

- ``full``: the kernel as it is;
- ``no_stage``: no source bytes are staged in shared memory (pass 1
  reads whatever the staging buffer holds);
- ``no_src``: neither staged nor read: pass 1 takes constants;
- ``no_p12``: nothing staged, and passes 1-2 write constants to shared
  memory (no pass-1 or pass-2 arithmetic);
- ``no_sync``: the walk's barriers removed (the passes race);
- ``no_store``: pass 5 computes the crop's pixels but does not store them.

Only ``full`` computes the crops; the others give wrong outputs, and only
their times are read. Times are device ms per call, warm, back to back
(``tools.device_ms``), the variants in turns, over two rounds, at 16 x
1080p frames and 320 crops (``exp_warp2.make_workload``, seed 0) and at
the first 80 crops of the same draws.
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
from ..ops.warp_params import OUT, planarize
from . import device_ms, exp_warp2

_NO_STAGE = [("  if (L.yhi > L.ylo) stage(made);\n", ""),
             ("      if (y0 + nr < L.yhi) stage(y0 + nr);", "")]

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_stage": _NO_STAGE,
    "no_src": _NO_STAGE + [("u8_to_f32(s0[c * kPW + t])", "1.f"),
                           ("u8_to_f32(s1[c * kPW + t])", "2.f")],
    "no_p12": _NO_STAGE + [("          const TapRow t2 = tab2[x];\n",
                            "#pragma unroll\n"
                            "          for (int c = 0; c < 3; ++c)\n"
                            "            p2b[c * kBufC + r * kQ + x] = 1.f;\n"
                            "          continue;\n"
                            "          const TapRow t2 = tab2[x];\n")],
    "no_sync": [("      async_wait_all();\n      __syncthreads();",
                 "      async_wait_all();"),
                ("      __syncthreads();\n      if (y0 + nr", "      if (y0 + nr"),
                ("      __syncthreads();\n      made += nr;",
                 "      made += nr;"),
                ("    if (!synced) __syncthreads();", "    (void)synced;"),
                ("    __syncthreads();\n    // pass 5:", "    // pass 5:")],
    "no_store": [("          dst[xo * 3 + c] = sum2(pos, a, t.w[0], bb, t.w[1]);",
                  "          const float s_ = sum2(pos, a, t.w[0], bb, t.w[1]);\n"
                  "          if (s_ == 1234.5f) dst[xo * 3 + c] = s_;")],
}


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s edits applied; raises
    if an edit's text is not found exactly once."""
    src = cuda_build.source_path(exp_warp2.NAME).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit target found "
                             f"{src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names=tuple(VARIANTS)) -> Dict[str, Callable]:
    """Build the variants with nvcc, all at once; returns each one's
    launch function, typed as ``warp_band_launch``."""
    libs = cuda_build.build_variants(
        exp_warp2.NAME, {n: variant_source(n) for n in names})
    return {n: exp_warp2.launch_function(ctypes.CDLL(str(p)))
            for n, p in libs.items()}


def run(iters: int = 20, device=None) -> Dict[int, Dict[str, float]]:
    """Device ms per call of each variant at 320 and at 80 crops, the mean
    of two rounds taken in turns."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("warp_band_ablate times the kernel on the card")
    fns = build()
    frames, canvas, _, _, prm = exp_warp2.make_workload(
        np.random.default_rng(0), 16, 320, device=dev)
    fp, cp = planarize(frames), planarize(canvas)
    nb, _, fh, fw = fp.shape
    _, _, ch, cw = cp.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for f in (320, 80):
        ip = prm.iparams[:f].contiguous()
        fpar = prm.fparams[:f].contiguous()
        out = torch.empty((f, OUT, OUT, 3), dtype=torch.float32, device=dev)

        def call(fn):
            rc = fn(fp.data_ptr(), nb, fh, fw, cp.data_ptr(), ch, cw,
                    ip.data_ptr(), fpar.data_ptr(), f, exp_warp2.RING,
                    out.data_ptr(), None, stream)
            if rc != 0:
                raise RuntimeError(f"warp_band variant launch failed: CUDA "
                                   f"error {rc}")

        ms = {n: 0.0 for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                ms[n] += device_ms(lambda: call(fns[n]), iters, dev) / 2
        res[f] = ms
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    name = card[0] if card else torch.cuda.get_device_name(0)
    for f, ms in res.items():
        print(f"K3 variants at 16 x 1080p, {f} crops, device ms a call "
              f"(warm) [{name}]:")
        for n, t in ms.items():
            print(f"  {n:10s} {t:.4f}  (full - {n}: {ms['full'] - t:+.4f})")


if __name__ == "__main__":
    main()
