"""The top device ops of a traced model forward, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.trace_ops \
        [--what backbone|full|embed] [--batch 32] [--iters 5] [--top 30] \
        [--dir DIR] [--device cpu]

Port of the JAX repository's ``tools/trace_ops.py``: the JAX tool's
models and shapes (det_10g's backbone or the whole det_10g at bf16 on B x
640 x 640, or w600k_r50 at bf16 on 320 crops, ``--batch`` aside as
there), the wall ms an iteration (CUDA events over ``--iters`` calls),
then ``--iters`` iterations traced with ``utils.profiling.trace`` into
``--dir`` (default ``torch_trace`` under the system's temp directory).
``summarize_trace`` reads the Chrome trace back: on the card it sums the
device events (CUDA kernels, memcpy and memset) by name and prints the
total, then the top ``--top`` with their ms and share, in the JAX tool's
format; a trace with no device event is an error (CUPTI saw nothing). With
``--device cpu`` it sums the CPU op events instead, and says so.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
from typing import Callable, Dict, Optional

import numpy as np

from . import card_line, device_ms

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op",)
EMBED_CROPS = 320


def default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "torch_trace")


def latest_trace(trace_dir: str) -> Optional[str]:
    """The newest Chrome trace (``*.json`` or ``*.json.gz``) under
    ``trace_dir``."""
    files = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    return max(files, key=os.path.getmtime) if files else None


def summarize_trace(trace_dir: str, top: int = 30, device: bool = True,
                    emit: Callable[[str], None] = print) -> Dict:
    """Sum the newest trace's device events (``device``; else its CPU op
    events) by name and print the total and the top ``top``. Returns
    {"path", "total_ms", "top": [(name, ms, share %)]}; raises when the
    trace holds no such event."""
    path = latest_trace(trace_dir)
    if path is None:
        raise RuntimeError(f"trace_ops: no trace file under {trace_dir}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    cats = DEVICE_CATS if device else CPU_CATS
    agg: Dict[str, float] = {}
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        agg[name] = agg.get(name, 0.0) + dur
        total += dur
    if not agg:
        raise RuntimeError(
            f"trace_ops: {os.path.basename(path)} holds no "
            f"{'device' if device else 'CPU op'} event ({', '.join(cats)})")
    what = "device-op" if device else "CPU-op (--device cpu)"
    emit(f"trace {os.path.basename(path)}: {total / 1e3:.2f} ms total "
         f"{what} time")
    rows = []
    for name, dur in sorted(agg.items(), key=lambda kv: -kv[1])[:top]:
        share = 100 * dur / max(total, 1)
        rows.append((name, dur / 1e3, share))
        emit(f"  {dur / 1e3:9.3f} ms  {share:5.1f}%  {name[:110]}")
    return dict(path=path, total_ms=total / 1e3, top=rows)


def make_model(what: str, batch: int, device):
    """The JAX tool's model and input for ``what``: (module, input)."""
    import torch

    from ..models.init_utils import seeded_init_
    from ..models.scrfd import SCRFD_CONFIGS, SCRFDNet
    from ..models import build_arcface

    rng = np.random.default_rng(0)
    if what in ("backbone", "full"):
        net = SCRFDNet(SCRFD_CONFIGS["det_10g"], dtype=torch.bfloat16)
        seeded_init_(net, 0)
        model = net.backbone if what == "backbone" else net
        x = rng.normal(size=(batch, 640, 640, 3))
    elif what == "embed":
        model = build_arcface("w600k_r50", dtype=torch.bfloat16)
        seeded_init_(model, 0)
        x = rng.normal(size=(EMBED_CROPS, 112, 112, 3))
    else:
        raise SystemExit(f"unknown --what {what}")
    x = torch.from_numpy(np.ascontiguousarray(
        x.astype(np.float32).transpose(0, 3, 1, 2))).to(device)
    return model.eval().requires_grad_(False).to(device), x


def run(what: str = "backbone", batch: int = 32, iters: int = 5,
        top: int = 30, trace_dir: Optional[str] = None, device=None,
        emit: Callable[[str], None] = print) -> Dict:
    """The wall ms an iteration, then the traced iterations' summary:
    ``summarize_trace``'s dict with "wall_ms"."""
    import torch

    from ..device import resolve_device
    from ..utils.profiling import sync, trace

    dev = resolve_device(device)
    trace_dir = trace_dir or default_dir()
    model, x = make_model(what, batch, dev)
    with torch.inference_mode():
        wall = device_ms(lambda: model(x), iters, dev)
        emit(f"wall: {wall:.2f} ms/iter")
        with trace(trace_dir):
            for _ in range(iters):
                out = model(x)
            sync(out)
    res = summarize_trace(trace_dir, top, device=dev.type == "cuda",
                          emit=emit)
    res["wall_ms"] = wall
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="backbone")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--dir", default=default_dir())
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    print(f"card: {card_line(dev)}")
    run(args.what, args.batch, args.iters, args.top, args.dir, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
