"""Concurrent single-image requests through the facade, with and without
request coalescing, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_microbatch \
        [--requests 64] [--threads 16] [--device cpu]

Port of the JAX repository's ``tools/exp_microbatch.py``. The serving
shape: N web-request threads each hold one image and call
``FaceAnalysis.get()`` (the reference handler's pattern). Compared:

- ``batch-1 per request``: every request runs its own batch-1 detect +
  embed call (micro-batching off), so the requests queue on the card;
- ``microbatched``: ``enable_microbatch()``, whose collector groups the
  concurrent requests into shared batches (``runtime.microbatch``).

Each mode runs two rounds over the same images: the first warms cuDNN's
algorithm choice for every batch width the mode uses, the second is
measured (the card synchronized before each clock read). Face crops are
warped by kernel K1 (``csrc/warp_align.cu``) on the card.

Prints the JAX tool's JSON line a mode: ``{"mode", "requests_per_sec",
"threads", "requests"}``, and for the coalesced mode the measured round's
``"batches"`` and ``"widest"``. Runs on the card unless given
``--device cpu``. The JAX tool's ``enable_compile_cache`` is XLA's and has
no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

from . import synchronize

MODES = (("batch-1 per request", False), ("microbatched", True))
MAX_NUM = 4             # faces a request, as the JAX tool asks


def make_images(requests: int, size: int, seed: int = 0) -> list:
    """The JAX tool's request images: ``requests`` seeded (size, size, 3)
    uint8 noise images."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (size, size, 3), np.uint8)
            for _ in range(requests)]


def run_mode(app, images, n_threads: int, microbatch: bool,
             max_wait_ms: float):
    """Two rounds of ``len(images)`` requests from ``n_threads`` threads,
    each request one ``app.get(image, max_num=MAX_NUM)``. Returns
    (requests a second of the second round, its coalescing stats: batches
    and widest, empty without micro-batching, each request's faces in the
    second round)."""
    if microbatch:
        mb = app.enable_microbatch(max_batch=32, max_wait_ms=max_wait_ms)

    def one_round():
        done = [None] * len(images)
        idx_lock = threading.Lock()
        nxt = [0]

        def worker():
            while True:
                with idx_lock:
                    i = nxt[0]
                    if i >= len(images):
                        return
                    nxt[0] += 1
                done[i] = app.get(images[i], max_num=MAX_NUM)

        synchronize(app.device)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        synchronize(app.device)
        dt = time.perf_counter() - t0
        if any(d is None for d in done):
            raise RuntimeError("a request got no answer")
        return len(images) / dt, done

    # round 1 warms every batch width the mode will use; round 2 is the
    # measurement
    one_round()
    warm_batches = mb.n_batches if microbatch else 0
    fps, faces = one_round()
    stats = {}
    if microbatch:
        # the measured round only: cumulative counters would describe
        # twice the requests the line claims
        stats = {"batches": mb.n_batches - warm_batches,
                 "widest": mb.max_batch_seen}
        app.disable_microbatch()
    return fps, stats, faces


def run(requests: int = 64, threads: int = 16, size: int = 640,
        max_wait_ms: float = 4.0, det: str = "det_10g",
        rec: str = "w600k_r50", device=None, app=None,
        emit: Callable[[dict], None] = None) -> dict:
    """Both modes on one facade (``app``, else ``FaceAnalysis(det, rec,
    seed=0, device=device)``): one JSON line a mode to ``emit``. Returns
    {"images": the requests' images, "modes": (line, requests a second
    unrounded, each request's faces) a mode}."""
    from ..apps.face_analysis import FaceAnalysis

    emit = emit or (lambda line: print(json.dumps(line), flush=True))
    if app is None:
        app = FaceAnalysis(det_variant=det, rec_variant=rec, seed=0,
                           device=device)
    images = make_images(requests, size)
    out = []
    for label, micro in MODES:
        fps, stats, faces = run_mode(app, images, threads, micro,
                                     max_wait_ms)
        line = {"mode": label, "requests_per_sec": round(fps, 1),
                "threads": threads, "requests": requests, **stats}
        emit(line)
        out.append((line, fps, faces))
    return {"images": images, "modes": out}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--det", default="det_10g")
    ap.add_argument("--rec", default="w600k_r50")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.requests, args.threads, args.size, args.max_wait_ms, args.det,
        args.rec, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
