"""The PQ gallery at 10M identities, the scale its tier exists for.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_pq_scale \
        [--g 10000000] [--q 16] [--q-sweep 16,64,128,256] [--k 5] \
        [--dense-g 2000000] [--device cpu]

Port of the JAX repository's ``tools/exp_pq_scale.py``. A dense f32
matrix of 10M x 512 rows takes 20 GB of device memory; the PQ codes of
the same rows take 10M x 64 B = 640 MB. This measures the tier there:

- the fill rate of a G-row ``PQGallery`` (codec trained on
  ``CODEC_TRAIN_ROWS`` random unit rows), chunk by chunk, to a synchronized
  finish; the line adds the seconds spent making the rows on the host and
  in ``PQGallery.add`` (encoding and the scatter);
- the search ms over a query-batch sweep in both LUT precisions, median
  of 5, with K2 named ``pq_adc``; each line adds one stage-timed search's
  split (``pq_lut``, ``pq_adc``, ``pq_topk`` of ``stages.GALLERY_STAGES``,
  synchronized) and, on the card, the peak device memory of the searches;
- a dense search of ``--dense-g`` rows for context: an f32 matmul without
  TF32, then the stable top-k, as ``GalleryStore`` searches;
- recall@k on identity-structured rows (intra-identity cosine about 0.7),
  ADC alone and with an exact rerank of 100, against the dense top-k, and
  the share of queries whose top-1 has their identity.

Prints the JAX tool's JSON lines. Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np

from . import synchronize

CODEC_TRAIN_ROWS = 100_000   # the JAX tool's codec size (both codecs)


def median_time(fn, rounds: int = 5) -> float:
    """Median seconds of ``rounds`` calls of fn (which returns host data,
    so each call ends with the device's work)."""
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def unit_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 512) random unit rows: the JAX tool's draws."""
    x = rng.normal(size=(n, 512)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


class StageSeconds:
    """A stage hook (``stages.set_stage_hook``) that sums each stage's
    seconds, the device synchronized at both ends."""

    def __init__(self, dev):
        self.dev = dev
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, name):
        synchronize(self.dev)
        t = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.dev)
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


def stage_split(dev, fn) -> dict:
    """Seconds of each gallery stage over one call of fn."""
    from .. import stages

    timer = StageSeconds(dev)
    stages.set_stage_hook(timer)
    try:
        fn()
    finally:
        stages.set_stage_hook(None)
    return timer.s


def dense_search(q, emb, k: int):
    """Top-k of the f32 products without TF32, ties by lower row: the
    dense tier's search (``GalleryStore._topk`` without its mask)."""
    from ..device import full_f32_matmul
    from ..ops import stable_top_k

    with full_f32_matmul():
        sims = q @ emb.T
    return stable_top_k(sims, k)


def fill(g, rng, n: int, chunk: int):
    """Add n random unit rows (ids 0..n-1) in ``chunk``-row blocks to g;
    returns (seconds making rows, seconds in g.add), the last synchronized."""
    make_s = add_s = 0.0
    filled = 0
    while filled < n:
        m = min(chunk, n - filled)
        t = time.perf_counter()
        rows = unit_rows(rng, m)
        make_s += time.perf_counter() - t
        t = time.perf_counter()
        g.add(np.arange(filled, filled + m), rows)
        add_s += time.perf_counter() - t
        filled += m
    t = time.perf_counter()
    synchronize(g.device)
    return make_s, add_s + time.perf_counter() - t


def run(g: int = 10_000_000, q: int = 16, q_sweep: Sequence[int] = (),
        k: int = 5, m: int = 64, chunk: int = 500_000,
        dense_g: int = 2_000_000, device=None,
        emit: Callable[[dict], None] = None,
        inspect: Callable = None) -> dict:
    """Every measurement of the tool, each line to ``emit``.

    ``inspect(gallery, queries)``, when given, is called after each swept
    query batch's searches, with the 10M-row gallery still resident.
    Returns the figures: fill, sweep (one dict a (Q, precision)), dense_ms,
    recall (one dict a mode; ``top1_hits`` of the queries, of which
    ``identity_present`` have their identity among the gallery's rows)."""
    import torch

    from ..device import resolve_device
    from ..gallery.pq import PQCodec, PQGallery

    emit = emit or (lambda line: print(json.dumps(line), flush=True))
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = dict(sweep=[], recall=[])

    emit({"note": "training codec", "m": m})
    codec = PQCodec.train(unit_rows(rng, CODEC_TRAIN_ROWS), m=m, device=dev)

    gal = PQGallery(codec, capacity=g, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    make_s, add_s = fill(gal, rng, g, chunk)
    fill_s = time.perf_counter() - t0
    out["fill"] = dict(rows_per_s=g / fill_s, seconds=fill_s,
                       make_rows_s=make_s, add_s=add_s)
    emit({"metric": f"pq_fill_rate (encode+scatter, G={g})",
          "value": round(g / fill_s, 0), "unit": "rows/sec",
          "make_rows_s": round(make_s, 2), "add_s": round(add_s, 2)})

    codes_mb = g * m / 1e6
    for qn in (list(q_sweep) or [q]):
        qs = unit_rows(rng, qn)
        for prec in ("hilo", "hi"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            resident = (torch.cuda.memory_allocated(dev)
                        if dev.type == "cuda" else None)
            _, ids = gal.search(qs, k=k, precision=prec)      # warm
            if not (ids >= 0).all():
                raise AssertionError(
                    f"PQ search (Q={qn}, {prec}) returned an id < 0")
            dt = median_time(lambda: gal.search(qs, k=k, precision=prec))
            split = stage_split(dev, lambda: gal.search(qs, k=k,
                                                        precision=prec))
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None)
            row = dict(q=qn, precision=prec, ms=dt * 1e3,
                       per_query_ms=dt * 1e3 / qn,
                       stage_ms={s: v * 1e3 for s, v in split.items()},
                       peak_bytes=peak, resident_bytes=resident,
                       min_id=int(ids.min()))
            out["sweep"].append(row)
            emit({"metric": f"pq_adc_search_ms (G={g}, Q={qn}, top-{k}, "
                            f"pq_adc/{prec}, codes {codes_mb:.0f} MB; "
                            f"dense f32 would need "
                            f"{g * 512 * 4 / 1e9:.0f} GB HBM)",
                  "value": round(dt * 1000, 2), "unit": "ms",
                  "per_query_ms": round(dt * 1000 / qn, 3),
                  "stage_ms": {s: round(v, 3)
                               for s, v in row["stage_ms"].items()},
                  "peak_device_gb": None if peak is None
                  else round(peak / 1e9, 3)})
        if inspect is not None:
            inspect(gal, qs)
    q_rec = unit_rows(rng, q)

    if dense_g:
        # the dense search for context (the tier-crossover reference)
        del gal
        rows = unit_rows(rng, dense_g)
        emb = torch.from_numpy(rows).to(dev)
        qd = torch.from_numpy(q_rec).to(dev)
        dense_search(qd, emb, k)[0].cpu()
        dt2 = median_time(lambda: dense_search(qd, emb, k)[0].cpu())
        out["dense_ms"] = dt2 * 1e3
        emit({"metric": f"dense_matmul_search_ms (G={dense_g}, "
                        f"{dense_g * 512 * 4 / 1e9:.1f} GB HBM)",
              "value": round(dt2 * 1000, 2), "unit": "ms"})
        del emb, rows

        # recall on identity-structured rows (many views a person,
        # intra-person cosine about 0.7: what a face gallery holds;
        # i.i.d. unit vectors are PQ's worst case, not the workload)
        n_ident = max(dense_g // 4, 1)
        centers = unit_rows(rng, n_ident)
        ident = rng.integers(0, n_ident, size=dense_g)
        # per-coordinate sigma for cos ~ 1 / (1 + 512 s^2) = 0.7
        sig = float(np.sqrt((1 / 0.7 - 1) / 512))
        rows = centers[ident] + sig * rng.normal(
            size=(dense_g, 512)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q_ident = rng.integers(0, n_ident, size=q)
        qc = centers[q_ident] + sig * rng.normal(
            size=(q, 512)).astype(np.float32)
        qc /= np.linalg.norm(qc, axis=1, keepdims=True)

        emb = torch.from_numpy(rows).to(dev)
        exact_ids = dense_search(torch.from_numpy(qc).to(dev), emb,
                                 k)[1].cpu().numpy()
        del emb
        codec_c = PQCodec.train(rows[:CODEC_TRAIN_ROWS], m=m, device=dev)
        gr = PQGallery(codec_c, capacity=dense_g, keep_exact=True,
                       device=dev)
        filled = 0
        while filled < dense_g:
            n = min(chunk, dense_g - filled)
            gr.add(np.arange(filled, filled + n), rows[filled:filled + n])
            filled += n
        # queries whose identity has a row in the gallery (an identity
        # draws about 4 of its rows; one in e^4 draws none)
        present = int(np.isin(q_ident, ident).sum())
        for label, kw in (("adc", {}), ("rerank=100", {"rerank": 100})):
            _, pq_ids = gr.search(qc, k=k, **kw)
            hits = sum(len(set(pq_ids[i]) & set(exact_ids[i]))
                       for i in range(q))
            ident_hits = sum(ident[pq_ids[i][0]] == q_ident[i]
                             for i in range(q))
            out["recall"].append(dict(label=label, recall=hits / (q * k),
                                      top1_same_identity=ident_hits / q,
                                      top1_hits=int(ident_hits),
                                      identity_present=present))
            emit({"metric": f"pq_recall_at_{k} ({label}, G={dense_g}, "
                            f"{n_ident} identities, m={m})",
                  "value": round(hits / (q * k), 4), "unit": "recall",
                  "top1_same_identity": round(ident_hits / q, 4)})
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g", type=int, default=10_000_000)
    ap.add_argument("--q", type=int, default=16,
                    help="query batch of the recall study")
    ap.add_argument("--q-sweep", type=str, default="",
                    help="comma list of query-batch sizes to time at --g "
                         "(e.g. 16,64,128,256)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=500_000,
                    help="host-side fill chunk (bounds host memory: "
                         "chunk x 512 x 8 B while the rows are drawn)")
    ap.add_argument("--dense-g", type=int, default=2_000_000,
                    help="dense search size (0 skips it and the recall "
                         "study)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sweep = [int(x) for x in args.q_sweep.split(",")] if args.q_sweep else []
    run(args.g, args.q, sweep, args.k, args.m, args.chunk, args.dense_g,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
