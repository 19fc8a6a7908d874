"""Driver of the lookup mixes (``"kind": "lookup"``): batches of query
embeddings through ``PQGallery.search``, one client, closed loop.

Set-up, all from the run's seed and on the card: the codebooks (M x K
centroids of dimension D / M, N(0, 1 / D) entries, so a decoded row has
norm about 1); ``identities`` prototype codes; every row a prototype
drawn at random with a share (``changed_share``) of its sub-codes drawn
anew, so an identity's rows differ in a few sub-codes; a pool of lookups,
each ``queries`` embeddings near a random row's decoded code
(``query_noise`` of Gaussian noise, normalised). The codes are written
into the gallery's storage directly, as the repository's phase 23a of
``chip_smoke.py`` does: the port has no public call that takes codes, and
its host fill (encoding embeddings) runs at some 66,000 rows a second.

The window: ``search(queries, k, precision)`` over the pool's lookups in
turn until ``seconds`` have passed, each ending with the ids and scores
on the host. A lookup's latency is the device-clock time between CUDA
events recorded at the call and after it returned: the card is idle at
both (the previous lookup ended with its copy to the host), so the events
mark the call's start and end at the device clock's resolution. Every
answer is kept for the comparison.

Traced runs add CUDA events around the gallery's stages for the whole
window (the port's stage hook), then a profiled slice of the same traffic.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark import compare, core, counts, trace
from benchmark.drivers.stream import StageClock
from benchmark.reference import pq as ref_pq


def seeds(seed: int) -> Dict[str, int]:
    return {t: core.sub_seed(seed, t) for t in ("codebook", "codes",
                                                 "queries")}


def codebook(traffic: dict, dim: int, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    m, k = traffic["m"], traffic["k"]
    return torch.randn((m, k, dim // m), generator=gen,
                       device=device) / dim ** 0.5


def gallery_codes(traffic: dict, seed: int, device, block: int = 1 << 20):
    """(rows, M) u8 codes: each row an identity's prototype with a share
    of its sub-codes drawn anew."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    m, k, g = traffic["m"], traffic["k"], traffic["rows"]
    proto = torch.randint(0, k, (traffic["identities"], m), generator=gen,
                          dtype=torch.uint8, device=device)
    codes = torch.empty((g, m), dtype=torch.uint8, device=device)
    for r0 in range(0, g, block):
        n = min(block, g - r0)
        ident = torch.randint(0, traffic["identities"], (n,), generator=gen,
                              device=device)
        fresh = torch.randint(0, k, (n, m), generator=gen, dtype=torch.uint8,
                              device=device)
        change = torch.rand((n, m), generator=gen, device=device) \
            < traffic["changed_share"]
        codes[r0:r0 + n] = torch.where(change, fresh, proto[ident])
    return codes


def query_pool(traffic: dict, centroids, codes, seed: int, device):
    """(pool, Q, D) float32 unit queries, each near a random row's decoded
    code (so near an enrolled identity)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    p, q = traffic["pool"], traffic["queries"]
    m, _, s = centroids.shape
    rows = torch.randint(0, codes.shape[0], (p * q,), generator=gen,
                         device=device)
    sub = torch.arange(m, device=device)
    dec = centroids[sub[None], codes[rows].long()].reshape(p * q, m * s)
    x = dec + traffic["query_noise"] * torch.randn(
        dec.shape, generator=gen, device=device) / (m * s) ** 0.5
    return torch.nn.functional.normalize(x, dim=1).reshape(p, q, m * s)


def program(centroids, codes, device):
    """The port's PQGallery holding ``codes`` (every row valid, ids the row
    numbers)."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery.pq import (
        PQCodec, PQGallery)

    gal = PQGallery(PQCodec(centroids.contiguous()), capacity=len(codes),
                    device=device)
    gal._shards.rows[0].copy_(codes)
    gal._shards.valid[0].fill_(True)
    gal._ids[:] = np.arange(len(codes))
    gal._free = []
    return gal


def window(gal, pool: List[np.ndarray], seconds: float, traffic: dict,
           torch, card: bool) -> Dict:
    """Closed loop over the pool's lookups for ``seconds``."""
    answers = []
    marks = []
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        i = len(answers)
        if card:
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
        t = time.perf_counter()
        scores, ids = gal.search(pool[i % len(pool)], k=traffic["top_k"],
                                 precision=traffic["precision"])
        if card:
            e_ev.record()
            marks.append((s_ev, e_ev))
        else:
            marks.append(time.perf_counter() - t)
        answers.append((scores, ids))
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    latency = [s.elapsed_time(e) / 1e3 for s, e in marks] if card else marks
    return {"answers": answers, "seconds": seconds, "latency": latency}


def judge(torch, traffic: dict, centroids, codes, pool_dev, answers,
          device) -> Dict:
    """Every answer against the reference's float64 scores."""
    worst = 0.0
    refs = {}
    for i, (scores, ids) in enumerate(answers):
        p = i % len(pool_dev)
        if p not in refs:
            table = ref_pq.lut(pool_dev[p], centroids)
            refs[p] = (table, ref_pq.top(table, codes, traffic["top_k"]))
        table, top = refs[p]
        rows = torch.from_numpy(np.asarray(ids)).to(device)
        at = ref_pq.at(table, codes, rows)
        gaps = compare.lookup_gaps(torch.from_numpy(np.asarray(scores)).to(
            device), rows, at, top, codes.shape[0])
        worst = max(worst, compare.worst(gaps))
    return {"lookup_gap": worst, "lookups": len(answers)}


def run(ctx) -> Dict:
    """One run of a lookup cell; see the module's note."""
    import torch

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    card = dev.type == "cuda"
    sd = seeds(ctx.seed)
    dim = cfg["embedder"]["emb"]
    marks = [("start", time.perf_counter())]
    centroids = codebook(traffic, dim, sd["codebook"], dev)
    codes = gallery_codes(traffic, sd["codes"], dev)
    pool_dev = query_pool(traffic, centroids, codes, sd["queries"], dev)
    pool = [q.cpu().numpy() for q in pool_dev]
    marks.append(("codes + queries", time.perf_counter()))
    gal = program(centroids, codes, dev)
    marks.append(("gallery", time.perf_counter()))
    del codes                       # drawn again to judge
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for q in pool[:3]:
        gal.search(q, k=traffic["top_k"], precision=traffic["precision"])
    if card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - ctx.started

    clock = None
    if ctx.trace:
        from scrfd_arcface_facerecognition_tpu_torch import stages

        clock = StageClock(torch, dev)
        stages.set_stage_hook(clock)
    try:
        w = window(gal, pool, ctx.seconds, traffic, torch, card)
    finally:
        if clock is not None:
            stages.set_stage_hook(None)
    n = len(w["answers"])
    q = traffic["queries"]
    data = {"lookups": n, "window_s": w["seconds"]}
    if clock is not None:
        data["stage_ms"] = clock.totals_ms()
        data["trace"] = trace.traced(torch, lambda: window(
            gal, pool, traffic["trace_seconds"], traffic, torch, card), dev)
        data["k2_bound_s"] = counts.k2_bound(q, traffic["m"], traffic["k"],
                                             traffic["rows"],
                                             traffic["precision"])[0]
        data["lookup_bound_s"] = counts.lookup_bound(
            q, dim, traffic["m"], traffic["k"], traffic["rows"])
    peak = torch.cuda.max_memory_allocated() if card else 0
    del gal
    if card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    codes = gallery_codes(traffic, sd["codes"], dev)
    res = judge(torch, traffic, centroids, codes, pool_dev, w["answers"],
                dev)
    t_ref = time.perf_counter() - t_ref
    lim = core.read_json(core.limits_file(ctx.cell))["limits"]
    checks = [compare.check("lookup_gap", res["lookup_gap"],
                            lim["lookup_gap"])]
    metrics = {"queries_per_s": core.rate(n * q, w["seconds"]),
               "lookup_p95_ms": core.tail(w["latency"]) * 1e3,
               "setup_s": setup_s}
    notes = [core.setup_said(ctx.started, marks),
             f"lookups in the window {n} ({n * q} queries), all judged, "
             f"window {w['seconds']:.3f} s, the comparison {t_ref:.2f} s"]
    return {"metrics": metrics, "data": data, "checks": checks,
            "attempted": n, "failed": 0, "peak_bytes": peak, "notes": notes}
