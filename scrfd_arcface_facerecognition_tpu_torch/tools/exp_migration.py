"""The dense -> PQ tier crossing of ``AutoGallery``, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_migration \
        [--rows 1000000 2000000] [--mode sync|async] [--repeat 3] \
        [--device cpu]

Port of the JAX repository's ``tools/exp_migration.py``. When a growing
gallery crosses ``pq_threshold``, the add that tips it over pays for
training the codec on the resident rows, re-encoding every row and
handing the exact rows over: a one-time serving stall, which an operator
sizing ``pq_threshold`` / ``hbm_budget_gb`` needs to know.

``--mode sync`` times ``AutoGallery._migrate`` and the first search after
it. ``--mode async`` measures the opt-in path (``migrate_async=True``): the
triggering add returns at once, the caller keeps calling ``search_batch``
every 0.25 s while the codec trains and the rows re-encode on a background
thread, and the run reports the probes' latencies, the time until the tier
flips and the call that swapped it in. Each probe's top-1 is checked too:
the gallery must keep answering while it migrates.

The card is synchronized where the JAX tool's results were on the host,
so every time is of finished device work. Prints one JSON line a run,
the JAX tool's keys; the async line adds ``probe_top1_self_min`` (the
worst probe's top-1 self) and ``bg_failed`` (the background build
raised). Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from . import synchronize


def make_rows(n_rows: int, d: int = 512, seed: int = 0) -> np.ndarray:
    """Identity-structured unit rows (pure noise under-represents the
    codec's work: k-means converges differently on structure)."""
    rng = np.random.default_rng(seed)
    n_ident = max(64, n_rows // 64)
    centers = rng.normal(size=(n_ident, d)).astype(np.float32)
    mat = centers[rng.integers(0, n_ident, size=n_rows)]
    mat += 0.3 * rng.normal(size=mat.shape).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    return mat


def top1_self(hits) -> int:
    """Queries whose first hit is their own row (query i is row i)."""
    return sum(1 for i, h in enumerate(hits) if h and h[0].id == i)


def run_scale(n_rows: int, d: int = 512, seed: int = 0,
              device=None) -> dict:
    """The synchronous crossing: fill the dense tier, then time
    ``_migrate`` and the first search after it."""
    from ..device import resolve_device
    from ..gallery import AutoGallery

    dev = resolve_device(device)
    mat = make_rows(n_rows, d, seed)
    g = AutoGallery(capacity=n_rows + 8, pq_threshold=1 << 62, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    g.add_batch(np.arange(n_rows, dtype=np.int64), mat)
    synchronize(dev)
    t_fill = time.perf_counter() - t0

    t0 = time.perf_counter()
    g._migrate()                       # the threshold-crossing stall
    synchronize(dev)
    t_migrate = time.perf_counter() - t0
    if g.tier != "pq":
        raise AssertionError(f"tier {g.tier} after the migration")

    q = mat[:16]
    t0 = time.perf_counter()
    hits = g.search_batch(q, k=1)
    t_search = time.perf_counter() - t0
    return {"rows": n_rows, "fill_s": round(t_fill, 1),
            "migrate_s": round(t_migrate, 1),
            "first_search_s": round(t_search, 2),
            "top1_self": f"{top1_self(hits)}/16"}


def run_scale_async(n_rows: int, d: int = 512, seed: int = 0,
                    probe_period_s: float = 0.25, device=None) -> dict:
    """Serve while migrating: trigger the crossing with
    ``migrate_async=True`` and probe search from the caller's side until
    the tier flips."""
    from ..device import resolve_device
    from ..gallery import AutoGallery

    dev = resolve_device(device)
    mat = make_rows(n_rows, d, seed)
    g = AutoGallery(capacity=n_rows + 64, pq_threshold=n_rows,
                    migrate_async=True, device=dev)
    ids = np.arange(n_rows, dtype=np.int64)
    synchronize(dev)
    t0 = time.perf_counter()
    g.add_batch(ids[:-1], mat[:-1])          # below threshold: no trigger
    synchronize(dev)
    t_fill = time.perf_counter() - t0

    q = mat[:16]
    g.search_batch(q, k=1)                   # the first dense search

    t0 = time.perf_counter()
    g.add_batch(ids[-1:], mat[-1:])          # crosses: starts the build
    t_trigger_add = time.perf_counter() - t0

    lat, flip_lat, probe_top1 = [], None, []
    t_start = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        hits = g.search_batch(q, k=1)
        dt = time.perf_counter() - t1
        if g.tier == "pq":
            # this call swapped the build in and ran the first PQ search
            flip_lat = dt
            break
        lat.append(dt)
        probe_top1.append(top1_self(hits))
        if g._bg_failed:
            break
        time.sleep(probe_period_s)
    t_flip = time.perf_counter() - t_start

    top1 = top1_self(hits)
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"mode": "async", "rows": n_rows,
            "fill_s": round(t_fill, 1),
            "trigger_add_s": round(t_trigger_add, 3),
            "time_to_pq_tier_s": round(t_flip, 1),
            "probes_during_migration": len(lat),
            "probe_ms_median": round(lat_ms[len(lat_ms) // 2], 1)
            if lat_ms else None,
            "probe_ms_max": round(lat_ms[-1], 1) if lat_ms else None,
            "swap_call_s": round(flip_lat, 2) if flip_lat is not None
            else None,
            "top1_self": f"{top1}/16",
            "probe_top1_self_min": f"{min(probe_top1)}/16"
            if probe_top1 else None,
            "bg_failed": bool(g._bg_failed)}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[1_000_000, 2_000_000])
    ap.add_argument("--mode", choices=["sync", "async"], default="sync")
    ap.add_argument("--repeat", type=int, default=1,
                    help="repeat each scale; prints every run plus a "
                         "median summary line")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run = run_scale if args.mode == "sync" else run_scale_async
    for n in args.rows:
        stalls = []
        for r in range(args.repeat):
            res = run(n, seed=r, device=args.device)
            print(json.dumps(res), flush=True)
            stalls.append(res.get("migrate_s", res.get("time_to_pq_tier_s")))
        if args.repeat > 1:
            s = sorted(stalls)
            print(json.dumps({
                "summary": args.mode, "rows": n, "runs": len(s),
                "stall_median_s": s[len(s) // 2],
                "stall_min_s": s[0], "stall_max_s": s[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
