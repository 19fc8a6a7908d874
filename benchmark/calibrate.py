"""The readings the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --first <seed> --seconds 3 --control 3

Runs the cell's program on ``--seeds`` seeds in one process (short
windows, the comparison as a run makes it) and its control (``control.py``)
on ``--control`` seeds, and prints each number of each seed, then the
lower reading (the largest over the program's seeds) and the upper one
(the smallest over the control's). One JSON line a seed; a summary last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import core, harness  # noqa: E402


def program_readings(spec, cell, seed, seconds, device):
    ctx = harness.context(spec, cell, seed, seconds, False, device,
                          time.perf_counter())
    out = harness.run_cell(spec, ctx)
    got = {c["name"]: c["value"] for c in out["checks"]}
    return got, out


def control_readings(spec, cell, seed, device):
    """The control's numbers on ``seed``."""
    import torch

    ctx = harness.context(spec, cell, seed, 1.0, False, device,
                          time.perf_counter())
    kind = ctx.traffic["kind"]
    if kind == "lookup":
        ctx.traffic["precision"] = "hi"
        out = harness.run_cell(spec, ctx)
        return {c["name"]: c["value"] for c in out["checks"]}
    from benchmark import control
    from benchmark.drivers import stream

    cfg, traffic = ctx.config, ctx.traffic
    sd = stream.seeds(seed)
    with torch.no_grad():
        pool = stream.frame_pool(traffic, sd["frames"], device)
        det_ref, rec_ref, faces = stream.reference_models(cfg, traffic, sd,
                                                          pool, device)
        rows = stream.gallery_rows(traffic, faces, sd["gallery"], device)
        outs = control.stream_control(det_ref, rec_ref, pool, rows, cfg)
        res = stream.judge_batches(torch, cfg, pool, outs, rows, det_ref,
                                   rec_ref, device)
    return {k: res[k] for k in stream.CHECKS + ("face_parts",
                                                "geometry_quantiles")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    spec = core.load_spec()
    cell = core.cell(spec, args.workload)
    torch = core.check_card(cell["chips"])
    dev = torch.device("cuda")
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        got, out = program_readings(spec, args.workload, seed, args.seconds,
                                    dev)
        print(json.dumps({"side": "program", "seed": seed, **got,
                          "metrics": out["metrics"],
                          "notes": out["stderr"][:-len(got)]}), flush=True)
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)
        torch.cuda.empty_cache()
    for i in range(args.control):
        seed = args.first + 104729 * (i + 1)
        got = control_readings(spec, args.workload, seed, dev)
        print(json.dumps({"side": "control", "seed": seed, **got}),
              flush=True)
        for k, v in got.items():
            if k in lower:
                upper[k] = min(upper.get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"cell": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
