"""One run of one cell, from its names to the result line.

``run_cell`` resolves the cell's configuration, traffic, driver and
metric readers by name, runs the driver, reads the per-layer metrics of a
traced run, and returns the result and the lines to print. ``run.py``
calls it on the card; the tests call it on the CPU at small sizes.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional

from benchmark import core


@dataclasses.dataclass
class Context:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float


def context(spec: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, device, started: float) -> Context:
    """The cell's names resolved to their files; a model family with no
    file stops the run here, before anything is drawn."""
    w = core.cell(spec, cell_name)
    config = core.read_json(core.config_file(w["config"]))
    for entry in core.model_entries(config).values():
        core.family(entry["family"])
    return Context(cell=cell_name, config=config,
                   traffic=core.read_json(core.traffic_file(w["traffic"])),
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   started=started)


def per_layer(spec: dict, ctx: Context, data: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    out = {}
    for m in core.per_layer_for(spec, ctx.cell):
        value = core.reader(m["name"]).read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(spec: dict, ctx: Context, metrics: Dict) -> Dict[str, Dict]:
    return {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
            for m in core.end_to_end_for(spec, ctx.cell)}


def run_cell(spec: dict, ctx: Context, device_info=None) -> Dict:
    """Run the cell: {"line": the result's JSON line, "stderr": the lines
    for standard error (the compared numbers last), "correct": bool}."""
    res = core.driver(ctx.traffic["kind"]).run(ctx)
    metrics = (per_layer(spec, ctx, res["data"]) if ctx.trace
               else end_to_end(spec, ctx, res["metrics"]))
    checks: List[Dict] = res["checks"]
    correct = core.judged(checks)
    device = (device_info(res["peak_bytes"]) if device_info is not None
              else {"platform": ctx.device.type, "kind": str(ctx.device),
                    "count": 1, "memory_peak_bytes": res["peak_bytes"]})
    breakdown: Optional[Dict] = None
    tr = res["data"].get("trace")
    if ctx.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    stderr = list(res["notes"])
    stderr += [f"check {c['name']} {c['value']!r} limit {c['limit']!r}"
               for c in checks]
    line = core.result_line(correct, res["attempted"], res["failed"],
                            metrics, device, checks, breakdown)
    return {"line": line, "stderr": stderr, "correct": correct,
            "metrics": metrics, "checks": checks, "data": res["data"]}


def emit(out: Dict) -> int:
    """Print a run's lines; refuse the result when a forbidden module was
    loaded. Returns the exit code."""
    found = core.forbidden_loaded()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(out["line"], flush=True)
    return 0
