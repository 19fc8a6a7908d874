"""What every cell shares: the benchmark's file, names, seeds, the card,
statistics and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; both
are found by name (``configs/<config>.json``, ``traffic/<traffic>.json``),
the traffic's ``kind`` picks its driver (``drivers/<kind>.py``), each
model entry of the configuration its family's reference
(``reference/models/<family>.py``), and every per-layer metric is read by
``metrics/<name>.py``. A new cell, mix, configuration, model family or
metric is a new file and an entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_PATH = ROOT / "BENCHMARK.json"
# whole top-level module names the benchmark's process must never load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax",
                     "scrfd_arcface_facerecognition_tpu")


def load_spec(path: Path = SPEC_PATH) -> dict:
    return read_json(path)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file, by path: the files
    of metrics are named after the metric, dots included."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py",
                       f"benchmark_driver_{kind}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))


def family_file(name: str) -> Path:
    return HERE / "reference" / "models" / f"{name}.py"


_family_modules: Dict[Path, object] = {}


def family(name: str):
    """The reference module of a model family (``reference/standins.py``
    says what it holds), loaded once a path; SystemExit, naming the path,
    where it has no file."""
    path = family_file(name)
    if path not in _family_modules:
        if not path.is_file():
            raise SystemExit(f"no model family {name!r}: expected {path}")
        _family_modules[path] = load_module(path, f"benchmark_family_{name}")
    return _family_modules[path]


def model_entries(config: dict) -> Dict[str, dict]:
    """The configuration's model entries: its values that name a
    ``family``."""
    return {k: v for k, v in config.items()
            if isinstance(v, dict) and "family" in v}


def end_to_end_for(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_for(spec: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those whose ``workloads``
    list it."""
    return [m for m in spec["per_layer"] if cell_name in m["workloads"]]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: the
    same pair always gives the same number, and tags do not collide."""
    words = [seed & 0xFFFFFFFF, seed >> 32] + list(tag.encode())
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def tail(values: Sequence[float], q: float = 0.95) -> float:
    """The nearest-rank ``q`` quantile: the smallest value with at least
    ``q`` of all values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    return s[max(0, math.ceil(q * len(s)) - 1)]


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def check_card(chips: int):
    """The card the cell asks for, or SystemExit: the benchmark never runs
    on the CPU. Returns torch."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card "
                         "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN_MODULES})


def device_info(torch, count: int, peak_bytes: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def setup_said(started: float, marks) -> str:
    """Set-up's seconds by step: ``marks`` are (step, clock at its end),
    the first one the driver's start."""
    parts = [f"process start to driver {marks[0][1] - started:.2f}"]
    parts += [f"{name} {t - marks[i][1]:.2f}"
              for i, (name, t) in enumerate(marks[1:])]
    return "set-up s: " + ", ".join(parts)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                checks: List[Dict], breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output; the compared numbers come last,
    each beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": plain(c["value"]),
                                 "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def plain(x):
    """A number JSON can carry: a non-finite float as its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def judged(checks: List[Dict]) -> bool:
    """Every number within its limit (a NaN is never within)."""
    return all(c["value"] <= c["limit"] for c in checks)
