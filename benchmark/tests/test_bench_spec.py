"""BENCHMARK.json against the contract's shape, and every name resolving to
its files."""
from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from benchmark import core, counts, harness
from benchmark.reference import standins

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = core.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(SPEC) == TOP_KEYS
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines_use_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w[k] for w in SPEC["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[group]]
        assert len(got) == len(set(got)), group
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    texts = ([c["why"] for c in SPEC["configs"]]
             + [c["source"] for c in SPEC["configs"]]
             + [w["why"] for w in SPEC["workloads"]]
             + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"])
    assert all(line(t) for t in texts)
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    w = core.cell(SPEC, cell)
    cfg = core.read_json(core.config_file(w["config"]))
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (core.ROOT / entry["file"]) == core.config_file(w["config"])
    assert cfg["name"] == w["config"]
    traffic = core.read_json(core.traffic_file(w["traffic"]))
    assert callable(core.driver(traffic["kind"]).run)
    for m in core.per_layer_for(SPEC, cell):
        assert callable(core.reader(m["name"]).read)
    limits = core.read_json(core.limits_file(cell))["limits"]
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in core.end_to_end_for(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = core.per_layer_for(SPEC, cell)
    assert layers and all(m["moves"] in e2e for m in layers)


def tiny_cell(tmp_path, monkeypatch, edit=None):
    """The benchmark copied into a checkout and the harness pointed at it,
    with ``tiny.stream_tiny`` added as files and an entry: configuration
    ``tiny`` (``buffalo_l``'s models as their families cut them, then
    ``edit``), a tiny stream mix and its limits. Returns the copy's folder
    and the spec."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "benchmark")
    base = root / "benchmark"
    cfg = core.read_json(core.config_file("buffalo_l"))
    for part, entry in core.model_entries(cfg).items():
        cfg[part] = standins.small(entry)
    if edit is not None:
        edit(cfg)
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = core.read_json(core.traffic_file("stream_1080p_card"))
    mix.update(frames=2, height=72, width=128, pool=2, gallery_rows=8,
               gallery_near=4, calib_frames=2, judge_share=1.0,
               trace_seconds=0.3)
    (base / "traffic" / "stream_tiny.json").write_text(json.dumps(mix))
    (base / "limits" / "tiny.stream_tiny.json").write_text(
        (base / "limits" / "buffalo_l.stream_1080p_card.json").read_text())
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "tiny.stream_tiny",
                              "config": "tiny", "traffic": "stream_tiny",
                              "chips": 1, "why": "a tiny stream"})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tiny.stream_tiny")
    monkeypatch.setattr(core, "HERE", base)
    return base, spec


def run_tiny(spec, trace=True):
    import torch

    ctx = harness.context(spec, "tiny.stream_tiny", 2 ** 40 + 3, 0.5,
                          trace, torch.device("cpu"), time.perf_counter())
    return harness.run_cell(spec, ctx)


def test_a_cell_of_new_files_and_an_entry_is_picked_up(tmp_path,
                                                       monkeypatch):
    """A configuration, a mix, its limits and a per-layer metric added as
    files, the cell as an entry: the harness runs it and reads the
    metric, no file edited."""
    base, spec = tiny_cell(tmp_path, monkeypatch)
    (base / "metrics" / "frames_seen.tiny.py").write_text(
        "def read(data):\n    return float(data['frames'])\n")
    spec["per_layer"].append({"name": "frames_seen.tiny", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "frames_per_s",
                              "workloads": ["tiny.stream_tiny"]})
    out = run_tiny(spec)
    assert out["correct"]
    assert out["metrics"]["frames_seen.tiny"]["value"] > 0
    assert "detect_ms.stream" not in out["metrics"]


def test_a_model_family_of_a_new_file_is_picked_up(tmp_path, monkeypatch):
    """An embedder family added as a file (the iResNet family's under
    another name) and a configuration naming it: the tiny stream cell runs
    on it, reads correct, and counts the FLOPs of the family it copies,
    no file of the copy edited."""
    embedder = core.read_json(core.config_file("buffalo_l"))["embedder"]
    want = counts.model_flops(standins.small(embedder), (3, 112, 112))

    def rename(cfg):
        cfg["embedder"]["family"] = "iresnet_again"

    base, spec = tiny_cell(tmp_path, monkeypatch, rename)
    models = base / "reference" / "models"
    (models / "iresnet_again.py").write_text(
        (models / f"{embedder['family']}.py").read_text())
    out = run_tiny(spec)
    assert out["correct"], out["checks"]
    assert out["data"]["rec_flops"] == want


def test_a_model_family_without_a_file_stops_at_set_up(tmp_path,
                                                       monkeypatch):
    def rename(cfg):
        cfg["embedder"]["family"] = "no_such_family"

    base, spec = tiny_cell(tmp_path, monkeypatch, rename)
    with pytest.raises(SystemExit) as got:
        run_tiny(spec, trace=False)
    assert str(base / "reference" / "models" / "no_such_family.py") in \
        str(got.value)
