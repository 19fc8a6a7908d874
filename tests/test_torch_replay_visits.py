"""The port's ``tools/replay_visits.py`` against the JAX repository's
``tools/replay_visits.py``, both ``main``s run in this process on the CPU.

A synthetic visits JSON of 10 visits and an md5(url).jpg image cache
written with cv2, 3 of the visits missing from it. Both packages'
``FaceAnalysis`` are wrapped to take the committed det_500m + w600k_mbf
trees at f32, so the two engines decide with equal weights (the tools'
default models, det_10g + w600k_r50, are seeded differently in the two
packages). The JAX tool's compile cache is a no-op here (it would write
``.jax_cache/`` into the repository) and its ``os.chdir`` is undone by
``monkeypatch.chdir``. Held equal: the results dict, the JSON line's keys,
the SQLite rows (without the clock's columns) and the
``clustering_results_*.json`` payloads without their clock fields; the
similarities and quality scores in them within 1e-5 (the persons'
``face_hash``, an md5 of the embedding's float32 bytes, is left out: the
embeddings agree within the f32 budget, not bit for bit).
"""
import glob
import importlib.util
import json
import os
import sqlite3
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
from scrfd_arcface_facerecognition_tpu.apps import (  # noqa: E402
    face_analysis as jfa)
from scrfd_arcface_facerecognition_tpu.utils import compile_cache
from scrfd_arcface_facerecognition_tpu_torch.apps import face_analysis as tfa
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    exp_decisions as tx, replay_visits as rv)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

TOL = 1e-5
# an md5 of the embedding's float32 bytes: the two packages' embeddings
# agree within the f32 budget, not bit for bit
UNSTABLE = ("face_hash",)
N_VISITS, MISSES = 10, (2, 5, 9)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _workload(root):
    """(visits.json path, cache dir): 10 visits of 4 synthetic identities,
    the cached ones cv2-written md5(url).jpg scenes."""
    crops, _ = tx.synthetic_crops(4, 3)
    rng = np.random.default_rng(3)
    cache = os.path.join(root, "cache")
    os.makedirs(cache)
    visits = []
    for i in range(N_VISITS):
        url = f"http://replay/visit{i:03d}.jpg"
        visits.append({"id": f"r{i:03d}", "customerId": f"c{i:03d}",
                       "entryTime": "2026-08-19T12:00:00", "image": url})
        if i not in MISSES:
            img = tx.make_scene(rng, crops[i % 4])[0]
            assert cv2.imwrite(os.path.join(cache, rv.cache_name(url)), img)
    path = os.path.join(root, "visits.json")
    with open(path, "w") as f:
        json.dump({"visits": visits}, f)
    return path, cache


def _record(workdir):
    """The run's decisions without the clock: SQLite's rows and the
    clustering_results payloads."""
    con = sqlite3.connect(os.path.join(workdir, "replay.db"))
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name "
            "NOT LIKE 'sqlite_%' ORDER BY name")]
        db = {}
        for t in tables:
            cur = con.execute(f"SELECT * FROM {t} ORDER BY rowid")
            cols = [d[0] for d in cur.description]
            db[t] = [{k: v for k, v in chip_smoke.without_clock(
                dict(zip(cols, row))).items() if k not in UNSTABLE}
                     for row in cur]
    finally:
        con.close()
    payloads = []
    for f in sorted(glob.glob(os.path.join(workdir, "results",
                                           "clustering_results_*.json"))):
        with open(f) as fh:
            p = json.load(fh)
        p.pop("job_id", None)
        p.pop("timestamp", None)
        payloads.append(chip_smoke.without_clock(p))
    return {"db": db, "json": payloads}


def test_replay_matches_jax(monkeypatch, tmp_path, capsys):
    visits_json, cache = _workload(str(tmp_path))
    dv, ev, _ = tx.load_checkpoints()
    built = []

    def committed(base, **fixed):
        def make(det_variant="det_10g", rec_variant="w600k_r50", **kw):
            built.append((base.__module__, det_variant, rec_variant))
            return base(det_variant="det_500m", rec_variant="w600k_mbf",
                        det_variables=dv, rec_variables=ev, **fixed)
        return make

    monkeypatch.setattr(jfa, "FaceAnalysis",
                        committed(jfa.FaceAnalysis, dtype=jnp.float32))
    monkeypatch.setattr(tfa, "FaceAnalysis",
                        committed(tfa.FaceAnalysis, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.chdir(tmp_path)
    jt = _jax_tool("replay_visits")
    argv = ["--max-visits", "12", "--visits-json", visits_json,
            "--image-cache", cache]
    monkeypatch.setattr(sys, "argv", ["replay_visits.py"] + argv + [
        "--workdir", str(tmp_path / "jax")])
    capsys.readouterr()
    jres = jt.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.chdir(tmp_path)
    tres = rv.main(argv + ["--workdir", str(tmp_path / "port"),
                           "--device", "cpu"])
    tline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.getcwd() == str(tmp_path / "port")    # main's own chdir
    assert built == [(jfa.__name__, "det_10g", "w600k_r50"),
                     (tfa.__name__, "det_10g", "w600k_r50")]
    assert tres == jres
    assert list(tline) == list(jline)
    assert tline["results"] == jline["results"]
    assert tline["visits_handled"] == jline["visits_handled"] == N_VISITS
    assert tres["download_failed"] == len(MISSES)
    assert tres["processed"] == tres["recognized"] + tres["new_persons"]
    assert tres["processed"] >= 3, tres        # not vacuous
    jrec, trec = _record(jline["workdir"]), _record(tline["workdir"])
    assert len(trec["db"]["persons"]) == tres["new_persons"]
    assert trec["json"], "the run writes its clustering_results"
    assert chip_smoke.record_diff(trec, jrec, TOL) is None, \
        chip_smoke.record_diff(trec, jrec, TOL)
    assert os.path.isdir(os.path.join(tline["workdir"], "image_cache"))


def test_run_keeps_the_callers_directory(tmp_path, monkeypatch):
    """``run`` (the chip phase's entry) neither changes the working
    directory nor writes outside ``workdir``; ``cached_loader`` serves
    md5(url).jpg and None for a miss."""
    visits_json, cache = _workload(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    before = sorted(os.listdir(tmp_path))
    loader = rv.cached_loader(cache)
    with open(visits_json) as f:
        visits = json.load(f)
    assert loader(visits["visits"][MISSES[0]]["image"]) is None
    img = loader(visits["visits"][0]["image"])
    assert img.shape == (320, 320, 3) and img.dtype == np.uint8
    dv, ev, _ = tx.load_checkpoints()
    app = tx.build_app(dv, ev, device="cpu")
    out = rv.run(visits, app, loader, str(tmp_path / "w"), max_visits=4)
    assert os.getcwd() == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(before + ["w"])
    assert out["visits_handled"] == 4
    assert out["engine"].db.stats()["total_persons"] == \
        out["results"]["new_persons"]
