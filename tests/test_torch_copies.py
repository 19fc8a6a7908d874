"""The port's copies of the JAX package's framework-free modules agree with
their originals on the same inputs: ``utils/config.py`` (equal dicts),
``apps/quality.py`` (equal outputs on seeded boxes), ``apps/metadata_db.py``
(the same operation sequence on two temp DBs gives equal ``iterdump()``,
the clock's CURRENT_TIMESTAMP values masked) and ``apps/json_storage.py``
(equal files without the job id and the write time). The originals'
behaviours (``tests/test_apps_db.py``, ``tests/test_apps_quality_config.py``)
run on the copies too."""
import glob
import json
import re
import sqlite3
import types

import numpy as np
import pytest

from scrfd_arcface_facerecognition_tpu.apps import json_storage as jjs
from scrfd_arcface_facerecognition_tpu.apps import metadata_db as jdb
from scrfd_arcface_facerecognition_tpu.apps import quality as JQ
from scrfd_arcface_facerecognition_tpu.utils import config as jcfg
from scrfd_arcface_facerecognition_tpu_torch.apps import json_storage as tjs
from scrfd_arcface_facerecognition_tpu_torch.apps import metadata_db as tdb
from scrfd_arcface_facerecognition_tpu_torch.apps import quality as TQ
from scrfd_arcface_facerecognition_tpu_torch.utils import config as tcfg

QUALITY = {"overall": 0.8, "blur": 0.9, "pose": 0.7, "lighting": 0.85}
_CLOCK = re.compile(r"'\d{4}-\d\d-\d\d \d\d:\d\d:\d\d'")


# -------------------------------------------------------------- config


def test_default_config_equals_the_original():
    assert tcfg.DEFAULT_CONFIG == jcfg.DEFAULT_CONFIG


def test_load_config_and_deep_update_agree(tmp_path):
    assert tcfg.load_config(str(tmp_path / "missing.json")) == \
        jcfg.load_config(str(tmp_path / "missing.json"))
    p = tmp_path / "config.json"
    p.write_text(json.dumps({
        "face_recognition": {"similarity_threshold": 0.77},
        "vector_database": {"tier": "pq", "pq_min_train_rows": 2},
        "extra_section": {"x": [1, 2]}}))
    got, want = tcfg.load_config(str(p)), jcfg.load_config(str(p))
    assert got == want
    assert got["face_recognition"]["grouping_threshold_file"] == 0.45
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": [1]}
    over = {"a": {"c": {"d": 3}, "f": 4}, "e": [2]}
    assert tcfg.deep_update(base, over) == jcfg.deep_update(base, over)
    assert base["a"]["c"]["d"] == 2                     # no mutation


def test_load_api_config_agrees(tmp_path):
    p = tmp_path / "api_config.txt"
    p.write_text("# comment\nAPI_URL=https://x.example/api?a=b=c\n\n"
                 "API_KEY = secret \nBADLINE\n")
    assert tcfg.load_api_config(str(p)) == jcfg.load_api_config(str(p)) == {
        "API_URL": "https://x.example/api?a=b=c", "API_KEY": "secret"}
    assert tcfg.load_api_config(str(tmp_path / "nope.txt")) == {}


# ------------------------------------------------------------- quality


def _face(det_score, bbox, kps_spread):
    f = types.SimpleNamespace()
    f.det_score = det_score
    f.bbox = np.asarray(bbox, np.float32)
    cx, cy = (bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2
    s = kps_spread / 2
    f.kps = np.asarray([[cx - s, cy - s], [cx + s, cy - s], [cx, cy],
                        [cx - s, cy + s], [cx + s, cy + s]], np.float32)
    return f


def _boxes(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x, y = rng.uniform(0, 600, 2)
        w = rng.choice([rng.uniform(5, 60), rng.uniform(60, 700)])
        h = rng.choice([rng.uniform(5, 60), rng.uniform(60, 700)])
        out.append((float(rng.uniform(0.05, 1.0)), (x, y, x + w, y + h),
                    float(rng.uniform(5, 150))))
    return out


def test_quality_copy_agrees_on_seeded_faces():
    cfg = tcfg.DEFAULT_CONFIG
    sides = 0
    for det, bbox, spread in _boxes():
        f = _face(det, bbox, spread)
        assert TQ.assess_face_quality(f, cfg) == JQ.assess_face_quality(f,
                                                                        cfg)
        side = TQ.is_side_face(f, cfg)
        assert side == JQ.is_side_face(f, cfg)
        sides += bool(side)
        x1, y1, x2, y2 = bbox
        box = {"width": x2 - x1, "height": y2 - y1, "top": y1, "left": x1}
        assert TQ.analyze_bbox_for_side_face(box, det, cfg) == \
            JQ.analyze_bbox_for_side_face(box, det, cfg)
        visit = {"entryEventIds": [{"box": box}]}
        assert TQ.check_side_face_from_json_bbox(visit, cfg) == \
            JQ.check_side_face_from_json_bbox(visit, cfg)
    assert 0 < sides < 300                  # both verdicts were reached
    assert TQ.check_side_face_from_json_bbox({}, cfg) == \
        JQ.check_side_face_from_json_bbox({}, cfg)


@pytest.mark.parametrize("bbox,side", [((200, 200, 215, 300), True),
                                       ((200, 200, 300, 330), False)])
def test_is_side_face_uses_bbox_when_no_pose(bbox, side):
    f = _face(0.9, bbox, 60.0)
    assert TQ.is_side_face(f, tcfg.DEFAULT_CONFIG) is side


# --------------------------------------------------------- metadata db


def _db_ops(mod, path):
    """The original tests' operation sequence, on one module's MetadataDB;
    returns what the reads returned."""
    db = mod.MetadataDB(path)
    reads = []
    p1 = db.insert_person("alice", "http://img/1.jpg", 0.8, "hash1", QUALITY)
    p2 = db.insert_person("bob", "imgB", 0.6, "hash2", QUALITY)
    p3 = db.insert_person("carol", None, 0.5, "hash3", QUALITY)
    reads.append((db.find_person_by_hash("hash1"),
                  db.find_person_by_hash("nope")))
    db.store_visit(p1, "v1", "c1", "2025-01-01T10:00:00", "http://img/1.jpg",
                   None, 0.9)
    db.store_visit(p1, "v2", "c2", "2025-01-02T10:00:00", "http://img/2.jpg",
                   "saved.jpg", 0.8)
    db.store_visit(p1, "v2", "c2", "2025-01-02T10:00:00", "http://img/2.jpg",
                   "saved.jpg", 0.7)                  # replaces
    db.store_visit(p3, "v3", "c3", "t3", "u3", None, 0.95)
    db.update_person_stats(p1)
    db.update_person_stats(p3)
    db.store_low_similarity("v4", "c4", "t4", "u4", None, 0.2, "p",
                            "low sim")
    db.store_low_similarity("v5", "c5", "t5", "u5", None, 0.0, None,
                            "No face detected")
    visits = db.visits_for_person(p1)
    reads.append([(v["visit_id"], v["similarity"]) for v in visits])
    reads.append((db.image_url_seen("http://img/1.jpg"),
                  db.image_url_seen("http://img/9.jpg")))
    reads.append([(r["visit_id"], r["reason"])
                  for r in db.low_similarity_rows()])
    s = db.stats()
    reads.append({k: s[k] for k in ("total_persons", "total_visits",
                                    "low_similarity_count")})
    db.repoint_visits(p3, p1)
    reads.append((db.get_person(p3), db.get_person(p1)["match_count"]))
    reads.append([(g["person_id"], g["visit_count"])
                  for g in db.person_groups()])
    reads.append([p for p, _ in db.list_persons()])
    db.delete_person(p2)
    reads.append(db.get_person(p2))
    return db, reads


def _dump(path):
    with sqlite3.connect(path) as conn:
        return [_CLOCK.sub("'<now>'", line) for line in conn.iterdump()]


def test_metadata_db_copy_gives_the_same_database(tmp_path):
    jd, jreads = _db_ops(jdb, str(tmp_path / "jax.db"))
    td, treads = _db_ops(tdb, str(tmp_path / "port.db"))
    assert treads == jreads
    dj, dt = _dump(jd.path), _dump(td.path)
    assert len(dt) > 10 and dt == dj
    for db in (jd, td):
        db.clear_all()
    assert _dump(td.path) == _dump(jd.path)
    # ids restart from 1 after the sqlite_sequence reset
    assert td.insert_person("b", None, 0.5, "h", QUALITY) == 1


def test_metadata_db_schema_tables(tmp_path):
    db = tdb.MetadataDB(str(tmp_path / "t.db"))
    with sqlite3.connect(db.path) as conn:
        tables = {r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
    assert {"persons", "face_quality", "person_visits",
            "low_similarity_images"} <= tables


# -------------------------------------------------------- json storage


def _groups():
    return [
        {"person_id": 1, "person_name": "Person_c1_1",
         "visits": [{"visit_id": "v1", "customerId": "c1",
                     "image": "http://x/1.jpg", "entryTime": "t1",
                     "similarity": 1.0, "camera": "cam1", "branchId": "b",
                     "entryEventIds": [{"event": "entry", "fileName": "f"}],
                     "customer": {"age": 31, "gender": "F"}},
                    {"visit_id": "v2", "customer_id": "c1",
                     "image_url": "http://x/2.jpg", "entry_time": "t2",
                     "similarity": 0.61}]},
        {"person_id": 2, "visits": [{"id": "v3", "similarity": None,
                                     "results": {"age": 40}}]},
        {"person_id": 3, "visits": []},
    ]


def _written(mod, out_dir):
    mgr = mod.JSONStorageManager(str(out_dir))
    assert mgr.save_clustering_results(
        groups=_groups(), total_processed=3,
        results={"processed": 3, "new_persons": 2})
    (path,) = glob.glob(str(out_dir / "clustering_results_*_*.json"))
    payload = json.loads(open(path).read())
    payload.pop("job_id")
    payload.pop("timestamp")
    return payload


def test_json_storage_copy_writes_the_same_file(tmp_path):
    want = _written(jjs, tmp_path / "jax")
    got = _written(tjs, tmp_path / "port")
    assert got == want
    assert got["total_groups"] == 2 and got["status"] == "finished"
    mgr = tjs.JSONStorageManager(str(tmp_path / "fmt"))
    assert mgr.format_groups_for_json(_groups()) == \
        jjs.JSONStorageManager(str(tmp_path / "fmt2")).format_groups_for_json(
            _groups())
