"""The port's clustering and verification engines against the JAX
package's, driven by the same identity-coded fake app.

Every behaviour of ``tests/test_apps_clustering.py`` (on the dense tier
and on the PQ tier, which a gallery of 2 rows reaches), of
``tests/test_apps_verification.py`` and of
``tests/test_gallery_persistence.py`` runs on both stacks: the JAX engine
with its ``AutoGallery`` and the port's (``device="cpu"``), each with its
own ``tests/fake_stack.FakeFaceAnalysis`` and image store and its own temp
directory. Each behaviour's assertions hold on both, and the two agree:
what the calls returned, the SQLite rows, the clustering_results JSON
(without job ids and clock times) and the gallery's ids are equal, floats
within 1e-5 (``chip_smoke.engine_record`` / ``record_diff``).
"""
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from fake_stack import FakeFaceAnalysis, FakeImageStore, make_image, visit
from scrfd_arcface_facerecognition_tpu.apps import clustering as jcl
from scrfd_arcface_facerecognition_tpu.apps import verification as jver
from scrfd_arcface_facerecognition_tpu.utils import config as jcfg
from scrfd_arcface_facerecognition_tpu_torch.apps import clustering as tcl
from scrfd_arcface_facerecognition_tpu_torch.apps import verification as tver
from scrfd_arcface_facerecognition_tpu_torch.utils import config as tcfg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (  # noqa: E402
    engine_record, record_diff, without_clock)

TOL = 1e-5
OK_BOX = {"width": 90, "height": 120, "top": 300, "left": 300}


class Stack:
    """One package's engine classes, config and device arguments, over its
    own fake app, image store and directory."""

    def __init__(self, name, root):
        self.name = name
        self.root = root
        root.mkdir(parents=True, exist_ok=True)
        port = name == "port"
        self.cl = tcl if port else jcl
        self.ver = tver if port else jver
        self.cfg_mod = tcfg if port else jcfg
        self.kw = dict(device="cpu") if port else {}
        self.store = FakeImageStore()
        self.app = FakeFaceAnalysis()

    def config(self, tier="dense", snapshot=None, policy="error", **vdb):
        return self.cfg_mod.deep_update(self.cfg_mod.DEFAULT_CONFIG, {
            "system": {"database_path": str(self.root / "face.db"),
                       "image_cache_dir": str(self.root / "cache")},
            "vector_database": {
                "tier": tier, "pq_min_train_rows": 2,
                "snapshot_path": (str(self.root / "gallery.snap")
                                  if snapshot else ""),
                "snapshot_stale_policy": policy, **vdb}})

    def engine(self, cfg=None, **cfg_kw):
        eng = self.cl.SmartFaceEngine(
            config=cfg or self.config(**cfg_kw), app=self.app,
            image_loader=self.store.loader,
            results_dir=str(self.root / "results"), **self.kw)
        eng._stack = self
        return eng

    def comparison(self):
        return self.ver.FaceComparison(
            config=self.cfg_mod.DEFAULT_CONFIG, app=self.app,
            image_loader=self.store.loader, log_file=None, **self.kw)


def plain(v):
    """Call results as plain JSON values (numpy scalars and arrays too),
    without what the clock wrote."""
    return without_clock(json.loads(json.dumps(
        v, default=lambda x: np.asarray(x).tolist())))


def assert_stacks_agree(tmp_path, scenario, **cfg_kw):
    """Run ``scenario(stack, engine)`` on both stacks; their returns and
    the engines' records must agree."""
    outs, records = {}, {}
    for name in ("jax", "port"):
        st = Stack(name, tmp_path / name)
        eng = st.engine(**cfg_kw)
        outs[name] = plain(scenario(st, eng))
        records[name] = engine_record(eng)
    diff = record_diff(outs["jax"], outs["port"], TOL, "returned")
    assert diff is None, diff
    diff = record_diff(records["jax"], records["port"], TOL)
    assert diff is None, diff
    return outs["port"], records["port"]


def _write(eng, visits, name="v.json"):
    p = eng._stack.root / name
    p.write_text(json.dumps({"visits": visits}))
    return str(p)


def _add(eng, spec):
    for u, i, j in spec:
        eng._stack.store.add(u, i, j)


# ------------------------------------------- clustering behaviours


def same_person_groups_different_creates(st, eng):
    _add(eng, [("http://x/a1.jpg", 1, 0), ("http://x/a2.jpg", 1, 1),
               ("http://x/b1.jpg", 2, 0)])
    results = eng.process_visit_data(_write(eng, [
        visit(0, "http://x/a1.jpg"), visit(1, "http://x/a2.jpg"),
        visit(2, "http://x/b1.jpg")]), save_images=False)
    assert results["new_persons"] == 2 and results["recognized"] == 1
    assert results["processed"] == 3
    assert eng.vector_db.get_embedding_count() == 2
    assert eng.get_web_stats()["total_persons"] == 2
    return results, eng.get_web_stats(), eng.get_person_groups_for_web()


def non_http_visits_filtered(st, eng):
    p = eng._stack.root / "v.json"
    p.write_text(json.dumps({"visits": [
        {"id": 1, "image": "/local/path.jpg"},
        {"id": 2, "image": None}, {"id": 3}]}))
    results = eng.process_visit_data(str(p))
    assert results["processed"] == 0
    return results


def duplicate_url_skipped(st, eng):
    _add(eng, [("http://x/a.jpg", 1, 0)])
    results = eng.process_visit_data(_write(eng, [
        visit(0, "http://x/a.jpg"), visit(1, "http://x/a.jpg")]),
        save_images=False)
    assert results["duplicate_faces"] == 1 and results["processed"] == 1
    return results


def near_duplicate_embedding_skipped(st, eng):
    _add(eng, [("http://x/a.jpg", 1, 0), ("http://x/acopy.jpg", 1, 0)])
    results = eng.process_visit_data(_write(eng, [
        visit(0, "http://x/a.jpg"), visit(1, "http://x/acopy.jpg")]),
        save_images=False)
    assert results["duplicate_faces"] == 1
    return results


def no_face_goes_to_low_similarity(st, eng):
    eng.app.no_face_identities = {7}
    _add(eng, [("http://x/n.jpg", 7, 0)])
    results = eng.process_visit_data(_write(eng, [visit(0, "http://x/n.jpg")]),
                                     save_images=False)
    assert results["no_faces"] == 1
    rows = eng.get_low_similarity_images()
    assert len(rows) == 1 and "No face detected" in rows[0]["reason"]
    return results, [{k: r[k] for k in ("visit_id", "reason", "similarity")}
                     for r in rows]


def clustering_results_json_schema(st, eng):
    _add(eng, [("http://x/a1.jpg", 1, 0), ("http://x/a2.jpg", 1, 1)])
    eng.process_visit_data(_write(eng, [
        visit(0, "http://x/a1.jpg", box={"width": 90, "height": 120,
                                         "top": 100, "left": 100}),
        visit(1, "http://x/a2.jpg")]), save_images=False)
    payload = engine_record(eng)["json"]
    assert len(payload) == 1
    for key in ("status", "total_processed", "total_groups", "results",
                "message", "groups"):
        assert key in payload[0], key
    g = payload[0]["groups"][0]
    assert set(g["visits"][0]) == {"visit_id", "customer_id", "image_url",
                                   "entry_time", "similarity"}
    return payload


def json_entry_point_bbox_side_gate(st, eng):
    _add(eng, [("http://x/side.jpg", 1, 0), ("http://x/ok.jpg", 2, 0)])
    side_box = {"width": 15, "height": 100, "top": 300, "left": 300}
    results = eng.process_visit_data_from_json(
        {"visits": [visit(0, "http://x/side.jpg", box=side_box),
                    visit(1, "http://x/ok.jpg", box=OK_BOX)]},
        save_images=False)
    assert results["low_quality"] == 1 and results["processed"] == 1
    return results


def low_confidence_rejected(st, eng):
    eng.app.det_score = 0.3
    _add(eng, [("http://x/a.jpg", 1, 0)])
    results = eng.process_visit_data(_write(eng, [visit(0, "http://x/a.jpg")]),
                                     save_images=False)
    assert results["no_faces"] == 1
    return results


def _emb_data(emb, h):
    return {"embedding": emb,
            "quality": {"overall": .8, "blur": .8, "pose": .8,
                        "lighting": .8},
            "face_hash": h, "bbox": [0, 0, 1, 1], "det_score": .9,
            "face_confidence": .9, "image_source": "u" + h}


def find_and_merge_duplicates(st, eng):
    one = np.ones(512, np.float32) / np.sqrt(512)
    half = np.concatenate([np.ones(256), -np.ones(256)]).astype(
        np.float32) / np.sqrt(512)
    p1 = eng.add_person("a", "u1", _emb_data(one, "h1"))
    p2 = eng.add_person("b", "u2", _emb_data(one, "h2"))
    p3 = eng.add_person("c", "u3", _emb_data(half, "h3"))
    eng.db.store_visit(p2, "v1", "c", "t", "u", None, 0.9)
    merged, pairs = eng.find_and_merge_duplicates(return_pairs=True)
    assert merged == 1
    assert eng.db.get_person(p2) is None and eng.db.get_person(p3)
    assert eng.vector_db.get_embedding_count() == 2
    assert eng.db.visits_for_person(p1)[0]["visit_id"] == "v1"
    return merged, pairs


def add_person_hash_dedup_and_rollback(st, eng):
    e1 = _emb_data(np.ones(512, np.float32), "same")
    first = eng.add_person("a", "u1", e1)
    second = eng.add_person("b", "u2", dict(e1))
    assert first > 0 and second == -1
    assert eng.vector_db.get_embedding_count() == 1
    assert eng.get_web_stats()["total_persons"] == 1
    return first, second


def clear_all_data(st, eng):
    _add(eng, [("http://x/a.jpg", 1, 0)])
    eng.process_visit_data(_write(eng, [visit(0, "http://x/a.jpg")]),
                           save_images=False)
    eng.clear_all_data()
    assert eng.get_web_stats()["total_persons"] == 0
    assert eng.vector_db.get_embedding_count() == 0
    return eng.get_web_stats()


def process_from_json_clear_existing(st, eng):
    _add(eng, [("http://x/a.jpg", 1, 0), ("http://x/b.jpg", 2, 0)])
    r1 = eng.process_visit_data_from_json(
        {"visits": [visit(0, "http://x/a.jpg", box=OK_BOX)]},
        save_images=False)
    assert eng.get_web_stats()["total_persons"] == 1
    r2 = eng.process_visit_data_from_json(
        {"visits": [visit(1, "http://x/b.jpg", box=OK_BOX)]},
        save_images=False, clear_existing=True)
    assert eng.get_web_stats()["total_persons"] == 1
    return r1, r2


def extract_batch_passes_original_shapes(st, eng):
    calls = []
    orig = eng.app.get_batch

    def spy(images, max_num=0):
        calls.append([im.shape for im in images])
        return orig(images, max_num=max_num)

    eng.app.get_batch = spy
    st.store.images["http://x/odd1.jpg"] = make_image(1, h=231, w=317)
    st.store.images["http://x/odd2.jpg"] = make_image(2, h=199, w=305)
    results = eng.extract_batch(["http://x/odd1.jpg", "http://x/odd2.jpg"])
    assert all(r is not None for r in results)
    assert {s for c in calls for s in c} == {(231, 317, 3), (199, 305, 3)}
    return [{k: r[k] for k in ("embedding", "quality", "face_hash",
                               "det_score")} for r in results]


def download_failure_counted_separately(st, eng):
    _add(eng, [("http://x/ok.jpg", 1, 0)])
    results = eng.process_visit_data(_write(eng, [
        visit(0, "http://x/missing.jpg"), visit(1, "http://x/ok.jpg")]),
        save_images=False)
    assert results["download_failed"] == 1 and results["no_faces"] == 0
    assert results["new_persons"] == 1
    assert any("download" in r["reason"].lower()
               for r in eng.get_low_similarity_images())
    return results


def mid_batch_exception_isolated(st, eng):
    _add(eng, [("http://x/a.jpg", 1, 0), ("http://x/b.jpg", 2, 0),
               ("http://x/c.jpg", 3, 0)])
    orig = eng.db.store_visit
    boom = {"n": 0}

    def flaky(pid, visit_id, *a, **k):
        boom["n"] += 1
        if visit_id == "1":
            raise RuntimeError("injected DB failure")
        return orig(pid, visit_id, *a, **k)

    eng.db.store_visit = flaky
    results = eng.process_visit_data(_write(eng, [
        visit(0, "http://x/a.jpg"), visit(1, "http://x/b.jpg"),
        visit(2, "http://x/c.jpg")]), save_images=False)
    assert results["no_faces"] == 1 and results["new_persons"] == 2
    assert boom["n"] == 3
    return results


def quality_gate_counts_low_quality(st, eng):
    eng.config["face_detection"]["min_quality_threshold"] = 2.0
    _add(eng, [("http://x/a.jpg", 1, 0)])
    results = eng.process_visit_data(_write(eng, [visit(0, "http://x/a.jpg")]),
                                     save_images=False)
    assert results["low_quality"] == 1 and results["no_faces"] == 0
    return results


def compare_face_images_rich_payload(st, eng):
    _add(eng, [("http://x/p1.jpg", 1, 0), ("http://x/p2.jpg", 1, 1),
               ("http://x/q.jpg", 2, 0)])
    out = eng.compare_face_images("http://x/p1.jpg", "http://x/p2.jpg")
    assert out["success"] and out["error"] is None and out["same_person"]
    assert out["confidence"] == out["similarity"] > \
        eng.config["face_comparison"]["similarity_threshold"]
    for fk in ("face1", "face2"):
        assert len(out[fk]["bbox"]) == 4
        assert isinstance(out[fk]["is_side_face"], bool)
    neg = eng.compare_face_images("http://x/p1.jpg", "http://x/q.jpg")
    assert neg["success"] and neg["same_person"] is False
    err = eng.compare_face_images("http://x/missing.jpg", "http://x/p1.jpg")
    assert not err["success"] and "download" in err["error"].lower()
    return out, neg, err


def returning_visitors_across_batches(st, eng):
    """More than the original suite: three batches over the same
    identities, so the later batches' searches hit a gallery on the
    tier under test (on the PQ tier they run the ADC scorer)."""
    _add(eng, [(f"http://x/id{i}_{j}.jpg", i, j)
               for i in range(1, 7) for j in range(3)])
    out = []
    for j in range(3):
        out.append(eng.process_visit_data_from_json({"visits": [
            visit(10 * j + i, f"http://x/id{i}_{j}.jpg", box=OK_BOX)
            for i in range(1, 7)]}, save_images=False))
    assert out[0]["new_persons"] == 6
    assert out[1]["recognized"] == 6 and out[2]["recognized"] == 6
    return out, eng.vector_db.tier


CLUSTERING = [same_person_groups_different_creates, non_http_visits_filtered,
              duplicate_url_skipped, near_duplicate_embedding_skipped,
              no_face_goes_to_low_similarity, clustering_results_json_schema,
              json_entry_point_bbox_side_gate, low_confidence_rejected,
              find_and_merge_duplicates, add_person_hash_dedup_and_rollback,
              clear_all_data, process_from_json_clear_existing,
              extract_batch_passes_original_shapes,
              download_failure_counted_separately,
              mid_batch_exception_isolated, quality_gate_counts_low_quality,
              compare_face_images_rich_payload,
              returning_visitors_across_batches]


@pytest.mark.parametrize("tier", ["dense", "pq"])
@pytest.mark.parametrize("scenario", CLUSTERING, ids=lambda f: f.__name__)
def test_clustering_engine_matches_jax(tmp_path, scenario, tier):
    assert_stacks_agree(tmp_path, scenario, tier=tier)


def test_returning_visitors_reach_the_pq_tier(tmp_path):
    out, record = assert_stacks_agree(
        tmp_path, returning_visitors_across_batches, tier="pq")
    assert out[1] == "pq" and len(record["gallery"]) == 6


def test_api_transform_matches_jax():
    raw = [
        {"id": "v1", "image": "http://x/1.jpg",
         "faceResponse": {"imageUrl": "http://x/1.jpg",
                          "age": 25, "gender": "male"}},
        "not-a-dict-record",
        {"id": "v2", "imageUrl": "http://x/2.jpg", "faceResponse": None},
        {"id": "v3", "image": "http://x/3.jpg",
         "faceResponse": {"age": {"low": 30}, "gender": {"value": "female"},
                          "boxData": {"imageUrl": "http://x/3.jpg"}}},
        {"id": "v4", "image": "/local.jpg"},
    ]
    got = tcl.SmartFaceEngine._transform_api_visits(raw)
    assert got == jcl.SmartFaceEngine._transform_api_visits(raw)
    assert [v["id"] for v in got] == ["v1", "v2", "v3"]


def test_engines_raise_without_a_card(monkeypatch, tmp_path):
    from scrfd_arcface_facerecognition_tpu_torch import (
        FaceComparison, SmartFaceEngine)

    st = Stack("port", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: SmartFaceEngine(config=st.config(), app=st.app,
                                         results_dir=str(tmp_path / "r")),
                 lambda: FaceComparison(config=st.config(), app=st.app,
                                        log_file=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    eng = st.engine()
    assert eng.device.type == "cpu" and eng.vector_db.device.type == "cpu"


# -------------------------------------------- verification behaviours


def _comparisons(tmp_path, scenario):
    outs = {}
    for name in ("jax", "port"):
        st = Stack(name, tmp_path / name)
        outs[name] = plain(scenario(st, st.comparison()))
    diff = record_diff(outs["jax"], outs["port"], TOL, "returned")
    assert diff is None, diff
    return outs["port"]


def compare_same_and_different(st, fc):
    st.store.add("http://x/a1.jpg", 1, 0)
    st.store.add("http://x/a2.jpg", 1, 1)
    st.store.add("http://x/b.jpg", 2, 0)
    same = fc.compare_face_images("http://x/a1.jpg", "http://x/a2.jpg")
    assert same["same_person"] and same["confidence"] > 0.2
    diff = fc.compare_face_images("http://x/a1.jpg", "http://x/b.jpg")
    assert not diff["same_person"]
    return same, diff


def compare_download_failure(st, fc):
    out = fc.compare_face_images("http://x/missing.jpg", "http://x/m2.jpg")
    assert not out["same_person"] and out["error"]
    return out


def compare_no_face(st, fc):
    fc.app.no_face_identities = {9}
    st.store.add("http://x/n.jpg", 9, 0)
    st.store.add("http://x/a.jpg", 1, 0)
    out = fc.compare_face_images("http://x/n.jpg", "http://x/a.jpg")
    assert "detect faces" in out["error"]
    return out


def process_face_comparisons_accuracy(st, fc):
    st.store.add("http://x/a1.jpg", 1, 0)
    st.store.add("http://x/a2.jpg", 1, 1)
    st.store.add("http://x/b.jpg", 2, 0)
    records = fc.transform_records([
        {"id": "r1", "image": "http://x/a1.jpg",
         "refImage": "http://x/a2.jpg", "isConverted": True},
        {"id": "r2", "image": "http://x/a1.jpg",
         "refImage": "http://x/b.jpg", "isConverted": True},
        {"id": "r3", "image": "http://x/gone.jpg",
         "refImage": "http://x/b.jpg", "isConverted": False}])
    out = fc.process_face_comparisons(records)
    assert out["processed"] == 3 and out["same_person"] == 1
    assert out["different_person"] == 1 and out["errors"] == 1
    assert [r["match_status"] for r in out["results"]] == [
        "SAME", "DIFFERENT", "DIFFERENT"]
    payload = st.ver.build_comparison_results_json(out)
    payload["metadata"].pop("generated_at")
    return out, payload


def max_comparisons_limit(st, fc):
    st.store.add("http://x/a.jpg", 1, 0)
    records = fc.transform_records([
        {"id": f"r{i}", "image": "http://x/a.jpg",
         "refImage": "http://x/a.jpg"} for i in range(5)])
    out = fc.process_face_comparisons(records, max_comparisons=2)
    assert out["processed"] == 2
    return out


def empty_records(st, fc):
    out = fc.process_face_comparisons([])
    assert out["total_comparisons"] == 0 and out["results"] == []
    return out


def comparison_results_json_schema(st, fc):
    st.store.add("http://x/p1.jpg", 1, 0)
    st.store.add("http://x/p2.jpg", 1, 1)
    records = [
        {"comparison_id": "c1", "event_id": "ev-7", "branch_id": "b1",
         "created_at": "t", "customer_info": [], "matched_info": [],
         "approve": True, "image1_url": "http://x/p1.jpg",
         "image2_url": "http://x/p2.jpg",
         "raw_data": {"entryEventIds": [{"fileName": "f.jpg",
                                         "event": "entry", "camera": "c1",
                                         "eventId": "ev-7"}]}},
        {"comparison_id": "c2", "event_id": "ev-str-fallback",
         "branch_id": "b2", "created_at": "t", "customer_info": [],
         "matched_info": [], "approve": False,
         "image1_url": "http://x/p1.jpg", "image2_url": "http://x/p2.jpg",
         "raw_data": {}},
    ]
    payload = st.ver.build_comparison_results_json(
        fc.process_face_comparisons(records))
    assert set(payload["metadata"]) == {
        "generated_at", "total_comparisons", "same_person",
        "different_person", "errors", "accuracy_vs_api"}
    first, second = payload["comparisons"]
    assert first == {"fileName": "f.jpg", "event": "entry", "camera": "c1",
                     "eventId": "ev-7", "approve": True,
                     "match_status": "SAME", "branch_id": "b1"}
    assert second["eventId"] == "ev-str-fallback"
    payload["metadata"].pop("generated_at")
    return payload


def transform_records(st, fc):
    raw = [
        {"id": "v1", "image": "http://i1", "refImage": "http://r1",
         "isConverted": True, "branchId": "b1", "entryTime": "t1",
         "customerId": "c1",
         "entryEventIds": [{"eventId": "e1", "fileName": "f1.jpg",
                            "event": "entry", "camera": "cam1"}]},
        {"id": "v2", "image": "http://i2"},
        {"id": "v3", "image": "http://i3", "refImage": "http://r3",
         "entryEventIds": ["bare-string-event"]},
    ]
    records = fc.transform_records(raw)
    assert len(records) == 2 and records[0]["event_id"] == "e1"
    assert records[1]["event_id"] is None
    payload = st.ver.build_comparison_results_json({
        "results": [{"comparison_id": "v1", "event_id": "fallback-id",
                     "raw_data": {"entryEventIds": ["bare-string-event"]}}]})
    payload["metadata"].pop("generated_at")
    return records, payload


def rgb_flip_feeds_the_app(st, fc):
    """The reference feeds RGB here; the port flips the channels where
    the original calls cv2.cvtColor: the app sees the same pixels."""
    seen = []
    orig = fc.app._get_batch_direct

    def spy(images, max_num=0):
        seen.extend(np.asarray(im).copy() for im in images)
        return orig(images, max_num=max_num)

    fc.app._get_batch_direct = spy
    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3), np.uint8)
    img[0, 0, :] = 4
    st.store.images["http://x/rgb.jpg"] = img
    fc.compare_face_images("http://x/rgb.jpg", "http://x/rgb.jpg")
    assert len(seen) == 2
    np.testing.assert_array_equal(seen[0], img[..., ::-1])
    return [s.tolist() for s in seen]


VERIFICATION = [compare_same_and_different, compare_download_failure,
                compare_no_face, process_face_comparisons_accuracy,
                max_comparisons_limit, empty_records,
                comparison_results_json_schema, transform_records,
                rgb_flip_feeds_the_app]


@pytest.mark.parametrize("scenario", VERIFICATION, ids=lambda f: f.__name__)
def test_verification_matches_jax(tmp_path, scenario):
    _comparisons(tmp_path, scenario)


def _drop_file_handlers(mod):
    for h in list(mod.logger.handlers):
        if isinstance(h, logging.FileHandler):
            mod.logger.removeHandler(h)
            h.close()


def test_comparison_log_file(tmp_path):
    log_path = tmp_path / "face_comparison.log"
    st = Stack("port", tmp_path / "port")
    st.store.add("http://x/p1.jpg", 1, 0)
    st.store.add("http://x/p2.jpg", 1, 1)
    fc = st.comparison()
    tver.enable_comparison_log(str(log_path))
    try:
        fc.process_face_comparisons([
            {"comparison_id": "c1", "event_id": None, "branch_id": None,
             "created_at": None, "customer_info": [], "matched_info": [],
             "approve": True, "image1_url": "http://x/p1.jpg",
             "image2_url": "http://x/p2.jpg", "raw_data": {}}])
        text = log_path.read_text()
        assert "Comparison c1" in text and "Processed 1 comparisons" in text
    finally:
        _drop_file_handlers(tver)


def test_comparison_log_single_handler(tmp_path):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    try:
        tver.enable_comparison_log(str(a))
        tver.enable_comparison_log(str(b))
        tver.enable_comparison_log(str(b))
        ours = [h for h in tver.logger.handlers
                if getattr(h, "name", None) == tver._COMPARISON_HANDLER]
        assert len(ours) == 1 and ours[0].baseFilename.endswith("b.log")
        tver.logger.info("only-into-b")
        assert "only-into-b" in b.read_text()
        assert not a.exists() or "only-into-b" not in a.read_text()
    finally:
        _drop_file_handlers(tver)


# ------------------------------------------- persistence behaviours


def _run(eng, specs, name="visits.json"):
    return eng.process_visit_data(_write(eng, [
        visit(i, u) for i, (u, _, _) in enumerate(specs)], name),
        save_images=False)


def _persist(tmp_path, scenario):
    outs, records = {}, {}
    for name in ("jax", "port"):
        st = Stack(name, tmp_path / name)
        outs[name], eng = scenario(st)
        outs[name] = plain(outs[name])
        records[name] = engine_record(eng)
    diff = record_diff(outs["jax"], outs["port"], TOL, "returned")
    assert diff is None, diff
    diff = record_diff(records["jax"], records["port"], TOL)
    assert diff is None, diff


def restart_recognizes_returning_visitors(tier):
    def scenario(st):
        specs = [("http://x/a1.jpg", 1, 0), ("http://x/a2.jpg", 1, 1),
                 ("http://x/b1.jpg", 2, 0)]
        for u, i, j in specs:
            st.store.add(u, i, j)
        cfg = st.config(tier, snapshot=True)
        res = _run(st.engine(cfg), specs)
        assert res["new_persons"] == 2 and res["recognized"] == 1
        b = st.engine(cfg)                       # the restart
        assert b.vector_db.get_embedding_count() == 2
        assert b.vector_db.tier == tier
        st.store.add("http://x/a3.jpg", 1, 2)
        res2 = _run(b, [("http://x/a3.jpg", 1, 2)], "v2.json")
        assert res2["recognized"] == 1 and res2["new_persons"] == 0
        return (res, res2), b
    scenario.__name__ = f"restart_recognizes_returning_visitors_{tier}"
    return scenario


def missing_snapshot_on_populated_db_refuses(st):
    st.store.add("http://x/a.jpg", 1, 0)
    _run(st.engine(st.config()), [("http://x/a.jpg", 1, 0)])
    with pytest.raises(RuntimeError, match="does not exist"):
        st.engine(st.config(snapshot=True))
    b = st.engine(st.config(snapshot=True, policy="ignore"))
    assert b.vector_db.get_embedding_count() == 0
    return b.get_web_stats(), b


def stale_snapshot_detected(st):
    st.store.add("http://x/a.jpg", 1, 0)
    cfg = st.config(snapshot=True)
    a = st.engine(cfg)
    _run(a, [("http://x/a.jpg", 1, 0)])
    a.db.insert_person("ghost", None, 0.5, "h" * 32, {"overall": 0.5})
    with pytest.raises(RuntimeError, match="stale"):
        st.engine(cfg)
    return None, a


def corrupt_snapshot_fails_loudly(st):
    st.store.add("http://x/a.jpg", 1, 0)
    cfg = st.config(snapshot=True)
    a = st.engine(cfg)
    _run(a, [("http://x/a.jpg", 1, 0)])
    with open(cfg["vector_database"]["snapshot_path"], "wb") as f:
        f.write(b"\x00garbage\x00" * 16)
    with pytest.raises(RuntimeError, match="failed to restore"):
        st.engine(cfg)
    b = st.engine(st.config(snapshot=True, policy="ignore"))
    assert b.vector_db.get_embedding_count() == 0
    return None, b


def close_persists_direct_adds(st):
    url = st.store.add("http://x/a.jpg", 7, 0)
    cfg = st.config(snapshot=True)
    a = st.engine(cfg)
    data = a.extract_face_embedding(url)
    pid = a.add_person("direct", url, data)
    assert pid > 0
    a.close()
    b = st.engine(cfg)
    hits = b.search_person(data["embedding"], k=1)
    assert hits and hits[0]["person_id"] == pid
    return hits, b


def clear_all_writes_empty_generation(st):
    st.store.add("http://x/a.jpg", 1, 0)
    cfg = st.config(snapshot=True)
    a = st.engine(cfg)
    _run(a, [("http://x/a.jpg", 1, 0)])
    a.clear_all_data()
    b = st.engine(cfg)
    assert b.vector_db.get_embedding_count() == 0
    return None, b


def merge_resnapshots(st):
    cfg = st.config(snapshot=True)
    a = st.engine(cfg)
    for n, (u, j) in enumerate([("http://x/m1.jpg", 0),
                                ("http://x/m2.jpg", 1)]):
        url = st.store.add(u, 5, j)
        assert a.add_person(f"p{n}", url, a.extract_face_embedding(url)) > 0
    a.save_gallery_snapshot()
    assert a.find_and_merge_duplicates() == 1
    b = st.engine(cfg)
    assert b.vector_db.get_embedding_count() == 1
    return None, b


PERSISTENCE = [restart_recognizes_returning_visitors("dense"),
               restart_recognizes_returning_visitors("pq"),
               missing_snapshot_on_populated_db_refuses,
               stale_snapshot_detected, corrupt_snapshot_fails_loudly,
               close_persists_direct_adds, clear_all_writes_empty_generation,
               merge_resnapshots]


@pytest.mark.parametrize("scenario", PERSISTENCE, ids=lambda f: f.__name__)
def test_gallery_persistence_matches_jax(tmp_path, scenario):
    _persist(tmp_path, scenario)
