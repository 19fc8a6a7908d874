"""The port's web API (``apps/webapp.py``, ``apps/webui.py``) against the
JAX package's.

Every behaviour of ``tests/test_apps_webapp.py`` runs on both stacks: the
JAX ``WebApp`` over the JAX ``SmartFaceEngine`` / ``FaceComparison`` and
the port's over the port's (``device="cpu"``), each with its own
``tests/fake_stack`` app (the port's routed through the port's
``FaceAnalysis.get_batch`` and micro-batcher) and image store, in its own
temp directory. Each behaviour's assertions hold on both, and the two
answer alike, route by route: every ``dispatch`` call's status, content
type and payload (JSON without job ids or clock times, the stack's
directory written as ``<root>``, floats within 1e-5; bytes equal), and
the engines' SQLite rows and results files after it
(``chip_smoke.engine_record``). The live-socket server, the mock
analytics API and micro-batch coalescing of concurrent comparisons are
covered. The page equals the JAX page apart from the backend word in its
title.
"""
import http.server
import json
import os
import re
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fake_stack import FakeFaceAnalysis, FakeImageStore, visit
from scrfd_arcface_facerecognition_tpu.apps import clustering as jcl
from scrfd_arcface_facerecognition_tpu.apps import verification as jver
from scrfd_arcface_facerecognition_tpu.apps import webapp as jweb
from scrfd_arcface_facerecognition_tpu.apps import webui as jui
from scrfd_arcface_facerecognition_tpu.utils import config as jcfg
from scrfd_arcface_facerecognition_tpu_torch.apps import clustering as tcl
from scrfd_arcface_facerecognition_tpu_torch.apps import verification as tver
from scrfd_arcface_facerecognition_tpu_torch.apps import webapp as tweb
from scrfd_arcface_facerecognition_tpu_torch.apps import webui as tui
from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
    FaceAnalysis as TFaceAnalysis)
from scrfd_arcface_facerecognition_tpu_torch.utils import config as tcfg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import engine_record, record_diff, without_clock  # noqa: E402

TOL = 1e-5
OK_BOX = {"width": 90, "height": 120, "top": 300, "left": 300}


class PortFakeFaceAnalysis(FakeFaceAnalysis):
    """The fake app over the port's routing and micro-batcher."""

    get_batch = TFaceAnalysis.get_batch
    enable_microbatch = TFaceAnalysis.enable_microbatch
    disable_microbatch = TFaceAnalysis.disable_microbatch
    MIN_STATIC_GROUP = TFaceAnalysis.MIN_STATIC_GROUP


class Stack:
    """One package's web app over its own engines, fake app, image store
    and directory; every dispatch call is kept in ``log``."""

    def __init__(self, name, root, **cfg):
        port = name == "port"
        self.name, self.root = name, root
        root.mkdir(parents=True, exist_ok=True)
        self.web, self.ui = (tweb, tui) if port else (jweb, jui)
        cl, ver, cfg_mod = (tcl, tver, tcfg) if port else (jcl, jver, jcfg)
        kw = dict(device="cpu") if port else {}
        self.store = FakeImageStore()
        self.cfg = cfg_mod.deep_update(cfg_mod.DEFAULT_CONFIG, {
            "system": {"database_path": str(root / "face.db"),
                       "image_cache_dir": str(root / "cache")}, **cfg})
        fake = PortFakeFaceAnalysis if port else FakeFaceAnalysis
        self.engine = cl.SmartFaceEngine(
            config=self.cfg, app=fake(), image_loader=self.store.loader,
            results_dir=str(root / "results"), **kw)
        comparison = ver.FaceComparison(
            config=self.cfg, app=self.engine.app,
            image_loader=self.store.loader, log_file=None, **kw)
        self.app = self.web.WebApp(
            self.engine, comparison=comparison,
            api_config_path=str(root / "api_config.txt"),
            results_dir=str(root), allowed_image_dirs=[str(root)])
        self.log = []
        inner = self.app.dispatch

        def dispatch(method, path, body=None):
            out = inner(method, path, body)
            self.log.append((method, path, body, out))
            return out

        self.app.dispatch = dispatch

    def server(self):
        """The live server on 127.0.0.1, serving in a thread; -> (server,
        base URL)."""
        server = self.web.make_server(self.app, host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, f"http://127.0.0.1:{server.server_address[1]}"


_STAMP = re.compile(r"\d{8}_\d{6}")
_DROP = ("job_id", "timestamp", "generated_at")


def normal(v, root):
    """A payload or argument as plain values, without what the clock or
    the directory wrote: job ids and clock times dropped, the stack's root as <root>,
    date-time stamps in file names as <stamp>, the page's title word as
    <backend>."""
    if isinstance(v, str):
        v = v.replace(str(root), "<root>")
        v = _STAMP.sub("<stamp>", v)
        v = v.replace("Face Recognition — TPU</title>",
                      "Face Recognition — <backend></title>")
        v = v.replace("Face Recognition — CUDA</title>",
                      "Face Recognition — <backend></title>")
        return without_clock(v)
    if isinstance(v, dict):
        out = {k: normal(x, root) for k, x in without_clock(v).items()
               if k not in _DROP}
        if isinstance(out.get("groups"), list) and all(
                "person_id" in g for g in out["groups"]):
            # the groups come ordered by match_count, then by last_seen,
            # SQLite's CURRENT_TIMESTAMP to the second (a clock column,
            # dropped above): persons tied on match_count fall in clock
            # order, which two runs straddling a second boundary differ
            # in. The match_count order stays held; ties go by id.
            counts = [g.get("match_count", 0) for g in out["groups"]]
            assert counts == sorted(counts, reverse=True), counts
            out["groups"] = sorted(out["groups"], key=lambda g: (
                -g.get("match_count", 0), g["person_id"]))
        return out
    if isinstance(v, (list, tuple)):
        return [normal(x, root) for x in v]
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    return v


def both(tmp_path, scenario, **cfg):
    """``scenario(stack)`` on both stacks; the dispatch calls, the
    scenario's returns and the engines' records must agree."""
    runs = {}
    for name in ("jax", "port"):
        st = Stack(name, tmp_path / name, **cfg)
        try:
            ret = scenario(st)
        finally:
            st.engine.app.disable_microbatch()
        runs[name] = (normal(st.log, st.root), normal(ret, st.root),
                      normal(engine_record(st.engine), st.root))
    for part, (a, b) in zip(("dispatch", "returned", "record"),
                            zip(runs["jax"], runs["port"])):
        diff = record_diff(a, b, TOL, part)
        assert diff is None, diff
    return runs["port"]


def seed_visits(st, n=3):
    urls = [visit(i, st.store.add(f"http://x/{i}.jpg", identity=i),
                  box=OK_BOX) for i in range(n)]
    st.app.dispatch("POST", "/api/process-visits",
                    {"visits": urls, "save_images": False})
    return urls


# --------------------------------------------------- route behaviours


def test_index_and_stats(tmp_path):
    def sc(st):
        status, ctype, html = st.app.dispatch("GET", "/")
        assert status == 200 and "<html" in html.lower()
        status, _, stats = st.app.dispatch("GET", "/api/stats")
        assert status == 200
        assert set(stats) == {"total_persons", "total_visits",
                              "total_images", "low_similarity_count",
                              "recent_activity"}
    both(tmp_path, sc)


def test_process_visits_and_groups(tmp_path):
    def sc(st):
        seed_visits(st, 3)
        status, _, payload = st.app.dispatch("GET", "/api/person-groups")
        assert status == 200 and len(payload["groups"]) == 3
        assert st.app.dispatch("GET", "/api/stats")[2]["total_persons"] == 3
    both(tmp_path, sc)


def test_person_detail(tmp_path):
    def sc(st):
        seed_visits(st, 1)
        _, _, groups = st.app.dispatch("GET", "/api/person-groups")
        pid = groups["groups"][0]["person_id"]
        status, _, person = st.app.dispatch("GET", f"/api/person/{pid}")
        assert status == 200 and person["id"] == pid and person["visits"]
        assert st.app.dispatch("GET", "/api/person/99999")[0] == 404
        assert st.app.dispatch("GET", "/api/person/abc")[0] == 400
    both(tmp_path, sc)


def test_process_visits_requires_input(tmp_path):
    def sc(st):
        assert st.app.dispatch("POST", "/api/process-visits", {})[0] == 400
    both(tmp_path, sc)


def test_merge_and_clear(tmp_path):
    def sc(st):
        seed_visits(st, 2)
        status, _, res = st.app.dispatch("POST", "/api/merge-duplicates",
                                         {"threshold": 0.8})
        assert status == 200 and res["success"]
        _, _, res = st.app.dispatch("POST", "/api/clear-database", {})
        assert res["success"]
        assert st.app.dispatch("GET", "/api/stats")[2]["total_persons"] == 0
    both(tmp_path, sc)


def test_low_similarity_endpoint(tmp_path):
    def sc(st):
        st.engine.app.no_face_identities = {5}
        url = st.store.add("http://x/noface.jpg", identity=5)
        st.app.dispatch("POST", "/api/process-visits",
                        {"visits": [visit(0, url, box=OK_BOX)],
                         "save_images": False})
        status, _, payload = st.app.dispatch("GET",
                                             "/api/low-similarity-images")
        assert status == 200 and len(payload["images"]) == 1
    both(tmp_path, sc)


def test_face_comparisons_endpoint(tmp_path):
    def sc(st):
        st.store.add("http://x/a1.jpg", 1, 0)
        st.store.add("http://x/a2.jpg", 1, 1)
        records = [{"id": "r1", "image": "http://x/a1.jpg",
                    "refImage": "http://x/a2.jpg", "isConverted": True}]
        status, _, res = st.app.dispatch(
            "POST", "/api/process-face-comparisons-from-api",
            {"records": records})
        assert status == 200 and res["success"]
        assert res["summary"]["same_person"] == 1
        with open(res["results_file"]) as f:
            saved = json.load(f)
        assert saved["metadata"]["total_comparisons"] == 1
        assert saved["comparisons"][0]["match_status"] == "SAME"
        return saved
    both(tmp_path, sc)


def test_image_endpoints(tmp_path):
    import cv2

    def sc(st):
        img_path = str(st.root / "test.jpg")
        cv2.imwrite(img_path, np.full((400, 600, 3), 128, np.uint8))
        status, ctype, data = st.app.dispatch("GET", f"/api/image/{img_path}")
        assert status == 200 and ctype == "image/jpeg" and len(data) > 100
        status, _, payload = st.app.dispatch(
            "GET", f"/api/image-base64/{img_path}")
        assert status == 200
        assert payload["image"].startswith("data:image/jpeg;base64,")
        status, ctype, _ = st.app.dispatch("GET",
                                           "/api/image/nonexistent.jpg")
        assert status == 200 and ctype == "image/png"
    both(tmp_path, sc)


def test_clear_cache(tmp_path):
    def sc(st):
        assert st.app.dispatch("POST", "/api/clear-cache", {})[2]["success"]
        assert os.path.isdir(st.engine.image_cache_dir)
    both(tmp_path, sc)


def test_config_endpoint(tmp_path):
    def sc(st):
        (st.root / "api_config.txt").write_text("API_URL=https://x\n")
        _, _, payload = st.app.dispatch("GET", "/api/config")
        assert payload["config"]["API_URL"] == "https://x"
    both(tmp_path, sc)


def test_unknown_route(tmp_path):
    def sc(st):
        assert st.app.dispatch("GET", "/api/nope")[0] == 404
        assert st.app.dispatch("POST", "/api/nope", {})[0] == 404
    both(tmp_path, sc)


def test_live_http_server(tmp_path):
    """Full socket round trips through ThreadingHTTPServer."""
    def sc(st):
        server, base = st.server()
        seen = []
        try:
            with urllib.request.urlopen(base + "/api/stats",
                                        timeout=30) as r:
                stats = json.loads(r.read())
                assert "total_persons" in stats
                seen.append((r.status, r.headers["Content-Type"], stats))
            req = urllib.request.Request(
                base + "/api/process-visits", data=json.dumps({}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 400
            seen.append((e.value.code, e.value.headers["Content-Type"],
                         json.loads(e.value.read())))
            req = urllib.request.Request(
                base + "/api/process-visits", data=b"{not json",
                headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            seen.append((e.value.code, json.loads(e.value.read())))
            with urllib.request.urlopen(base + "/api/image/missing.jpg",
                                        timeout=30) as r:
                seen.append((r.status, r.headers["Content-Type"],
                             r.headers["Cache-Control"], r.read()))
            with urllib.request.urlopen(base + "/", timeout=30) as r:
                seen.append((r.status, r.headers["Content-Type"],
                             r.read().decode()))
        finally:
            server.shutdown()
            server.server_close()
        return seen
    both(tmp_path, sc)


def test_process_visits_from_api_with_mock_server(tmp_path):
    """The from-API flow against a local mock analytics API."""
    def sc(st):
        url1 = st.store.add("http://imgs/a.jpg", identity=1)
        url2 = st.store.add("http://imgs/b.jpg", identity=2)
        payload = {"list": [
            {"id": "v1", "customerId": "c1", "timestamp": "t1",
             "isEntry": True,
             "faceResponse": {"boxData": {"imageUrl": url1}},
             "entryEventIds": [{"box": OK_BOX}]},
            {"id": "v2", "customerId": "c2", "timestamp": "t2",
             "imageUrl": url2, "entryEventIds": [{"box": OK_BOX}]},
            {"id": "v3", "customerId": "c3"},
        ]}
        paths = []

        class MockAPI(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                paths.append(self.path)
                data = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        server = http.server.HTTPServer(("127.0.0.1", 0), MockAPI)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            status, _, res = st.app.dispatch(
                "POST", "/api/process-visits-from-api",
                {"api_url": f"http://127.0.0.1:{port}/analytics",
                 "save_images": False})
        finally:
            server.shutdown()
            server.server_close()
        assert status == 200, res
        assert res["fetched"] == 2 and res["results"]["new_persons"] == 2
        assert "page=0" in paths[0] and "allBranch=true" in paths[0]
        st.log[-1][2]["api_url"] = "<mock api>"     # its port is random
        return [p.replace(str(port), "<port>") for p in paths]
    both(tmp_path, sc)


def test_process_visits_from_api_requires_url(tmp_path):
    def sc(st):
        assert st.app.dispatch("POST", "/api/process-visits-from-api",
                               {})[0] == 400
    both(tmp_path, sc)


def test_job_progress_endpoint(tmp_path):
    def sc(st):
        status, _, prog = st.app.dispatch("GET", "/api/job-progress")
        assert status == 200
        assert prog == {"status": "idle", "stage": "", "total": 0, "done": 0}
        seed_visits(st, 3)
        _, _, prog = st.app.dispatch("GET", "/api/job-progress")
        assert prog["stage"] == "done"
        assert prog["total"] == 3 and prog["done"] == 3
    both(tmp_path, sc)


def test_image_base64_roundtrip(tmp_path):
    import cv2

    def sc(st):
        img_path = str(st.root / "t.jpg")
        rng = np.random.default_rng(0)
        cv2.imwrite(img_path, rng.integers(0, 255, (40, 40, 3), np.uint8))
        status, _, payload = st.app.dispatch(
            "GET", f"/api/image-base64/{img_path}")
        assert status == 200
        assert payload["image"].startswith("data:image/jpeg;base64,")
        assert st.app.dispatch("GET", "/api/image-base64/nope.jpg")[0] == 404
        big = str(st.root / "big.png")
        cv2.imwrite(big, rng.integers(0, 255, (900, 1600, 3), np.uint8))
        status, _, payload = st.app.dispatch("GET",
                                             f"/api/image-base64/{big}")
        assert status == 200          # scaled down to web_max_size
        (st.root / "bad.jpg").write_bytes(b"not an image")
        status, _, payload = st.app.dispatch(
            "GET", f"/api/image-base64/{st.root / 'bad.jpg'}")
        assert status == 404 and payload == {"error": "Unreadable image"}
    both(tmp_path, sc)


def test_image_base64_through_replaced_reader_and_encoder(tmp_path,
                                                          monkeypatch):
    """Where cv2 is absent (the card's machine), a caller replaces the
    port's reader and encoder; the route serves what they give."""
    calls = []
    monkeypatch.setattr(tweb, "read_image",
                        lambda p: calls.append(p) or np.zeros((4, 6, 3),
                                                              np.uint8))
    monkeypatch.setattr(tweb, "encode_jpeg", lambda img, q, wh: calls.append(
        (img.shape, q, tuple(wh))) or b"jpeg")
    st = Stack("port", tmp_path)
    img = st.root / "x.jpg"
    img.write_bytes(b"")
    status, _, payload = st.app.dispatch("GET", f"/api/image-base64/{img}")
    assert status == 200 and payload == {"image": "data:image/jpeg;base64,"
                                         "anBlZw=="}
    cfg = st.cfg["image_processing"]
    assert calls == [str(img), ((4, 6, 3), cfg["jpeg_quality"],
                                tuple(cfg["web_max_size"]))]
    monkeypatch.setattr(tweb, "encode_jpeg", lambda img, q, wh: None)
    assert st.app.dispatch("GET", f"/api/image-base64/{img}")[:3:2] == (
        500, {"error": "Encode failed"})


def test_concurrent_requests_during_clustering(tmp_path):
    """GETs hammered from many threads while clustering jobs run never
    error, and the state is whole afterwards (the interleaving differs
    run to run, so only the final state is compared)."""
    def sc(st):
        server, base = st.server()
        errors = []

        def post_visits(start):
            visits = [visit(i, st.store.add(f"http://x/c{i}.jpg",
                                            identity=i), box=OK_BOX)
                      for i in range(start, start + 4)]
            req = urllib.request.Request(
                base + "/api/process-visits",
                data=json.dumps({"visits": visits,
                                 "save_images": False}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200

        def hammer(_):
            for path in ("/api/stats", "/api/person-groups",
                         "/api/job-progress", "/api/low-similarity-images"):
                try:
                    with urllib.request.urlopen(base + path,
                                                timeout=10) as r:
                        json.loads(r.read())
                        assert r.status == 200
                except Exception as e:        # noqa: BLE001
                    errors.append((path, repr(e)))

        try:
            with ThreadPoolExecutor(max_workers=8) as pool:
                jobs = [pool.submit(post_visits, s) for s in (30, 60, 90)]
                reads = [pool.submit(hammer, i) for i in range(16)]
                for fut in jobs + reads:
                    fut.result(timeout=60)
        finally:
            server.shutdown()
            server.server_close()
        assert not errors, errors[:5]
        st.log.clear()
        _, _, stats = st.app.dispatch("GET", "/api/stats")
        assert stats["total_persons"] == 12 and stats["total_visits"] == 12
        st.log.clear()
        return stats

    runs = {}
    for name in ("jax", "port"):
        st = Stack(name, tmp_path / name)
        runs[name] = normal(sc(st), st.root)
    assert record_diff(runs["jax"], runs["port"], TOL) is None, runs


def test_image_route_serves_no_image_fallback(tmp_path):
    import cv2

    def sc(st):
        status, ctype, data = st.app.dispatch("GET",
                                              "/api/image/nope/missing.jpg")
        assert status == 200 and ctype == "image/png"
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        p = str(st.root / "real.jpg")
        cv2.imwrite(p, np.zeros((8, 8, 3), np.uint8))
        status, ctype, data = st.app.dispatch("GET", f"/api/image/{p}")
        assert status == 200 and ctype == "image/jpeg" and len(data) > 100
    both(tmp_path, sc)


def test_image_routes_reject_path_traversal(tmp_path):
    def sc(st):
        for path in ("/etc/passwd", "../../etc/passwd",
                     "cache/../../../../etc/passwd"):
            status, ctype, data = st.app.dispatch("GET", f"/api/image/{path}")
            assert ctype == "image/png", path
            assert b"root:" not in (data if isinstance(data, bytes)
                                    else b"")
            assert st.app.dispatch(
                "GET", f"/api/image-base64/{path}")[0] == 404, path
    both(tmp_path, sc)


def test_config_endpoint_redacts_credentials(tmp_path):
    def sc(st):
        (st.root / "api_config.txt").write_text(
            "API_URL=https://api.example.com\nAPI_KEY=supersecret\n"
            "AUTH_TOKEN=jwt-token-value\nSTART_DATE=2025-01-01\n")
        status, _, payload = st.app.dispatch("GET", "/api/config")
        assert status == 200
        cfg = payload["config"]
        assert cfg["API_URL"] == "https://api.example.com"
        assert cfg["START_DATE"] == "2025-01-01"
        assert "supersecret" not in str(payload)
        assert "jwt-token-value" not in str(payload)
    both(tmp_path, sc)


def test_ui_person_drilldown_contract(tmp_path):
    def sc(st):
        html = st.ui.INDEX_HTML
        persons = html.split("activeTab === 'persons'")[1].split(
            "activeTab === 'lowsim'")[0]
        assert "showPerson(" in persons
        assert "'/api/person/' + id" in html
        detail = html.split("async function showPerson")[1]
        for field in ("visit_id", "customer_id", "similarity", "entry_time",
                      "image_url", "saved_image_path", "face_quality",
                      "match_count", "created_at", "last_seen"):
            assert field in detail, field
        assert "renderTab()" in detail
        seed_visits(st, 2)
        _, _, groups = st.app.dispatch("GET", "/api/person-groups")
        pid = groups["groups"][0]["person_id"]
        status, _, person = st.app.dispatch("GET", f"/api/person/{pid}")
        assert status == 200
        for key in ("id", "name", "image_path", "face_quality",
                    "match_count", "created_at", "last_seen", "visits"):
            assert key in person, key
        for v in person["visits"]:
            for key in ("visit_id", "customer_id", "entry_time", "image_url",
                        "saved_image_path", "similarity"):
                assert key in v, key
    both(tmp_path, sc)


def test_comparison_endpoint_returns_rows_and_ui_renders_them(tmp_path):
    def sc(st):
        u1 = st.store.add("http://x/c1.jpg", identity=1)
        u2 = st.store.add("http://x/c2.jpg", identity=1, jitter=1)
        status, _, r = st.app.dispatch(
            "POST", "/api/process-face-comparisons-from-api",
            {"records": [{"id": "v1", "image": u1, "refImage": u2,
                          "isConverted": True,
                          "entryEventIds": [{"fileName": "f.jpg",
                                             "event": "entry",
                                             "camera": "c0",
                                             "eventId": "e1"}]}]})
        assert status == 200 and r["success"]
        assert len(r["comparisons"]) == 1
        assert set(r["comparisons"][0]) == {"fileName", "event", "camera",
                                            "eventId", "approve",
                                            "match_status", "branch_id"}
        assert len(r["confidences"]) == 1
        assert r["confidences"][0]["our_result"] is True
        block = st.ui.INDEX_HTML.split("async function runComparisons")[1]
        for needle in ("match_status", "confidence", "api_vs_our_match",
                       "accuracy_vs_api", "results_file"):
            assert needle in block, needle
    both(tmp_path, sc)


def test_merge_endpoint_returns_pairs(tmp_path):
    def sc(st):
        u1 = st.store.add("http://x/m1.jpg", identity=5)
        u2 = st.store.add("http://x/m2.jpg", identity=6)
        st.app.dispatch("POST", "/api/process-visits",
                        {"visits": [visit(1, u1, box=OK_BOX),
                                    visit(2, u2, box=OK_BOX)],
                         "save_images": False})
        status, _, r = st.app.dispatch("POST", "/api/merge-duplicates",
                                       {"threshold": -1.0})
        assert status == 200 and r["success"]
        assert r["merged"] == len(r["pairs"]) > 0
        for p in r["pairs"]:
            assert set(p) == {"kept", "merged", "name"}
    both(tmp_path, sc)


def test_image_path_percent_decoding(tmp_path):
    import cv2

    def sc(st):
        img_path = str(st.root / "my face.jpg")
        cv2.imwrite(img_path, np.full((64, 64, 3), 128, np.uint8))
        encoded = img_path.replace(" ", "%20")
        status, ctype, data = st.app.dispatch("GET", f"/api/image/{encoded}")
        assert status == 200 and ctype == "image/jpeg" and len(data) > 100
        status, _, payload = st.app.dispatch(
            "GET", f"/api/image-base64/{encoded}")
        assert status == 200
        assert payload["image"].startswith("data:image/jpeg")
    both(tmp_path, sc)


def test_decoded_paths_still_respect_traversal_guard(tmp_path):
    def sc(st):
        status, ctype, _ = st.app.dispatch("GET", "/api/image/%2Fetc%2Fpasswd")
        assert status == 200 and ctype == "image/png"
        assert st.app.dispatch(
            "GET", "/api/image-base64/..%2F..%2F..%2Fetc%2Fpasswd")[0] == 404
    both(tmp_path, sc)


def test_handler_exception_returns_500_json(tmp_path):
    def sc(st):
        st.engine.get_web_stats = lambda: 1 / 0
        status, _, payload = st.app.dispatch("GET", "/api/stats")
        assert status == 500 and "error" in payload
    both(tmp_path, sc)


def test_serving_microbatch_coalesces_concurrent_comparisons(tmp_path):
    """8 concurrent comparison requests over the live server coalesce into
    shared batches (batch width > 1) and answer as the sequential ones;
    both stacks answer alike."""
    n = 8

    def sc(st):
        mb = st.engine.app._microbatcher
        assert mb is not None, "serving.microbatch did not enable the batcher"
        raw = []
        for i in range(n):
            u1 = st.store.add(f"http://x/cmp{i}_a.jpg", identity=i, jitter=0)
            u2 = st.store.add(f"http://x/cmp{i}_b.jpg",
                              identity=(i if i % 2 == 0 else i + 100),
                              jitter=1)
            raw.append({"id": f"r{i}", "image": u1, "refImage": u2,
                        "customerId": f"c{i}"})
        server, base = st.server()

        def post(body):
            req = urllib.request.Request(
                base + "/api/process-face-comparisons-from-api",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        try:
            seq = [post({"records": [raw[i]]})["confidences"][0]
                   for i in range(n)]
            mb.n_batches = mb.n_items = mb.max_batch_seen = 0
            results = [None] * n

            def worker(i):
                results[i] = post({"records": [raw[i]]})["confidences"][0]

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in ts)
        finally:
            server.shutdown()
            server.server_close()
        for s, c in zip(seq, results):
            assert s["comparison_id"] == c["comparison_id"]
            assert s["our_result"] == c["our_result"]
            assert abs(s["confidence"] - c["confidence"]) < 1e-6
        assert mb.max_batch_seen > 1, (mb.n_items, mb.n_batches)
        assert mb.n_batches < mb.n_items
        st.log.clear()           # concurrent: the order is the threads'
        return seq

    both(tmp_path, sc, serving={"microbatch": True,
                                "microbatch_max_wait_ms": 150.0})


# ------------------------------------------------------------------ the page


def test_page_equals_the_jax_page_but_for_the_title_word():
    assert tui.INDEX_HTML != jui.INDEX_HTML
    assert tui.INDEX_HTML.replace("Recognition — CUDA</title>",
                                  "Recognition — TPU</title>") == \
        jui.INDEX_HTML
    assert "<title>Smart Face Recognition — CUDA</title>" in tui.INDEX_HTML


def test_ui_renders_thumbnails_and_progress():
    html = tui.INDEX_HTML
    persons = html.split("activeTab === 'persons'")[1].split(
        "activeTab === 'lowsim'")[0]
    assert '<img class="thumb"' in persons and "loadThumbs" in persons
    assert "/api/image-base64/" in html and "visit-strip" in persons
    assert "/api/job-progress" in html and "pollProgress(true)" in html


def test_ui_has_api_fetch_form():
    html = tui.INDEX_HTML
    assert "fetchVisitsFromApi" in html
    assert "/api/process-visits-from-api" in html
    for field in ("fstart", "fend", "fpage", "flimit"):
        assert field in html


def test_ui_script_structurally_valid():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_ui_js", os.path.join(os.path.dirname(__file__), "..",
                                    "tools", "check_ui_js.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    script = re.search(r"<script>(.*)</script>", tui.INDEX_HTML,
                       re.S).group(1)
    mod.check_js(script)
    assert "const esc" in script and "safeUrl" in script


def test_ui_api_config_panel_and_modal():
    html = tui.INDEX_HTML
    for field in ("capiurl", "cstime", "cetime", "callbranch", "capikey",
                  "cauthtok"):
        assert field in html
    for fn in ("saveApiConfig", "loadApiConfig", "loadApiConfigFromServer",
               "testApiConnection", "toggleApiConfig"):
        assert f"function {fn}" in html
    assert "localStorage.setItem('apiConfig'" in html
    assert "'/api/config'" in html
    fetch_fn = html.split("async function fetchVisitsFromApi")[1]
    assert "apiConfigBody()" in fetch_fn
    body_fn = html.split("function apiConfigBody")[1]
    for key in ("api_url", "start_time", "end_time", "all_branch",
                "api_key", "auth_token"):
        assert key in body_fn
    assert 'id="modal"' in html and 'id="modalimg"' in html
    assert "function openModal" in html and "function closeModal" in html
    assert "openModal(img)" in html.split("async function loadThumbs")[1]


def test_run_web_server_serves_the_given_engine(tmp_path, monkeypatch):
    """``run_web_server`` on an engine it is given: a comparison engine on
    the engine's device and facade, the server on the host and port
    asked, the engine closed once serving ends."""
    st = Stack("port", tmp_path)
    made, closed = [], []

    class Server:
        def __init__(self, app, host, port):
            made.append((app, host, port))

        def serve_forever(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(tweb, "make_server", Server)
    monkeypatch.setattr(st.engine, "close", lambda: closed.append(1))
    with pytest.raises(KeyboardInterrupt):
        tweb.run_web_server(st.engine, host="127.0.0.1", port=0)
    (app, host, port), = made
    assert (host, port, closed) == ("127.0.0.1", 0, [1])
    assert app.engine is st.engine and app.comparison.app is st.engine.app
    assert app.comparison.device == st.engine.device
