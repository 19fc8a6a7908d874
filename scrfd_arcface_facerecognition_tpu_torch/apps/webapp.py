"""Web API server: the clustering and verification engines over HTTP.

The port's own copy of the JAX package's ``apps/webapp.py``, on the port's
``SmartFaceEngine`` and ``FaceComparison``: the same 14 routes, payloads
and status codes, on the standard library's ``ThreadingHTTPServer``.

Routes:
  GET  /                                  HTML UI (``webui.py``)
  GET  /api/stats                         get_web_stats
  GET  /api/config                        api_config.txt, credentials redacted
  GET  /api/person-groups                 person x visits join
  GET  /api/low-similarity-images
  GET  /api/job-progress                  live clustering-job progress
  POST /api/merge-duplicates              G x G dedup + merge
  POST /api/clear-database
  GET  /api/person/{id}                   person + visit detail
  POST /api/process-visits                cluster from JSON body or file
  POST /api/process-face-comparisons-from-api
  POST /api/process-visits-from-api
  GET  /api/image/{path}                  file response w/ cache headers
  GET  /api/image-base64/{path}           downscaled base64 JPEG
  POST /api/clear-cache

    python -m scrfd_arcface_facerecognition_tpu_torch.apps.webapp

serves on ``SAFR_HOST`` / ``SAFR_PORT`` (0.0.0.0:8007), the engines on the
CUDA card; ``run_web_server(device="cpu")`` runs them on the CPU.

The card's machine has no cv2. ``/api/image-base64`` reads and encodes
through the module-level names ``read_image`` and ``encode_jpeg``, which
import cv2 when called and which a caller may replace.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import shutil
import threading
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import unquote, urlparse

from ..utils.config import load_api_config
from .clustering import SmartFaceEngine
from .verification import FaceComparison, build_comparison_results_json
from .webui import INDEX_HTML as _INDEX_HTML

logger = logging.getLogger(__name__)


def read_image(path: str):
    """A BGR u8 image from ``path``, or None where it is not one."""
    import cv2

    return cv2.imread(path)


def encode_jpeg(image, quality: int, max_wh):
    """``image`` scaled down to fit ``max_wh`` (w, h) and JPEG-encoded at
    ``quality``: the JPEG's bytes, or None where encoding fails."""
    import cv2

    max_w, max_h = max_wh
    h, w = image.shape[:2]
    scale = min(max_w / w, max_h / h, 1.0)
    if scale < 1.0:
        image = cv2.resize(image, (int(w * scale), int(h * scale)))
    ok, buf = cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY, quality])
    return buf.tobytes() if ok else None


class WebApp:
    """Route dispatch decoupled from the HTTP transport (unit-testable)."""

    def __init__(self, engine: SmartFaceEngine,
                 comparison: Optional[FaceComparison] = None,
                 api_config_path: str = "api_config.txt",
                 results_dir: str = ".",
                 allowed_image_dirs: Optional[list] = None):
        self.engine = engine
        self.comparison = comparison
        self.api_config_path = api_config_path
        self.results_dir = results_dir
        # image routes serve only from these roots (path-traversal guard;
        # the reference's FileResponse serves any path — fixed here)
        self.allowed_image_dirs = [
            os.path.realpath(d) for d in (
                allowed_image_dirs
                if allowed_image_dirs is not None
                else [os.getcwd(), engine.image_cache_dir, results_dir])]
        self._lock = threading.Lock()

    def _safe_image_path(self, path: str) -> Optional[str]:
        real = os.path.realpath(path)
        for base in self.allowed_image_dirs:
            if real == base or real.startswith(base + os.sep):
                return real
        return None

    # -------------------------------------------------------------- GETs

    def index(self):
        return 200, "text/html", _INDEX_HTML

    def stats(self):
        return 200, None, self.engine.get_web_stats()

    _SECRET_KEY_MARKERS = ("KEY", "TOKEN", "SECRET", "PASSWORD")

    def config(self):
        cfg = load_api_config(self.api_config_path)
        # never hand credentials to unauthenticated clients
        redacted = {k: ("***" if any(m in k.upper()
                                     for m in self._SECRET_KEY_MARKERS)
                        and v else v)
                    for k, v in cfg.items()}
        return 200, None, {"config": redacted, "exists": bool(cfg)}

    def person_groups(self):
        return 200, None, {"groups": self.engine.get_person_groups_for_web()}

    def low_similarity_images(self):
        return 200, None, {"images": self.engine.get_low_similarity_images()}

    def job_progress(self):
        """Live clustering-job progress for the UI's polling loop (the
        reference UI shows processing state while /api/process-visits is
        in flight, templates/index.html progress section)."""
        return 200, None, dict(self.engine.progress)

    def person_detail(self, person_id: int):
        person = self.engine.db.get_person(person_id)
        if person is None:
            return 404, None, {"error": "Person not found"}
        person["visits"] = self.engine.db.visits_for_person(person_id)
        return 200, None, person

    # 1x1 grey PNG: the reference serves static/no-image.png for missing
    # files (smart_face_recognition.py:3334-3360); self-contained here.
    _NO_IMAGE_PNG = base64.b64decode(
        b"iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAYAAAAfFcSJAAAADUlEQVR4nGNg"
        b"uHHjPwAGhgJ/bM0TJAAAAABJRU5ErkJggg==")

    def image_file(self, path: str):
        safe = self._safe_image_path(path)
        if safe is None or not os.path.exists(safe):
            return 200, "image/png", self._NO_IMAGE_PNG
        with open(safe, "rb") as f:
            return 200, "image/jpeg", f.read()

    def image_base64(self, path: str):
        path = self._safe_image_path(path) or ""
        if not path or not os.path.exists(path):
            return 404, None, {"error": "Image not found"}
        img = read_image(path)
        if img is None:
            return 404, None, {"error": "Unreadable image"}
        cfg = self.engine.config["image_processing"]
        data = encode_jpeg(img, cfg["jpeg_quality"], cfg["web_max_size"])
        if data is None:
            return 500, None, {"error": "Encode failed"}
        b64 = base64.b64encode(data).decode()
        return 200, None, {"image": f"data:image/jpeg;base64,{b64}"}

    # ------------------------------------------------------------- POSTs

    def merge_duplicates(self, body: Dict[str, Any]):
        with self._lock:
            merged, pairs = self.engine.find_and_merge_duplicates(
                body.get("threshold"), return_pairs=True)
        return 200, None, {"success": True, "merged": merged,
                           "pairs": pairs,
                           "message": f"Merged {merged} duplicate pairs"}

    def clear_database(self, body):
        with self._lock:
            self.engine.clear_all_data()
        return 200, None, {"success": True,
                           "message": "Database cleared successfully"}

    def process_visits(self, body: Dict[str, Any]):
        max_visits = body.get("max_visits",
                              self.engine.config["processing"]["max_visits_default"])
        save_images = body.get("save_images",
                               self.engine.config["processing"]["save_images_default"])
        clear_existing = body.get("clear_existing", False)
        with self._lock:
            if body.get("visits"):
                results = self.engine.process_visit_data_from_json(
                    body, max_visits=max_visits, save_images=save_images,
                    clear_existing=clear_existing)
            elif body.get("json_file") and os.path.exists(body["json_file"]):
                results = self.engine.process_visit_data(
                    body["json_file"], max_visits=max_visits,
                    save_images=save_images)
            else:
                return 400, None, {"error": "No visits provided"}
        return 200, None, {"success": True, "results": results}

    def process_visits_from_api(self, body: Dict[str, Any]):
        """Fetch visits from the analytics API, then cluster them
        (smart_face_recognition.py:3242-3332 semantics)."""
        cfg = load_api_config(self.api_config_path)
        api_url = body.get("api_url") or cfg.get("API_URL")
        if not api_url:
            return 400, None, {"error": "No API URL configured"}
        visits = self.engine.fetch_visit_data_from_api(
            api_url,
            start_date=body.get("start_date") or cfg.get("START_DATE"),
            end_date=body.get("end_date") or cfg.get("END_DATE"),
            page=body.get("page", 0), limit=body.get("limit", 100),
            start_time=body.get("start_time"), end_time=body.get("end_time"),
            all_branch=body.get("all_branch", True),
            api_key=body.get("api_key") or cfg.get("API_KEY"),
            auth_token=body.get("auth_token") or cfg.get("AUTH_TOKEN"))
        if not visits:
            return 502, None, {"error": "No visits fetched from API",
                               "api_url": api_url}
        with self._lock:
            results = self.engine.process_visit_data_from_json(
                {"visits": visits},
                max_visits=body.get("max_visits"),
                save_images=body.get("save_images", True),
                clear_existing=body.get("clear_existing", False))
        return 200, None, {"success": True, "fetched": len(visits),
                           "results": results}

    def process_face_comparisons_from_api(self, body: Dict[str, Any]):
        if self.comparison is None:
            return 503, None, {"error": "Comparison engine not configured"}
        records = body.get("records")
        if records is None:
            cfg = load_api_config(self.api_config_path)
            api_url = body.get("api_url") or cfg.get("API_URL")
            if not api_url:
                return 400, None, {"error": "No records or API URL"}
            records = self.comparison.fetch_face_comparison_data_from_api(
                api_url, api_key=body.get("api_key") or cfg.get("API_KEY"))
        else:
            records = self.comparison.transform_records(records)
        results = self.comparison.process_face_comparisons(
            records, max_comparisons=body.get("max_comparisons"))
        payload = build_comparison_results_json(results)
        fname = os.path.join(
            self.results_dir,
            f"face_comparison_results_"
            f"{datetime.now().strftime('%Y%m%d_%H%M%S')}.json")
        with open(fname, "w") as f:
            json.dump(payload, f, indent=2)
        return 200, None, {"success": True, "results_file": fname,
                           "summary": {k: results[k] for k in
                                       ("total_comparisons", "processed",
                                        "same_person", "different_person",
                                        "errors")},
                           "accuracy_vs_api": results.get("accuracy_vs_api", 0),
                           # per-comparison rows for the UI's result table
                           # (the same field set the results file pins)
                           "comparisons": payload["comparisons"],
                           "confidences": [
                               {"comparison_id": r["comparison_id"],
                                "confidence": r["confidence"],
                                "our_result": r["our_result"],
                                "api_vs_our_match": r["api_vs_our_match"],
                                "error": r["error"]}
                               for r in results["results"]]}

    def clear_cache(self, body):
        cache_dir = self.engine.image_cache_dir
        if os.path.exists(cache_dir):
            shutil.rmtree(cache_dir)
            os.makedirs(cache_dir, exist_ok=True)
        return 200, None, {"success": True, "message": "Cache cleared"}

    # ----------------------------------------------------------- routing

    def dispatch(self, method: str, path: str, body: Optional[Dict] = None):
        """(status, content_type|None, payload). payload dict -> JSON.

        A handler exception returns a 500 JSON error instead of propagating
        (which would reset the HTTP connection with no response); the
        traversal guard runs on the decoded path, so decoding cannot widen
        what the image routes serve.
        """
        try:
            return self._dispatch(method, path, body)
        except Exception as e:
            logger.exception("handler error on %s %s", method, path)
            return 500, None, {"error": f"Internal error: {e}"}

    def _dispatch(self, method: str, path: str, body: Optional[Dict] = None):
        body = body or {}
        # the UI requests image routes through encodeURI (webui.py), so
        # %-escapes (spaces, unicode) must be decoded before path lookup
        path = unquote(path)
        if method == "GET":
            if path == "/":
                return self.index()
            if path == "/api/stats":
                return self.stats()
            if path == "/api/config":
                return self.config()
            if path == "/api/person-groups":
                return self.person_groups()
            if path == "/api/low-similarity-images":
                return self.low_similarity_images()
            if path == "/api/job-progress":
                return self.job_progress()
            if path.startswith("/api/person/"):
                try:
                    return self.person_detail(int(path.rsplit("/", 1)[1]))
                except ValueError:
                    return 400, None, {"error": "Invalid person id"}
            if path.startswith("/api/image-base64/"):
                return self.image_base64(path[len("/api/image-base64/"):])
            if path.startswith("/api/image/"):
                return self.image_file(path[len("/api/image/"):])
        elif method == "POST":
            if path == "/api/merge-duplicates":
                return self.merge_duplicates(body)
            if path == "/api/clear-database":
                return self.clear_database(body)
            if path == "/api/process-visits":
                return self.process_visits(body)
            if path == "/api/process-visits-from-api":
                return self.process_visits_from_api(body)
            if path == "/api/process-face-comparisons-from-api":
                return self.process_face_comparisons_from_api(body)
            if path == "/api/clear-cache":
                return self.clear_cache(body)
        return 404, None, {"error": "Not found"}


def make_server(app: WebApp, host: str = "0.0.0.0", port: int = 8007
                ) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, content_type, payload):
            if isinstance(payload, (dict, list)):
                data = json.dumps(payload).encode()
                content_type = content_type or "application/json"
            elif isinstance(payload, str):
                data = payload.encode()
                content_type = content_type or "text/html"
            else:
                data = payload
                content_type = content_type or "application/octet-stream"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            if content_type.startswith("image/"):
                max_age = app.engine.config["web_interface"][
                    "cache_control_max_age"]
                self.send_header("Cache-Control", f"max-age={max_age}")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path
            self._send(*app.dispatch("GET", path))

        def do_POST(self):
            path = urlparse(self.path).path
            length = int(self.headers.get("Content-Length", 0))
            body = {}
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self._send(400, None, {"error": "Invalid JSON"})
                    return
            self._send(*app.dispatch("POST", path, body))

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    return ThreadingHTTPServer((host, port), Handler)


def run_web_server(engine: Optional[SmartFaceEngine] = None,
                   host: str = "0.0.0.0", port: int = 8007,
                   device=None) -> None:
    """Serve the engine (built on ``device``, the CUDA card unless
    "cpu", when none is given) until interrupted; the gallery is
    persisted on the way out."""
    engine = engine or SmartFaceEngine(device=device)
    app = WebApp(engine, comparison=FaceComparison(
        config=engine.config, app=engine.app, device=engine.device))
    server = make_server(app, host, port)
    logger.info("Serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        # persist the gallery on shutdown (no-op unless
        # vector_database.snapshot_path is configured)
        engine.close()


def main():
    logging.basicConfig(level=logging.INFO)
    if not os.path.exists("config.json"):
        print("Note: missing optional files ['config.json']; using defaults")
    host = os.environ.get("SAFR_HOST", "0.0.0.0")
    port = int(os.environ.get("SAFR_PORT", "8007"))
    print("Starting Smart Face Recognition web server (CUDA)")
    print(f"  http://{host}:{port}")
    run_web_server(host=host, port=port)


if __name__ == "__main__":
    main()
