"""Replay a visits JSON through the clustering engine, offline.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.replay_visits \
        [--max-visits 149] [--det det_10g] [--rec w600k_r50] \
        [--workdir DIR] [--visits-json FILE] [--image-cache DIR] \
        [--device cpu]

Port of the JAX repository's ``tools/replay_visits.py``. The reference
ships its real workload as ``visit-cluster.json`` (149 visits with CDN
image URLs) and ``image_cache/`` (the downloaded crops, named
md5(url).jpg). This tool runs such a batch through the clustering
engine with a loader that serves the cached files instead of the network:
detect, gates, embed (kernel K1 warps every face's crop on the card),
batched gallery search, SQLite and JSON persistence, with zero egress.
It prints the JAX tool's JSON line (``results``, ``visits_handled``,
``seconds``, ``visits_per_sec``, ``workdir``).

The defaults read ``reference/`` in the repository, where the reference's
files go once they are committed. ``run(visits, app, loader, workdir,
max_visits)`` is the replay itself, for callers with their own facade and
an in-memory loader (the card's machine has no cv2 to read JPEGs); only
``main`` changes the working directory, as the JAX tool does. The JAX
tool's XLA compile cache has no counterpart here.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time
from typing import Callable, Mapping, Optional

from .host_images import imread, imwrite

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(_REPO_ROOT, "reference")

HANDLED = ("processed", "no_faces", "low_quality", "download_failed",
           "duplicate_faces")


def cache_name(source: str) -> str:
    """The cache's file name of an image URL: md5(url).jpg."""
    return hashlib.md5(source.encode()).hexdigest() + ".jpg"


def cached_loader(cache_dir: str):
    """An engine image loader that reads ``cache_dir/md5(url).jpg`` (None
    where the file is missing) and copies it to ``save_path`` when asked.
    Reading the JPEGs needs cv2."""
    def load(source: str, save_path=None):
        path = os.path.join(cache_dir, cache_name(source))
        if not os.path.exists(path):
            return None
        img = imread(path)
        if img is not None and save_path:
            imwrite(save_path, img)
        return img

    return load


def run(visits: Mapping, app, loader: Callable, workdir: str,
        max_visits: Optional[int] = None) -> dict:
    """The visits payload (``{"visits": [...]}``) through a
    ``SmartFaceEngine`` on ``app`` (its device) with ``loader``, its
    database and results under ``workdir``. Returns the JAX tool's line
    as a dict, and the engine under ``"engine"``. The engine's settings
    are ``config.json`` of the working directory, or the defaults, with
    its image cache under ``workdir``."""
    from ..apps.clustering import SmartFaceEngine
    from ..utils.config import load_config

    os.makedirs(workdir, exist_ok=True)
    cfg = load_config("config.json")
    cfg["system"]["image_cache_dir"] = os.path.join(workdir, "image_cache")
    engine = SmartFaceEngine(database_path=os.path.join(workdir,
                                                        "replay.db"),
                             app=app, image_loader=loader, config=cfg,
                             results_dir=os.path.join(workdir, "results"),
                             device=app.device)
    t0 = time.time()
    results = engine.process_visit_data_from_json(
        visits, max_visits=max_visits, save_images=False)
    dt = time.time() - t0
    n = sum(results[k] for k in HANDLED)
    return {"results": results, "visits_handled": n,
            "seconds": round(dt, 1),
            "visits_per_sec": round(n / max(dt, 1e-9), 2),
            "workdir": workdir, "engine": engine}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-visits", type=int, default=149)
    ap.add_argument("--det", type=str, default="det_10g")
    ap.add_argument("--rec", type=str, default="w600k_r50")
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--visits-json", type=str,
                    default=os.path.join(REF, "visit-cluster.json"))
    ap.add_argument("--image-cache", type=str,
                    default=os.path.join(REF, "image_cache"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    visits_json = os.path.abspath(args.visits_json)
    image_cache = os.path.abspath(args.image_cache)
    workdir = os.path.abspath(args.workdir
                              or tempfile.mkdtemp(prefix="replay_"))
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)

    from ..apps.face_analysis import FaceAnalysis

    app = FaceAnalysis(det_variant=args.det, rec_variant=args.rec,
                       device=args.device)
    app.prepare(det_size=(640, 640))
    with open(visits_json) as f:
        data = json.load(f)
    out = run(data, app, cached_loader(image_cache), workdir,
              args.max_visits)
    out.pop("engine")
    print(json.dumps(out))
    return out["results"]


if __name__ == "__main__":
    main()
