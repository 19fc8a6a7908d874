"""The port's clustering engine on the port's facade against the JAX engine
on the JAX facade, both on the committed trained det_500m + w600k_mbf
checkpoints, over 12 synthetic visits (one batch): the decisions (the
SQLite rows, the clustering_results JSON without job ids and clock times,
the gallery's ids) are equal, floats within 1e-4. ``face_hash`` (the md5
of the embedding's bytes) is left out: two stacks' embeddings agree to a
cosine of 0.9999, not to the bit. The visits reach the static route (8
images of one shape) and the dynamic one (4 one-off shapes in one
bucket), and some repeat an earlier image with a little noise, so the
engine assigns as well as creates. Where a deciding similarity or a
detection score lies within 1e-4 of its threshold, a failure says so: a
threshold tie is not a port fault.
"""
import logging
import os
import sys

import numpy as np
import pytest

from scrfd_arcface_facerecognition_tpu.apps.clustering import (
    SmartFaceEngine as JEngine)
from scrfd_arcface_facerecognition_tpu.apps.face_analysis import (
    FaceAnalysis as JFaceAnalysis)
from scrfd_arcface_facerecognition_tpu.utils import config as jcfg
from scrfd_arcface_facerecognition_tpu_torch.apps.clustering import (
    SmartFaceEngine as TEngine)
from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
    FaceAnalysis as TFaceAnalysis)
from scrfd_arcface_facerecognition_tpu_torch.utils import config as tcfg

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from chip_smoke import engine_record, record_diff  # noqa: E402
from test_torch_bf16 import jax_reference  # noqa: E402
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

TOL = 1e-4
CONF = 0.3
OVERRIDES = {
    "face_detection": {"detection_size": [320, 320],
                       "confidence_threshold": CONF},
    "face_recognition": {"similarity_threshold": 0.35,
                         "grouping_threshold_json": 0.55}}


def _msgpack(name):
    from flax import serialization

    with open(os.path.join(_REPO, "checkpoints", "decisions", name),
              "rb") as f:
        return serialization.msgpack_restore(f.read())


def _images():
    """12 visit images: 8 of 240 x 320 (the static route), 4 one-off
    shapes in one 256-px bucket (the dynamic one); visits 6, 7 and 11
    repeat an earlier image with noise."""
    import cv2

    rng = np.random.default_rng(21)

    def smooth(h, w):
        base = rng.integers(0, 255, (max(2, h // 24), max(2, w // 24), 3))
        return cv2.resize(base.astype(np.float32), (w, h)).clip(0, 255)

    base = [smooth(240, 320) for _ in range(6)]
    noisy = [b + rng.normal(0, 6, b.shape) for b in base[:2]]
    oneoff = [smooth(h, w) for h, w in ((200, 150), (180, 240), (97, 131))]
    noisy_oneoff = oneoff[0] + rng.normal(0, 6, oneoff[0].shape)
    imgs = base + noisy + oneoff + [noisy_oneoff]
    return [np.clip(im, 0, 255).astype(np.uint8) for im in imgs]


def _visits(n):
    box = {"width": 90, "height": 120, "top": 300, "left": 300}
    return {"visits": [{
        "id": i, "image": f"http://cam/v{i}.jpg", "customerId": f"c{i}",
        "entryTime": f"2025-01-0{1 + i % 9}T10:00:00", "branchId": "b1",
        "entryEventIds": [{"box": box, "event": "entry",
                           "fileName": f"f{i}.jpg", "camera": "cam1"}]}
        for i in range(n)]}


def _without_hashes(v):
    if isinstance(v, dict):
        return {k: _without_hashes(x) for k, x in v.items()
                if k != "face_hash"}
    if isinstance(v, list):
        return [_without_hashes(x) for x in v]
    return v


@pytest.fixture(scope="module")
def stacks():
    det_v, emb_v = _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")
    kw = dict(det_variant="det_500m", rec_variant="w600k_mbf",
              det_variables=det_v, rec_variables=emb_v, max_det=8)
    ja, ta = JFaceAnalysis(**kw), TFaceAnalysis(device="cpu", **kw)
    for a in (ja, ta):
        a.prepare(det_size=(320, 320), det_thresh=CONF)
    return ja, ta


def _tie_report(apps, images, cfg):
    """Scores and similarities within 1e-4 of a threshold, in either
    stack: the decisions they feed may fall either way."""
    fr = cfg["face_recognition"]
    thresholds = {"similarity": fr["similarity_threshold"],
                  "grouping": fr["grouping_threshold_json"],
                  "duplicate": fr["duplicate_similarity_threshold"]}
    said = []
    for name, app in zip(("jax", "port"), apps):
        faces = app.get_batch(images)
        best = [max(f, key=lambda x: x.det_score) if f else None
                for f in faces]
        for i, f in enumerate(best):
            if f is not None and abs(f.det_score - CONF) <= 1e-4:
                said.append(f"{name} visit {i} det_score {f.det_score}")
        embs = [(i, np.asarray(f.normed_embedding)) for i, f in
                enumerate(best) if f is not None]
        for a, (i, e1) in enumerate(embs):
            for j, e2 in embs[a + 1:]:
                s = float(e1 @ e2)
                for t, v in thresholds.items():
                    if abs(s - v) <= 1e-4:
                        said.append(f"{name} visits {i},{j} cosine {s} at "
                                    f"the {t} threshold {v}")
    return said


def test_engine_decisions_match_jax_on_trained_checkpoints(stacks, tmp_path):
    images = _images()
    by_url = {f"http://cam/v{i}.jpg": im for i, im in enumerate(images)}

    def loader(src, save_path=None, timeout=30):
        im = by_url.get(src)
        return None if im is None else im.copy()

    records, results = {}, {}
    for name, Engine, cfg_mod, app, kw in (
            ("jax", JEngine, jcfg, stacks[0], {}),
            ("port", TEngine, tcfg, stacks[1], dict(device="cpu"))):
        root = tmp_path / name
        cfg = cfg_mod.deep_update(cfg_mod.DEFAULT_CONFIG, {
            **OVERRIDES,
            "system": {"database_path": str(root / "face.db"),
                       "image_cache_dir": str(root / "cache")}})
        eng = Engine(config=cfg, app=app, image_loader=loader,
                     results_dir=str(root / "results"), **kw)
        results[name] = eng.process_visit_data_from_json(
            _visits(len(images)), save_images=False)
        records[name] = _without_hashes(engine_record(eng))
    res = results["port"]
    diff = (record_diff(results["jax"], res, TOL, "results")
            or record_diff(records["jax"], records["port"], TOL))
    if diff:
        ties = _tie_report(stacks, images, cfg)
        pytest.fail(f"{diff}; threshold ties: {ties or 'none'}")
    assert res["no_faces"] < len(images), res      # not all "no face"
    assert res["new_persons"] > 0 and res["recognized"] \
        + res["duplicate_faces"] > 0, res


# ----------------------------------------------------------- at bfloat16
#
# The port's engine on the port's bf16 facade against the JAX engine on
# the JAX bf16 facade (in a child process whose XLA rounds every bf16 op:
# ``tests/test_torch_bf16.py`` ``jax_reference``), on the same checkpoints
# and visits: each visit's decision and the gate that turned a face away
# are equal, the records' floats within 1e-2 (the bf16 budget holds scores
# to 2 ulps of 1, 0.0078, and the quality record's blur score is the score
# times 1.2). The engine's gates are set to turn some of these visits away
# (a confidence gate above the detector's threshold, a side-face decision
# at a score of 2), so that the gates' verdicts are compared, not only the
# faces they let through.

BF16_TOL = 1e-2
GATED = {"face_detection": {"confidence_threshold": 0.39},
         "side_face_detection": {"decision_threshold": 2}}
GATES = (("face confidence too low in: ", "confidence"),
         ("side face rejected in: ", "side face"))


class _Gates:
    """Each visit's gate verdict, from the engine's INFO records."""

    def __init__(self, logger_name):
        self.verdicts = {}
        self.logger = logging.getLogger(logger_name)
        verdicts = self.verdicts

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                for prefix, gate in GATES:
                    if msg.startswith(prefix):
                        verdicts[msg[len(prefix):]] = gate

        self.handler = Handler(logging.INFO)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.verdicts

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _run_engine(Engine, cfg_mod, app, root, images, **kw):
    """One engine over the visits, its gates set by ``GATED``: (results,
    record without hashes, {visit url: gate})."""
    by_url = {f"http://cam/v{i}.jpg": im for i, im in enumerate(images)}

    def loader(src, save_path=None, timeout=30):
        im = by_url.get(src)
        return None if im is None else im.copy()

    cfg = cfg_mod.deep_update(cfg_mod.deep_update(cfg_mod.DEFAULT_CONFIG, {
        **OVERRIDES,
        "system": {"database_path": os.path.join(root, "face.db"),
                   "image_cache_dir": os.path.join(root, "cache")}}), GATED)
    eng = Engine(config=cfg, app=app, image_loader=loader,
                 results_dir=os.path.join(root, "results"), **kw)
    with _Gates(Engine.__module__) as gates:
        res = eng.process_visit_data_from_json(_visits(len(images)),
                                               save_images=False)
    return res, _without_hashes(engine_record(eng)), dict(gates)


def _jsonable(v):
    if isinstance(v, bytes):
        return f"<{len(v)} bytes>"
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(type(v))


def _job_engine_bf16(**images):
    import json
    import tempfile

    import jax.numpy as jnp

    det_v, emb_v = _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")
    ja = JFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                       det_variables=det_v, rec_variables=emb_v, max_det=8,
                       dtype=jnp.bfloat16)
    ja.prepare(det_size=(320, 320), det_thresh=CONF)
    imgs = [images[f"v{i}"] for i in range(len(images))]
    with tempfile.TemporaryDirectory() as tmp:
        res, rec, gates = _run_engine(JEngine, jcfg, ja, tmp, imgs)
    return {"out": np.asarray(json.dumps([res, rec, gates],
                                         default=_jsonable))}


def test_engine_decisions_and_gates_match_jax_at_bf16(tmp_path):
    import json

    import torch

    images = _images()
    ref = jax_reference("test_torch_engine_models", "engine_bf16",
                        **{f"v{i}": im for i, im in enumerate(images)})
    want_res, want_rec, want_gates = json.loads(str(ref["out"]))
    det_v, emb_v = _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")
    ta = TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                       det_variables=det_v, rec_variables=emb_v, max_det=8,
                       dtype=torch.bfloat16, device="cpu")
    ta.prepare(det_size=(320, 320), det_thresh=CONF)
    res, rec, gates = _run_engine(TEngine, tcfg, ta, str(tmp_path),
                                  images, device="cpu")
    res, rec = json.loads(json.dumps([res, rec], default=_jsonable))
    print("bf16 engines, JAX:", {k: want_res[k] for k in (
        "new_persons", "recognized", "duplicate_faces", "no_faces")},
        "gates", want_gates)
    print("bf16 engines, port:", {k: res[k] for k in (
        "new_persons", "recognized", "duplicate_faces", "no_faces")},
        "gates", gates)
    assert gates == want_gates and set(gates.values()) == {
        "confidence", "side face"}, (gates, want_gates)
    diff = (record_diff(want_res, res, BF16_TOL, "results")
            or record_diff(want_rec, rec, BF16_TOL))
    assert diff is None, diff
    assert res["no_faces"] < len(images), res
