"""The port's host and learning tools against the JAX repository's tools of
the same names (``tools/exp_microbatch.py``, ``exp_convergence.py``,
``bench_ingest.py``), on the CPU, on the same seeds, at small sizes.

The JAX tools are loaded from ``tools/`` by path and run through their
functions or their ``main`` (argv replaced, their output read back); what
they hand the JAX package (images, batches, states, pairs) is caught by
wrapping its classes and functions. Tolerances:

- the data: bit-equal (the identity bases and images, the held-out pairs
  and every training batch, the detection set's images and every
  ``Annotation`` field, the request images, the synthetic capture's
  frames against ``make_video``'s);
- ``exp_microbatch``: det_500m + w600k_mbf (the committed trained
  checkpoints, the same Flax trees in both facades) at det size 128, 8
  requests of 128 x 128 from 4 threads, both modes: every request's faces
  within the f32 budget of the root ``PERF.md`` §2 (face count equal,
  boxes and keypoints 1e-2 px, scores 1e-4, embedding cosine >= 0.9999);
  the coalescing is timing-bound, so its ``batches`` and ``widest`` are
  held to their range (1 <= batches <= requests, widest <= the collector's
  32), not to JAX's; every JSON key of the JAX tool's lines;
- ``exp_convergence``: from JAX's initial state (``train_state_from_jax``,
  ``scrfd_train_state_from_jax``), 2 steps, eval every step, batch 8,
  SCRFD at 128: the step-0 accuracy and AP equal, and each step's loss
  within 1e-5 relative, the float32 first-step tolerance of
  ``tests/test_torch_train.py`` and ``tests/test_torch_scrfd_train.py``
  (the warm-up's lr(0) is 0, so the second step's loss is taken at the
  first step's weights, as well conditioned). Tier-1 swaps both packages'
  "w600k_mbf" and "det_500m" entries for small configs; the full-width
  models run in a slow test (JAX's full-width w600k_mbf takes minutes a
  step and eval on the CPU);
- ``bench_ingest``: on a cv2-written 64 x 48 clip of 12 frames, streams
  1 and 2: every row's path, streams, workers and frame count equal to the
  JAX tool's table, and the frames each path yields equal to JAX's by
  checksum (a hash a frame, over each row); the synthetic source's
  ``DecodePool`` opener imports no torch in the worker.
"""
import hashlib
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import jax
import torch

from scrfd_arcface_facerecognition_tpu import parallel as jparallel
from scrfd_arcface_facerecognition_tpu import train as jtrain
from scrfd_arcface_facerecognition_tpu.models import arcface as jarc
from scrfd_arcface_facerecognition_tpu.models import scrfd as jscrfd
from scrfd_arcface_facerecognition_tpu.runtime import decode_pool as jdp
from scrfd_arcface_facerecognition_tpu.runtime import video as jvideo
from scrfd_arcface_facerecognition_tpu_torch import train as ttrain
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as tarc
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as tscrfd
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    scrfd_train_state_from_jax, train_state_from_jax)
from scrfd_arcface_facerecognition_tpu_torch.runtime import (
    decode_pool as tdp, video as tvideo)
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    bench_ingest, exp_convergence, exp_microbatch)
from test_torch_facade import assert_faces_agree
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CKPT = os.path.join(_REPO, "checkpoints", "decisions")
LOSS_RTOL = 1e-5


def _jax_tool(name):
    """The JAX repository's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bit_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ----------------------------------------------------------------- the data


def test_identity_data_is_bit_equal_to_jax():
    jt = _jax_tool("exp_convergence")
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    bj, bt = jt.make_identity_bases(rj, 50), exp_convergence.\
        make_identity_bases(rt, 50)
    _bit_equal(bj, bt)
    for i in (0, 7, 49):
        _bit_equal(jt.identity_image(bj[i], rj),
                   exp_convergence.identity_image(bt[i], rt))
    _bit_equal(rj.random(4), rt.random(4))     # the draws stay in step


@pytest.mark.parametrize("size", [128, 320])
def test_detection_set_is_bit_equal_to_jax(size):
    jt = _jax_tool("exp_convergence")
    ji, ja = jt.make_detection_set(np.random.default_rng(0), size=size)
    ti, ta = exp_convergence.make_detection_set(np.random.default_rng(0),
                                                size=size)
    assert len(ji) == len(ti) == 16
    for a, b in zip(ji, ti):
        _bit_equal(a, b)
    for a, b in zip(ja, ta):
        assert a.path == b.path
        for field in ("boxes", "kps", "kps_valid"):
            _bit_equal(getattr(a, field), getattr(b, field))


class _FakeBatcher:
    n_batches, max_batch_seen = 3, 2


class _FakeApp:
    """A facade that answers every request with no face and records the
    images it was given."""
    seen = []

    def __init__(self, *a, **k):
        self.device = torch.device("cpu")

    def get(self, image, max_num=0):
        _FakeApp.seen.append(image)
        return []

    def enable_microbatch(self, max_batch=32, max_wait_ms=4.0):
        return _FakeBatcher()

    def disable_microbatch(self):
        pass


def test_microbatch_images_and_lines_match_jax(monkeypatch, capsys):
    """Both tools' ``main`` with the facade replaced: the request images
    bit-equal, every JSON key of the JAX tool's lines, in the same order."""
    from scrfd_arcface_facerecognition_tpu.apps import face_analysis as jfa
    from scrfd_arcface_facerecognition_tpu.utils import compile_cache
    from scrfd_arcface_facerecognition_tpu_torch.apps import (
        face_analysis as tfa)

    jt = _jax_tool("exp_microbatch")
    monkeypatch.setattr(jfa, "FaceAnalysis", _FakeApp)
    monkeypatch.setattr(tfa, "FaceAnalysis", _FakeApp)
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    argv = ["--requests", "6", "--threads", "3", "--size", "32"]
    monkeypatch.setattr(sys, "argv", ["exp_microbatch.py"] + argv)
    _FakeApp.seen = []
    capsys.readouterr()
    assert jt.main() == 0
    jax_lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    jax_seen = _FakeApp.seen
    _FakeApp.seen = []
    assert exp_microbatch.main(argv + ["--device", "cpu"]) == 0
    port_lines = [json.loads(x)
                  for x in capsys.readouterr().out.splitlines()]
    assert len(jax_seen) == len(_FakeApp.seen) == 4 * 6
    # every request image, bit for bit (the threads take them in any order)
    assert {(im.shape, im.dtype.str, im.tobytes()) for im in jax_seen} == {
        (im.shape, im.dtype.str, im.tobytes())
        for im in exp_microbatch.make_images(6, 32)}
    assert len({im.tobytes() for im in _FakeApp.seen}) == 6
    assert [list(x) for x in jax_lines] == [list(x) for x in port_lines]
    for j, t in zip(jax_lines, port_lines):
        for k in ("mode", "threads", "requests", "batches", "widest"):
            assert j.get(k) == t.get(k), k


def _msgpack(name):
    from flax import serialization

    with open(os.path.join(_CKPT, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def trained_apps():
    import jax.numpy as jnp

    from scrfd_arcface_facerecognition_tpu.apps.face_analysis import (
        FaceAnalysis as JFaceAnalysis)
    from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
        FaceAnalysis as TFaceAnalysis)

    kw = dict(det_variant="det_500m", rec_variant="w600k_mbf",
              det_variables=_msgpack("det_500m.msgpack"),
              rec_variables=_msgpack("w600k_mbf.msgpack"))
    ja = JFaceAnalysis(dtype=jnp.float32, **kw)
    ta = TFaceAnalysis(device="cpu", **kw)
    for a in (ja, ta):
        a.prepare(det_size=(128, 128))
    return ja, ta


@pytest.mark.parametrize("micro", [False, True], ids=["batch1", "coalesced"])
def test_microbatch_run_mode_matches_jax(trained_apps, micro):
    ja, ta = trained_apps
    jt = _jax_tool("exp_microbatch")
    images = exp_microbatch.make_images(8, 128)
    index = {id(im): i for i, im in enumerate(images)}
    jax_faces = [None] * len(images)
    get = ja.get

    def recorded(image, max_num=0):
        out = get(image, max_num=max_num)
        jax_faces[index[id(image)]] = out
        return out

    ja.get = recorded
    try:
        _, jax_stats = jt.run_mode(ja, images, 4, micro, 4.0)
    finally:
        del ja.get
    fps, stats, faces = exp_microbatch.run_mode(ta, images, 4, micro, 4.0)
    assert fps > 0 and set(stats) == set(jax_stats)
    if micro:
        assert 1 <= stats["batches"] <= len(images)
        assert 1 <= stats["widest"] <= 32
    assert sum(len(f) for f in faces) > 0
    assert_faces_agree(jax_faces, faces, "coalesced" if micro else "batch-1")
    assert ta._microbatcher is None


# ---------------------------------------------------------- exp_convergence


TINY_ARC = dict(name="w600k_mbf", arch="mobilefacenet",
                mbf_blocks=(1, 1, 1, 1), mbf_stem_filters=8,
                mbf_stem_dw_groups=8, mbf_stage_filters=(8, 16, 16),
                mbf_down_groups=(16, 16, 32), mbf_res_groups=(16,) * 4,
                mbf_sep_filters=32)
TINY_DET = dict(name="det_500m", stem_filters=8, stage_blocks=(1, 1, 1, 1),
                stage_filters=(8, 8, 16, 16), neck_filters=8, head_stacks=1,
                head_filters=16)


def _record(monkeypatch, module, name, seen, parts):
    """Replace ``module.<name>`` (a trainer class) by a subclass that keeps
    its initial state (carried to the port's parts by ``parts``), every
    batch it trains on and every loss."""
    base = getattr(module, name)

    class Recording(base):
        def init_state(self, *a, **k):
            state = super().init_state(*a, **k)
            seen["start"] = parts(jax.tree.map(np.asarray, state))
            return state

        def state_from(self, *a, **k):
            seen["from"] = True
            return super().state_from(*a, **k)

        def train_step(self, state, images, *rest):
            seen.setdefault("batches", []).append(
                [np.array(x) for x in (images,) + tuple(rest)])
            out = super().train_step(state, images, *rest)
            seen.setdefault("losses", []).append(float(out[1]))
            return out

    monkeypatch.setattr(module, name, Recording)


def _record_eval(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def recorded(*a, **k):
        seen.setdefault("evals", []).append(a[-1] if name ==
                                            "evaluate_embedder" else a[1])
        return fn(*a, **k)

    monkeypatch.setattr(module, name, recorded)


def _convergence_against_jax(monkeypatch, tiny):
    jt = _jax_tool("exp_convergence")
    if tiny:
        monkeypatch.setitem(jarc.ARCFACE_CONFIGS, "w600k_mbf",
                            jarc.ArcFaceConfig(**TINY_ARC))
        monkeypatch.setitem(tarc.ARCFACE_CONFIGS, "w600k_mbf",
                            tarc.ArcFaceConfig(**TINY_ARC))
        monkeypatch.setitem(jscrfd.SCRFD_CONFIGS, "det_500m",
                            jscrfd.SCRFDConfig(**TINY_DET))
        monkeypatch.setitem(tscrfd.SCRFD_CONFIGS, "det_500m",
                            tscrfd.SCRFDConfig(**TINY_DET))
    # the JAX tool's mesh over one slot of the CPU
    make_mesh = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh", lambda sizes, names: make_mesh(
        tuple(1 for _ in sizes), names, devices=jax.devices()[:1]))
    jax_seen = {"arc": {}, "det": {}}
    port_seen = {"arc": {}, "det": {}}
    for pkg, seen in ((jtrain, jax_seen), (ttrain, port_seen)):
        _record(monkeypatch, pkg, "ArcFaceTrainer", seen["arc"],
                train_state_from_jax)
        _record(monkeypatch, pkg, "SCRFDTrainer", seen["det"],
                scrfd_train_state_from_jax)
        _record_eval(monkeypatch, pkg, "evaluate_embedder", seen["arc"])
        _record_eval(monkeypatch, pkg, "evaluate_detector", seen["det"])
    jax_arc = jt.run_arcface(2, 1, 8)
    jax_det = jt.run_scrfd(2, 1, 8, size=128)
    lines = []
    arc = exp_convergence.run_arcface(2, 1, 8, device="cpu",
                                      start=jax_seen["arc"]["start"],
                                      emit=lines.append)
    det = exp_convergence.run_scrfd(2, 1, 8, size=128, device="cpu",
                                    start=jax_seen["det"]["start"],
                                    emit=lines.append)
    for name, j, t, js, ts in (("arc", jax_arc, arc, jax_seen["arc"],
                                port_seen["arc"]),
                               ("det", jax_det, det, jax_seen["det"],
                                port_seen["det"])):
        assert ts.get("from") and "start" not in ts, name
        assert [s for s, _ in t["curve"]] == [s for s, _ in j] == [0, 1, 2]
        assert t["curve"][0][1] == j[0][1], (name, t["curve"], j)
        assert len(t["losses"]) == len(js["losses"]) == 2
        for got, want in zip(t["losses"], js["losses"]):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (name, got,
                                                               want)
        # the training batches, NHWC in JAX and NCHW in the port
        assert len(ts["batches"]) == len(js["batches"]) == 2
        for bt, bj in zip(ts["batches"], js["batches"]):
            _bit_equal(bt[0].transpose(0, 2, 3, 1), bj[0])
            for x, y in zip(bt[1:], bj[1:]):
                np.testing.assert_array_equal(x, y)
        assert len(ts["evals"]) == len(js["evals"]) == 3
    # the held-out pairs and the annotations each eval scored
    for pt, pj in zip(port_seen["arc"]["evals"][0],
                      jax_seen["arc"]["evals"][0]):
        _bit_equal(pt[0], pj[0])
        _bit_equal(pt[1], pj[1])
        assert pt[2] == pj[2]
    for at, aj in zip(port_seen["det"]["evals"][0],
                      jax_seen["det"]["evals"][0]):
        _bit_equal(at.boxes, aj.boxes)
    jax_keys = {"curve", "step", "value", "loss", "elapsed_s"}
    assert [set(x) for x in lines] == (
        [{"curve", "step", "value"}] + [jax_keys | {"ms_step"}] * 2) * 2


def test_convergence_matches_jax_from_its_state_on_small_models(
        monkeypatch):
    _convergence_against_jax(monkeypatch, tiny=True)


@pytest.mark.slow
def test_convergence_matches_jax_from_its_state_at_full_width(monkeypatch):
    _convergence_against_jax(monkeypatch, tiny=False)


def test_convergence_main_takes_the_jax_tools_flags(monkeypatch):
    calls = []
    monkeypatch.setattr(exp_convergence, "run_arcface",
                        lambda *a, **k: calls.append(("arc", a, k)))
    monkeypatch.setattr(exp_convergence, "run_scrfd",
                        lambda *a, **k: calls.append(("det", a, k)))
    assert exp_convergence.main(["--arc-steps", "7", "--det-steps", "9",
                                 "--eval-every", "3", "--batch", "40",
                                 "--device", "cpu"]) == 0
    assert calls == [("arc", (7, 3, 40), {"device": "cpu"}),
                     ("det", (9, 3, 10), {"device": "cpu"})]
    calls.clear()
    assert exp_convergence.main(["--only", "det", "--device", "cpu"]) == 0
    assert calls == [("det", (400, 50, 8), {"device": "cpu"})]


# ------------------------------------------------------------- bench_ingest

W, H, FRAMES = 64, 48, 12


def _digest(frame):
    return hashlib.sha1(np.ascontiguousarray(frame).tobytes()).hexdigest()


class _Tap:
    """Each row's frame hashes: the raw-decode rows' from the capture, the
    readers' and the pool's from the batches they yield."""

    def __init__(self):
        self.rows, self.current = [], None

    def bench(self, fn):
        def wrapped(*a, **k):
            self.current = (fn.__name__, [])
            try:
                return fn(*a, **k)
            finally:
                self.rows.append((self.current[0],
                                  sorted(self.current[1])))
                self.current = None
        return wrapped

    def frames(self, kind, frames):
        if self.current is not None and (
                (kind == "capture") == (self.current[0] ==
                                        "bench_raw_decode")):
            self.current[1].extend(_digest(f) for f in frames)


class _TappedCapture:
    def __init__(self, cap, tap):
        self._cap, self._tap = cap, tap
        if hasattr(cap, "read_into"):
            self.read_into = self._read_into

    def __getattr__(self, name):
        return getattr(self._cap, name)

    def read(self):
        ok, f = self._cap.read()
        if ok:
            self._tap.frames("capture", [f])
        return ok, f

    def _read_into(self, buf):
        ok = self._cap.read_into(buf)
        if ok:
            self._tap.frames("capture", [buf[:self._cap.height,
                                             :self._cap.width]])
        return ok


def _tap_iterators(monkeypatch, tap, classes):
    for cls in classes:
        it = cls.__iter__

        def tapped(self, _it=it):
            for item in _it(self):
                batch = item[0] if isinstance(item, tuple) else item
                tap.frames("batch", list(batch))
                yield item

        monkeypatch.setattr(cls, "__iter__", tapped)


def _table(text):
    """The markdown table's rows as (path, streams, workers, frames)."""
    rows = []
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 5 and cells[1].isdigit():
            rows.append((cells[0], int(cells[1]), cells[2], int(cells[4])))
    return rows


def test_ingest_rows_and_frames_match_jax(monkeypatch, capsys, tmp_path):
    pytest.importorskip("cv2")
    clip = str(tmp_path / f"ingest_bench_{W}x{H}_mp4v_{FRAMES}.mp4")
    assert bench_ingest.make_video(clip, W, H, FRAMES)
    jt = _jax_tool("bench_ingest")
    jax_tap, port_tap = _Tap(), _Tap()
    # the JAX tool's main names its clip under /tmp: every bench function
    # is handed this clip instead, and its os sees the clip as written
    for name in ("bench_raw_decode", "bench_batched_reader",
                 "bench_multistream", "bench_pool"):
        fn = jax_tap.bench(getattr(jt, name))
        monkeypatch.setattr(jt, name, lambda path, *a, _fn=fn, **k: _fn(
            clip, *a, **k))
        monkeypatch.setattr(bench_ingest, name, port_tap.bench(
            getattr(bench_ingest, name)))
    monkeypatch.setattr(jt, "os", types.SimpleNamespace(
        path=types.SimpleNamespace(exists=lambda p: True),
        cpu_count=os.cpu_count))
    open_j = jvideo.open_capture
    monkeypatch.setattr(jvideo, "open_capture",
                        lambda src: _TappedCapture(open_j(src), jax_tap))
    open_t = tvideo.open_capture
    monkeypatch.setattr(tvideo, "open_capture",
                        lambda src: _TappedCapture(open_t(src), port_tap))
    _tap_iterators(monkeypatch, jax_tap, (jvideo.BatchedFrameReader,
                                          jvideo.MultiStreamReader,
                                          jdp.DecodePool))
    _tap_iterators(monkeypatch, port_tap, (tvideo.BatchedFrameReader,
                                           tvideo.MultiStreamReader,
                                           tdp.DecodePool))
    argv = ["--res", f"{W}x{H}", "--frames", str(FRAMES), "--streams", "1,2"]
    monkeypatch.setattr(sys, "argv", ["bench_ingest.py"] + argv)
    capsys.readouterr()
    assert jt.main() == 0
    jax_rows = _table(capsys.readouterr().out)
    assert bench_ingest.main(argv + ["--video-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    port_rows = _table(out)
    cores = os.cpu_count()
    assert jax_rows == port_rows
    assert len(port_rows) == 4 + sum(1 + len({1, min(2, cores),
                                              min(ns, cores)})
                                     for ns in (1, 2))
    assert all(n == ns * FRAMES for _, ns, _, n in port_rows)
    assert [name for name, _ in port_tap.rows] == [
        name for name, _ in jax_tap.rows]
    for (name, got), (_, want) in zip(port_tap.rows, jax_tap.rows):
        assert got and got == want, name
    assert f"{W}x{H} mp4v, {FRAMES} frames/stream, {cores}-core host" in out
    assert "No core budget: give --device-fps" in out


def test_ingest_budget_comes_from_the_given_device_fps(capsys):
    assert bench_ingest.main(["--res", f"{W}x{H}", "--frames", "4",
                              "--streams", "1", "--source", "synthetic",
                              "--device-fps", "841.22"]) == 0
    out = capsys.readouterr().out
    rows = _table(out)
    assert rows and all(name.endswith("[synthetic, no codec]")
                        for name, *_ in rows)
    assert "synthetic frames drawn at read time, no codec" in out
    zc = next(r for r in out.splitlines() if "zero-copy ring" in r)
    fps = float(zc.split("|")[4])
    assert (f"a card at 841 fps needs ceil(841/{fps:.0f}) = "
            f"{bench_ingest.decode_cores(841.22, fps)} decode cores") in out
    assert "758" not in out


class _RecordingWriter:
    frames = []

    def __init__(self, *a):
        pass

    def isOpened(self):
        return True

    def write(self, frame):
        _RecordingWriter.frames.append(frame.copy())

    def release(self):
        pass


def test_synthetic_capture_draws_make_videos_frames(monkeypatch):
    """The synthetic source's frames, by ``read`` and by ``read_into``,
    equal the frames the JAX tool's ``make_video`` hands its writer (and
    the port's ``make_video``)."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(cv2, "VideoWriter", _RecordingWriter)
    jt = _jax_tool("bench_ingest")
    w, h, n = 260, 150, 9
    _RecordingWriter.frames = []
    assert jt.make_video("unused.mp4", w, h, n)
    want, _RecordingWriter.frames = _RecordingWriter.frames, []
    assert bench_ingest.make_video("unused.mp4", w, h, n)
    assert len(want) == len(_RecordingWriter.frames) == n
    for a, b in zip(want, _RecordingWriter.frames):
        _bit_equal(a, b)
    cap = bench_ingest.open_source(bench_ingest.synthetic_source(w, h, n))
    assert (cap.get(3), cap.get(4), cap.isOpened()) == (w, h, True)
    buf = np.zeros((h + 3, w, 3), np.uint8)
    for i, f in enumerate(want):
        if i % 2:
            ok, got = cap.read()
        else:
            ok = cap.read_into(buf)
            got = buf.reshape(-1)[:h * w * 3].reshape(h, w, 3)
        assert ok
        _bit_equal(got, f)
    assert cap.read() == (False, None) and not cap.read_into(buf)
    assert len({_digest(f) for f in want}) == n       # the squares move


def test_the_ingest_opener_imports_no_torch_in_a_worker():
    """``open_source`` as a ``DecodePool`` opener: the worker decodes the
    synthetic frames, and (through ``pool_openers.ingest_probe``, which
    imports and calls it there) has imported no torch."""
    import pool_openers

    src = bench_ingest.synthetic_source(32, 24, 3)
    pool = tdp.DecodePool([src, src], workers=1, slot_bytes=32 * 24 * 3,
                          timeout_ms=8000, opener=bench_ingest.open_source)
    rounds = list(pool)
    pool.release()
    cap = bench_ingest.open_source(src)
    want = [cap.read()[1] for _ in range(3)]
    assert [ids for _, ids in rounds] == [[0, 1]] * 3
    for (batch, _), f in zip(rounds, want):
        _bit_equal(batch[0], f)
        _bit_equal(batch[1], f)
    pool = tdp.DecodePool([src], workers=1, slot_bytes=32 * 24 * 3,
                          timeout_ms=8000, opener=pool_openers.ingest_probe)
    rounds = list(pool)
    pool.release()
    assert len(rounds) == 3
    assert int(rounds[0][0][0, 0, 0, 0]) == 0          # no torch there
    assert int(rounds[0][0][0, 0, 0, 1]) == 1          # the opener's was
