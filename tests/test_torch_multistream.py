"""The port's multi-camera apps (``apps/multistream.py``, ``dualstream.py``)
against the JAX package's (CPU).

- Both apps' parsers: the same dests and defaults.
- ``connect_to_camera`` tries its attempts, then raises as the JAX one
  does.
- Each app run on three seeded cv2-written clips of different sizes (one
  ends early) and a faces directory, on the committed trained det_500m +
  w600k_mbf at bf16, against the JAX app on the same files in a child
  process with XLA's excess precision off (``test_torch_bf16``'s
  ``jax_reference``): the multi-camera app through decode threads and
  through ``--decode-pool``, the dual app on two of the clips. Each
  round's batch (and stream ids) is bit-equal to the JAX app's; its
  outputs are within the bf16 budget of ``tests/test_torch_bf16.py``
  with at most 2 faces on one side only (each a checked tie); the frames
  written are each stream's own, in order, at its own size and rate, and
  equal the JAX app's; the dual app's resized second frame equals
  ``cv2.resize``. The drawing is turned off on both sides, so the frames
  written are the frames served (``test_torch_realtime.py`` holds the
  drawing to the JAX one).
- Without a card, each app raises when ``device`` is not given.
"""
import os

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu.apps import dualstream as jds
from scrfd_arcface_facerecognition_tpu.apps import multistream as jms
from scrfd_arcface_facerecognition_tpu_torch.apps import dualstream as tds
from scrfd_arcface_facerecognition_tpu_torch.apps import multistream as tms
from scrfd_arcface_facerecognition_tpu_torch.apps import realtime as trt
from scrfd_arcface_facerecognition_tpu_torch.ops import tight_letterbox_plan
from test_torch_bf16 import (assert_outputs_close, face_frames, jax_pipeline,
                             jax_reference, output_arrays, pipeline_cuts,
                             port_pipeline)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

# (frames, height, width, fps) of each clip: the second ends early; the
# widths are multiples of 16 (the JAX binding of the native decoder
# corrupts the heap at others, ROADMAP.md section 3)
CLIPS = ((5, 180, 320, 12.0), (3, 240, 208, 15.0), (5, 160, 240, 10.0))
FACES = ("ann", "bo")
APPS = ("threads", "pool", "dual")


def test_parsers_dests_and_defaults_equal_jax():
    argv = ["--sources", "a.mp4", "rtsp://cam"]
    assert vars(tms.parse_args(argv)) == vars(jms.parse_args(argv))
    argv += ["--det-weight", "d.onnx", "--rec-weight", "r.onnx",
             "--similarity-thresh", "0.6", "--confidence-thresh", "0.2",
             "--faces-dir", "f", "--max-num", "3", "--output-dir", "o",
             "--max-frames", "9", "--decode-pool", "--decode-workers", "2",
             "--slot-bytes", "1000"]
    assert vars(tms.parse_args(argv)) == vars(jms.parse_args(argv))
    argv = ["--source1", "a", "--source2", "b"]
    assert vars(tds.parse_args(argv)) == vars(jds.parse_args(argv))
    argv += ["--det-weight", "d.onnx", "--rec-weight", "r.onnx",
             "--similarity-thresh", "0.6", "--confidence-thresh", "0.2",
             "--faces-dir", "f", "--max-num", "3", "--show", "--output",
             "o.mp4", "--max-frames", "9", "--reconnect-delay", "0.5"]
    assert vars(tds.parse_args(argv)) == vars(jds.parse_args(argv))


class Unopened:
    def isOpened(self):
        return False


def test_connect_to_camera_raises_after_its_attempts(monkeypatch):
    from scrfd_arcface_facerecognition_tpu.runtime import video as jvideo

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jvideo, "open_capture",
                        lambda s: calls["jax"].append(s) or Unopened())
    monkeypatch.setattr(trt, "open_capture",
                        lambda s: calls["port"].append(s) or Unopened())
    with pytest.raises(RuntimeError) as want:
        jds.connect_to_camera(7, reconnect_delay=0.0, attempts=3)
    with pytest.raises(RuntimeError) as got:
        tds.connect_to_camera(7, reconnect_delay=0.0, attempts=3)
    assert str(got.value) == str(want.value)
    assert calls["port"] == calls["jax"] == ["7"] * 3


def test_apps_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = ["--det-weight", "det_500m.onnx", "--rec-weight",
               "w600k_mbf.onnx"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.run(tms.parse_args(["--sources", "a.mp4"] + weights))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.run(tds.parse_args(["--source1", "a", "--source2", "b"]
                               + weights))


# ------------------------------------------------------ against the JAX apps


def make_inputs(d):
    """The clips and the faces directory, seeded, written by cv2, under
    ``d``; -> (clip paths, faces directory)."""
    import cv2

    rng = np.random.default_rng(31)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, (n, h, w, fps) in enumerate(CLIPS):
        path = os.path.join(d, f"cam{i}.mp4")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        assert wr.isOpened(), path
        for f in face_frames(rng, n, h, w):
            wr.write(f)
        wr.release()
        paths.append(path)
    faces = os.path.join(d, "faces")
    os.makedirs(faces, exist_ok=True)
    photos = face_frames(np.random.default_rng(47), len(FACES), 180, 240)
    for name, photo in zip(FACES, photos):
        cv2.imwrite(os.path.join(faces, name + ".png"), photo)
    return paths, faces


def app_argv(app, d):
    """The app's arguments on the inputs under ``d``; -> (module name,
    argv)."""
    paths, faces = make_inputs(d)
    common = ["--faces-dir", faces, "--det-weight", "det_500m.onnx",
              "--rec-weight", "w600k_mbf.onnx", "--confidence-thresh", "0.1"]
    if app == "dual":
        return "dualstream", ["--source1", paths[0], "--source2", paths[2],
                              "--output", os.path.join(d, "both.mp4"),
                              "--reconnect-delay", "0"] + common
    argv = ["--sources", *paths, "--output-dir", os.path.join(d, "out")]
    if app == "pool":
        argv += ["--decode-pool", "--decode-workers", "2",
                 "--slot-bytes", str(320 * 240 * 3)]
    return "multistream", argv + common


class Recorded:
    """A pipeline whose calls keep (frames, output)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.seen = []

    def __call__(self, frames, **kw):
        out = self.pipe(frames, **kw)
        self.seen.append((np.array(frames), out))
        return out

    def __getattr__(self, name):
        return getattr(self.pipe, name)


class Writers:
    """cv2.VideoWriter-shaped writers keeping every frame by file name."""

    def __init__(self):
        self.files = {}

    def open(self, path, fps, size):
        rec = self.files[os.path.basename(path)] = dict(
            fps=float(fps), size=tuple(size), frames=[])

        class Writer:
            def write(self, frame):
                rec["frames"].append(np.array(frame))

            def release(self):
                rec["released"] = True

        return Writer()


def _job_apps(root):
    """The three JAX app runs (in the reference process)."""
    import cv2

    from scrfd_arcface_facerecognition_tpu import pipeline as jpipe

    made, writers = [], Writers()

    def factory(**kw):
        assert kw["dtype"].__name__ == "bfloat16", kw
        made.append(Recorded(jax_pipeline()))
        return made[-1]

    # the inputs are written before cv2's writer is replaced
    argvs = {app: app_argv(app, os.path.join(str(root), "jax", app))
             for app in APPS}
    jpipe.FacePipeline = factory
    jms.annotate_batch = jds.annotate_batch = lambda *a: None
    cv2.VideoWriter = lambda path, fourcc, fps, size: writers.open(
        path, fps, size)
    out = {}
    for app in APPS:
        name, argv = argvs[app]
        mod = jds if name == "dualstream" else jms
        res = mod.run(mod.parse_args(argv))
        pipe = made[-1]
        out[f"{app}_frames"] = np.int64(res["frames"])
        out[f"{app}_targets"] = np.int64(res["targets"])
        out[f"{app}_names"] = np.asarray(pipe.names)
        out[f"{app}_gallery"] = np.asarray(pipe._gallery)[:len(pipe.names)]
        for i, (batch, o) in enumerate(pipe.seen):
            out.update(output_arrays(o, prefix=f"{app}_r{i}_"))
            out[f"{app}_r{i}_cut"] = pipeline_cuts(pipe.pipe, batch)
            out[f"{app}_r{i}_batch"] = batch
        for fname, rec in writers.files.items():
            key = f"{app}_w_{fname}"
            out[key] = np.stack(rec["frames"])
            out[key + "_fps"] = np.float64(rec["fps"])
        writers.files.clear()
    return out


@pytest.fixture(scope="module")
def jax_apps(tmp_path_factory):
    return jax_reference("test_torch_multistream", "apps",
                         root=np.asarray(str(tmp_path_factory.mktemp("j"))))


def run_port(app, d, monkeypatch):
    made, writers = [], Writers()

    def factory(**kw):
        assert kw["dtype"] == torch.bfloat16 and kw["device"] == "cpu", kw
        made.append(Recorded(port_pipeline()))
        return made[-1]

    monkeypatch.setattr(trt, "FacePipeline", factory)
    monkeypatch.setattr(trt, "annotate_batch", lambda *a: None)
    monkeypatch.setattr(trt, "open_writer", writers.open)
    name, argv = app_argv(app, str(d))
    mod = tds if name == "dualstream" else tms
    res = mod.run(mod.parse_args(argv), device="cpu")
    paths = [os.path.join(str(d), f"cam{i}.mp4") for i in range(len(CLIPS))]
    return res, made[-1], writers.files, paths


@pytest.mark.parametrize("app", APPS)
def test_app_matches_the_jax_app_on_the_checkpoints(app, jax_apps, tmp_path,
                                                    monkeypatch):
    ref = {k[len(app) + 1:]: v for k, v in jax_apps.items()
           if k.startswith(app + "_")}
    res, pipe, files, paths = run_port(app, tmp_path, monkeypatch)
    assert res["frames"] == int(ref["frames"]) > 0
    assert res["targets"] == int(ref["targets"]) == len(FACES)
    assert pipe.names == list(ref["names"])
    gal = pipe._gallery.numpy()[:len(pipe.names)]
    assert ((gal * ref["gallery"]).sum(1) >= 0.999).all()
    assert len(pipe.seen) == sum(k.startswith("r") and k.endswith("_batch")
                                 for k in ref)
    lone = 0
    for i, (batch, out) in enumerate(pipe.seen):
        np.testing.assert_array_equal(batch, ref[f"r{i}_batch"])
        scale = tight_letterbox_plan(batch.shape[1:3], (256, 256)).det_scale
        lone += assert_outputs_close(ref, out, frames=batch, det_scale=scale,
                                     where=(app, i), prefix=f"r{i}_")
    assert sum(int(o.valid.sum()) for _, o in pipe.seen) > 0
    print(f"{app}: faces on one side only (ties):", lone)
    assert lone <= 2
    # the frames written: the JAX app's, each stream's own, in order
    assert sorted(files) == sorted(k[2:] for k in ref
                                   if k.startswith("w_")
                                   and not k.endswith("_fps"))
    for fname, rec in files.items():
        frames = np.stack(rec["frames"])
        np.testing.assert_array_equal(frames, ref[f"w_{fname}"])
        assert rec["fps"] == float(ref[f"w_{fname}_fps"])
        assert rec["released"]
        assert rec["size"] == (frames.shape[2], frames.shape[1])
    if app == "dual":
        check_dual(pipe, files, paths)
    else:
        check_streams(pipe, files, paths)


def decoded(path):
    from scrfd_arcface_facerecognition_tpu_torch.runtime.video import (
        open_capture)

    cap = open_capture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def check_streams(pipe, files, paths):
    """A round for every frame of the longest clip, each with the streams
    still live; each stream written at its own size and rate: the clip's
    frames as decoded, in order."""
    lengths = [c[0] for c in CLIPS]
    assert [len(b) for b, _ in pipe.seen] == [
        sum(n > r for n in lengths) for r in range(max(lengths))]
    for sid, ((n, h, w, fps), path) in enumerate(zip(CLIPS, paths)):
        rec = files[f"stream_{sid}.mp4"]
        assert rec["size"] == (w, h) and abs(rec["fps"] - fps) < 0.5
        want = decoded(path)
        assert len(want) == len(rec["frames"]) == n
        for a, b in zip(rec["frames"], want):
            np.testing.assert_array_equal(a, b)


def check_dual(pipe, files, paths):
    """The second camera's frames resized to the first's size equal
    cv2.resize; the side-by-side frames are the two."""
    import cv2

    rec = files["both.mp4"]
    first, second = decoded(paths[0]), decoded(paths[2])
    n = min(len(first), len(second))
    assert len(rec["frames"]) == len(pipe.seen) == n
    _, h, w, _ = CLIPS[0]
    for i, ((batch, _), both) in enumerate(zip(pipe.seen, rec["frames"])):
        np.testing.assert_array_equal(batch[0], first[i])
        np.testing.assert_array_equal(
            batch[1], cv2.resize(second[i], (w, h),
                                 interpolation=cv2.INTER_LINEAR))
        assert both.shape == (h, 2 * w, 3)
        np.testing.assert_array_equal(both, np.hstack([batch[0], batch[1]]))
