"""The port's realtime app against the JAX package's (CPU).

- The parser: the same dests and defaults; ``variant_from_path``.
- A headless run on a clip written here, with a stub pipeline: every
  frame written, the gallery built from the faces directory.
- ``annotate_batch`` and the drawing helpers pixel-equal to the JAX ones
  on the same outputs.
- ``run`` against the JAX ``run`` on a short clip with a faces directory,
  both on the trained det_500m + w600k_mbf checkpoints at bf16 (the JAX
  side in its own process, XLA's excess precision off): frame counts and
  target names equal, target embeddings cosine >= 0.999, each batch's
  outputs at the tolerances of ``tests/test_torch_bf16.py``.
- Weight files that exist run through the graph executor (small exported
  stand-ins); an empty one fails as it does in the JAX app, with the same
  exception type; ``--disagg`` above 0 without a card raises (it splits
  the CUDA cards unless given slots), and on one slot raises the JAX
  app's message; without a card ``run`` raises.
"""
import os

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu.apps import realtime as jrt
from scrfd_arcface_facerecognition_tpu.pipeline.face_pipeline import (
    PipelineOutput as JOutput)
from scrfd_arcface_facerecognition_tpu.utils import drawing as jdraw
from scrfd_arcface_facerecognition_tpu_torch.apps import realtime as trt
from scrfd_arcface_facerecognition_tpu_torch.ops import tight_letterbox_plan
from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
    PipelineOutput as TOutput)
from scrfd_arcface_facerecognition_tpu_torch.utils import drawing as tdraw
from test_torch_bf16 import (OUT_FIELDS, assert_outputs_close, face_frames,
                             jax_pipeline, jax_reference, output_arrays,
                             pipeline_cuts, port_pipeline)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def test_parser_dests_and_defaults_equal_jax():
    assert vars(trt.parse_args([])) == vars(jrt.parse_args([]))
    argv = ["--similarity-thresh", "0.7", "--source", "0", "--max-num", "3",
            "--batch", "4", "--show", "--max-frames", "9", "--disagg", "2",
            "--output", "o.mp4", "--faces-dir", "f", "--log-level", "DEBUG",
            "--det-weight", "d.onnx", "--rec-weight", "r.onnx",
            "--confidence-thresh", "0.2"]
    assert vars(trt.parse_args(argv)) == vars(jrt.parse_args(argv))


def test_variant_from_path():
    for path, default in (("./weights/det_10g.onnx", "x"),
                          ("/a/b/w600k_mbf.onnx", "x"),
                          ("./weights/custom.onnx", "det_500m"),
                          ("det_2.5g.onnx", "y")):
        assert (trt.variant_from_path(path, default)
                == jrt.variant_from_path(path, default))
    assert trt.variant_from_path("/a/b/w600k_mbf.onnx", "x") == "w600k_mbf"


def write_clip(path, frames, fps=12.0):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    return str(path)


def stub_outputs(b, k=2, to=torch.tensor):
    """One detection (10, 10, 60, 70) a frame, matched to gallery row 0."""
    boxes = np.zeros((b, k, 4), np.float32)
    boxes[:, 0] = [10, 10, 60, 70]
    valid = np.zeros((b, k), bool)
    valid[:, 0] = True
    return dict(boxes=boxes, scores=np.full((b, k), .9, np.float32),
                kps=np.zeros((b, k, 5, 2), np.float32), valid=valid,
                count=np.ones(b, np.int32),
                embeddings=np.zeros((b, k, 512), np.float32),
                match_idx=np.where(valid, 0, -1).astype(np.int32),
                match_sim=np.where(valid, 0.8, 0.0).astype(np.float32))


class StubPipeline:
    """FacePipeline-shaped: one detection a frame, the first gallery row."""

    def __init__(self):
        self.names = []

        class Det:
            def detect(self, image, max_num=0, metric="max"):
                return (np.array([[10, 10, 60, 70, 0.9]], np.float32),
                        np.tile(np.array([[20, 30]], np.float32), (1, 5, 1)))

        class Emb:
            def __call__(self, image, kps):
                return np.ones(512, np.float32)

        self.detector, self.embedder = Det(), Emb()

    def set_gallery(self, embs, names):
        self.names = list(names)

    def process_stream(self, frames_iter, max_num=0, metric="max", depth=2):
        for frames in frames_iter:
            yield TOutput(**{k: torch.from_numpy(v) for k, v in
                             stub_outputs(len(frames)).items()})


def test_run_end_to_end_headless_with_a_stub(tmp_path, monkeypatch):
    import cv2

    video = write_clip(tmp_path / "in.mp4", [
        np.random.default_rng(i).integers(0, 255, (96, 128, 3), np.uint8)
        for i in range(6)])
    faces = tmp_path / "faces"
    faces.mkdir()
    cv2.imwrite(str(faces / "alice.jpg"), np.full((96, 96, 3), 100, np.uint8))
    (faces / "notes.txt").write_text("not an image")
    stub = StubPipeline()
    made = {}

    def factory(**kw):
        made.update(kw)
        return stub

    monkeypatch.setattr(trt, "FacePipeline", factory)
    out = tmp_path / "out.mp4"
    res = trt.run(trt.parse_args(["--source", video, "--faces-dir",
                                  str(faces), "--output", str(out),
                                  "--batch", "4"]), device="cpu")
    assert res == {"frames": 6, "targets": 1}
    assert stub.names == ["alice"]
    assert made["dtype"] == torch.bfloat16 and made["device"] == "cpu"
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()
    res = trt.run(trt.parse_args(["--source", video, "--faces-dir",
                                  str(faces), "--output", str(out),
                                  "--batch", "4", "--max-frames", "3"]),
                  device="cpu")
    assert res["frames"] == 4            # stops after the batch that passes 3


def test_annotate_and_drawing_pixel_equal_to_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    arrays = stub_outputs(3, k=3)
    arrays["boxes"][:, 1] = [70, 5, 120, 50]
    arrays["valid"][1:, 1] = True
    arrays["match_idx"][1, 1] = 1
    arrays["match_sim"][1, 1] = 0.55
    arrays["match_idx"][2, 1] = -1
    frames = rng.integers(0, 255, (3, 96, 128, 3), dtype=np.uint8)
    names = ["alice", "bob"]
    colors = {"alice": (0, 255, 0), "bob": (10, 20, 250)}
    want, got = frames.copy(), frames.copy()
    jrt.annotate_batch(want, JOutput(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()}),
                       names, colors)
    trt.annotate_batch(got, TOutput(**{k: torch.from_numpy(v)
                                       for k, v in arrays.items()}),
                       names, colors)
    assert not np.array_equal(got, frames)
    np.testing.assert_array_equal(got, want)
    a, b = frames[0].copy(), frames[0].copy()
    jdraw.draw_bbox_info(a, [5.7, 8.2, 90.1, 80.9], 0.37, "x", (1, 2, 3))
    tdraw.draw_bbox_info(b, [5.7, 8.2, 90.1, 80.9], 0.37, "x", (1, 2, 3))
    np.testing.assert_array_equal(a, b)
    jdraw.draw_bbox(a, [30, 40, 31, 90], thickness=1, proportion=0.5)
    tdraw.draw_bbox(b, [30, 40, 31, 90], thickness=1, proportion=0.5)
    np.testing.assert_array_equal(a, b)


def test_unported_options_raise_naming_their_items(tmp_path, monkeypatch):
    """--disagg splits the CUDA cards (none here) unless given slots, and
    one slot is too few, as in the JAX app; weight files that exist run as
    graphs; an empty one raises what the JAX app raises."""
    from scrfd_arcface_facerecognition_tpu_torch.models import graph_models
    from scrfd_arcface_facerecognition_tpu_torch.parallel import (
        device_slots)
    from torch_export import TorchIResNet, TorchSCRFD, export_onnx, seeded

    tiny = ["--det-weight", "det_500m.onnx", "--rec-weight",
            "w600k_mbf.onnx", "--disagg", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.run(trt.parse_args(tiny), device="cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="at least 2 devices"):
        trt.run(trt.parse_args(tiny), device="cpu",
                devices=device_slots("cpu", 1))
    det, rec = str(tmp_path / "det_10g.onnx"), str(tmp_path / "w600k_r50.onnx")
    export_onnx(seeded(TorchSCRFD(stem=8, blocks=(1, 1, 1, 1),
                                  planes=(8, 8, 16, 16), neck=8,
                                  head_feat=16, head_stacks=1), 0),
                torch.randn(1, 3, 640, 640), det)
    export_onnx(seeded(TorchIResNet(blocks=(1, 1, 1, 1),
                                    planes=(8, 8, 16, 16)), 0),
                torch.randn(1, 3, 112, 112), rec)
    video = write_clip(tmp_path / "in.mp4", [
        np.random.default_rng(i).integers(0, 255, (96, 128, 3), np.uint8)
        for i in range(5)])
    import cv2

    faces = tmp_path / "faces"
    faces.mkdir()
    cv2.imwrite(str(faces / "ann.png"), np.random.default_rng(9).integers(
        0, 255, (96, 96, 3), np.uint8))
    made = []
    real = trt.FacePipeline

    def recorded(**kw):
        made.append(real(**kw))
        return made[-1]

    monkeypatch.setattr(trt, "FacePipeline", recorded)
    res = trt.run(trt.parse_args([
        "--source", video, "--faces-dir", str(faces),
        "--output", str(tmp_path / "out.mp4"), "--batch", "2",
        "--det-weight", det, "--rec-weight", rec,
        "--confidence-thresh", "0.0"]), device="cpu")
    assert res == {"frames": 5, "targets": 1}
    pipe = made[0]
    assert isinstance(pipe.detector.model, graph_models.SCRFDGraphModule)
    assert isinstance(pipe.embedder.model, graph_models.ArcFaceGraphModule)
    assert pipe.detector.dtype == pipe.embedder.dtype == torch.bfloat16
    empty = tmp_path / "det_500m.onnx"
    empty.write_bytes(b"")
    argv = ["--det-weight", str(empty), "--source", video]
    with pytest.raises(Exception) as want:
        jrt.run(jrt.parse_args(argv))
    with pytest.raises(Exception) as got:
        trt.run(trt.parse_args(argv), device="cpu")
    assert type(got.value) is type(want.value) is ValueError, (want, got)


def test_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.run(trt.parse_args(["--det-weight", "det_500m.onnx",
                                "--rec-weight", "w600k_mbf.onnx"]))


# ------------------------------------------------------ against the JAX app


CLIP = dict(frames=7, hw=(180, 320), batch=3, faces=("ann", "bo"))


def make_inputs(tmp):
    """The clip and the faces directory, seeded, written by cv2."""
    import cv2

    rng = np.random.default_rng(21)
    n, (h, w) = CLIP["frames"], CLIP["hw"]
    video = write_clip(os.path.join(tmp, "in.mp4"),
                       list(face_frames(rng, n, h, w)))
    faces = os.path.join(tmp, "faces")
    os.makedirs(faces, exist_ok=True)
    for name in CLIP["faces"]:
        cv2.imwrite(os.path.join(faces, name + ".png"),
                    face_frames(rng, 1, 160, 160)[0])
    return video, faces


def run_recorded(rt, make_pipeline, tmp):
    """``rt.run`` on the clip with its FacePipeline replaced by
    ``make_pipeline()``; returns (result, pipeline, [(batch, output)])."""
    video, faces = make_inputs(tmp)
    seen, made = [], {}

    def factory(**kw):
        pipe = made["pipe"] = make_pipeline()
        stream = pipe.process_stream

        def recorded(frames_iter, **k):
            batches = []

            def keep():
                for b in frames_iter:
                    batches.append(np.array(b))
                    yield b
            for i, out in enumerate(stream(keep(), **k)):
                seen.append((batches[i], out))
                yield out
        pipe.process_stream = recorded
        return pipe

    rt.FacePipeline = factory
    argv = ["--source", video, "--faces-dir", faces, "--batch",
            str(CLIP["batch"]), "--output", os.path.join(tmp, "out.mp4"),
            "--det-weight", "det_500m.onnx", "--rec-weight",
            "w600k_mbf.onnx", "--confidence-thresh", "0.1"]
    kw = {"device": "cpu"} if rt is trt else {}
    return rt.run(rt.parse_args(argv), **kw), made["pipe"], seen


def _job_realtime():
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        res, pipe, seen = run_recorded(jrt, jax_pipeline, tmp)
    out = dict(frames=np.int64(res["frames"]),
               targets=np.int64(res["targets"]),
               names=np.asarray(pipe.names),
               gallery=np.asarray(pipe._gallery)[:len(pipe.names)])
    for i, (batch, o) in enumerate(seen):
        out.update(output_arrays(o, prefix=f"b{i}_"))
        out[f"b{i}_cut"] = pipeline_cuts(pipe, batch)
        out[f"b{i}_frames"] = batch
    return out


def test_run_matches_the_jax_app_on_the_checkpoints(tmp_path, monkeypatch):
    monkeypatch.setattr(trt, "FacePipeline", trt.FacePipeline)
    ref = jax_reference("test_torch_realtime", "realtime")
    res, pipe, seen = run_recorded(trt, port_pipeline, str(tmp_path))
    assert res == {"frames": int(ref["frames"]),
                   "targets": int(ref["targets"])}
    assert res["frames"] == CLIP["frames"]
    assert pipe.names == list(ref["names"]) and len(pipe.names) > 0
    gal = pipe._gallery.numpy()[:len(pipe.names)]
    assert ((gal * ref["gallery"]).sum(1) >= 0.999).all()
    assert [len(b) for b, _ in seen] == [3, 3, 1]
    lone = 0
    for i, (batch, out) in enumerate(seen):
        np.testing.assert_array_equal(batch, ref[f"b{i}_frames"])
        scale = tight_letterbox_plan(batch.shape[1:3], (256, 256)).det_scale
        lone += assert_outputs_close(ref, out, frames=batch, det_scale=scale,
                                     where=i, prefix=f"b{i}_")
    assert sum(int(o.valid.sum()) for _, o in seen) > 0
    print("realtime bf16, faces on one side only (ties):", lone)
    assert lone <= 2
    assert set(OUT_FIELDS) == set(TOutput._fields)
