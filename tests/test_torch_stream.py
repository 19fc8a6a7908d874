"""``FacePipeline.process_stream(depth=)``: batches in flight (CPU).

- At every depth (1, 2, 5; below 1 acts as 1) the stream yields, in
  order, exactly what ``__call__`` gives batch by batch: bit for bit, over
  frame batches of mixed shapes, and nothing for an empty iterator.
- Batch i's face count is read only after batches i+1..i+depth are
  dispatched (the JAX package's ``process_stream``), shown by recording
  the dispatches and the count reads.
- On the CPU the count is the plain int, no event; the card's pinned
  readback is exercised by ``chip_smoke.py``.
- The port's bf16 stream against the JAX package's ``process_stream`` at
  bf16 on the trained checkpoints, at the tolerances of
  ``tests/test_torch_bf16.py`` (the JAX side in its own process, XLA's
  excess precision off).
"""
import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch.models.arcface import (
    ArcFaceConfig)
from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import SCRFDConfig
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector, Embedder, FacePipeline)
from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline
from test_torch_bf16 import (assert_outputs_close, face_frames, jax_pipeline,
                             jax_reference, output_arrays, pipeline_cuts,
                             port_pipeline)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

DET_CFG = SCRFDConfig("small_det", 16, (1, 2, 1, 1), (16, 16, 32, 48),
                      neck_filters=16, head_stacks=2, head_filters=32,
                      gn_groups=8)
EMB_CFG = ArcFaceConfig("small_r", "iresnet", emb_dim=128,
                        stage_blocks=(1, 1, 1, 1),
                        stage_filters=(16, 32, 32, 64))


@pytest.fixture(scope="module")
def pipe():
    det = Detector(config=DET_CFG, input_size=(160, 160), seed=3,
                   conf_thres=0.3, pre_nms=32, max_det=4, device="cpu")
    emb = Embedder(config=EMB_CFG, seed=4, device="cpu")
    p = FacePipeline(detector=det, embedder=emb, gallery_capacity=8,
                     similarity_thresh=0.2, device="cpu")
    rng = np.random.default_rng(0)
    p.set_gallery(rng.normal(size=(5, 128)).astype(np.float32),
                  [f"p{i}" for i in range(5)])
    return p


def mixed_batches(seed=1):
    rng = np.random.default_rng(seed)
    shapes = [(2, 90, 160), (3, 90, 160), (1, 120, 100), (2, 64, 64),
              (2, 90, 160), (1, 120, 100), (2, 100, 130)]
    return [rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
            for b, h, w in shapes]


def assert_equal_outputs(a, b, where):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (where, name)


@pytest.mark.parametrize("depth", [1, 2, 5, 0, -3])
def test_stream_equals_per_batch_calls_bit_for_bit(pipe, depth):
    batches = mixed_batches()
    want = [pipe(b, max_num=3) for b in batches]
    got = list(pipe.process_stream(iter(batches), max_num=3, depth=depth))
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_equal_outputs(w, g, (depth, i))
    assert sum(int(o.valid.sum()) for o in want) > 0
    assert list(pipe.process_stream(iter([]), depth=depth)) == []


def test_stream_takes_tensors_and_single_frames(pipe):
    batches = mixed_batches(2)[:3]
    frames = [torch.from_numpy(batches[0]), batches[1][0], batches[2]]
    got = list(pipe.process_stream(frames, depth=2))
    want = [pipe(f) for f in frames]
    assert [tuple(o.valid.shape) for o in got] == [(2, 4), (1, 4), (1, 4)]
    for i, (w, g) in enumerate(zip(want, got)):
        assert_equal_outputs(w, g, i)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_count_is_read_after_the_next_batches_are_dispatched(
        pipe, monkeypatch, depth):
    log = []
    dispatch = pipe._dispatch
    value = face_pipeline.CountReadback.value

    def recorded_dispatch(frames, max_num, metric):
        d = dispatch(frames, max_num, metric)
        d.count.index = sum(1 for e in log if e[0] == "dispatch")
        log.append(("dispatch", d.count.index))
        return d

    def recorded_value(self):
        log.append(("read", self.index))
        return value(self)

    monkeypatch.setattr(pipe, "_dispatch", recorded_dispatch)
    monkeypatch.setattr(face_pipeline.CountReadback, "value", recorded_value)
    n = 6
    batches = mixed_batches(3)[:n]
    outs = list(pipe.process_stream(batches, depth=depth))
    assert len(outs) == n
    reads = [i for kind, i in log if kind == "read"]
    assert reads == list(range(n))
    for i in range(n):
        read_at = log.index(("read", i))
        last = min(i + depth, n - 1)
        assert log.index(("dispatch", last)) < read_at, (i, log)
        if i + depth + 1 < n:     # and not a batch more than depth ahead
            assert log.index(("dispatch", i + depth + 1)) > read_at, log


def test_count_readback_on_the_cpu_is_the_plain_int():
    c = face_pipeline.CountReadback(torch.tensor(7))
    assert c.event is None and c.value() == 7


# --------------------------------------------------- against the JAX stream


def _job_stream(frames_a, frames_b, gallery):
    jp = jax_pipeline()
    jp.set_gallery(gallery, [f"g{i}" for i in range(len(gallery))])
    batches = [frames_a, frames_b, frames_a[::-1]]
    res = {}
    for i, out in enumerate(jp.process_stream(iter(batches), depth=2)):
        res.update(output_arrays(out, prefix=f"b{i}_"))
        res[f"b{i}_cut"] = pipeline_cuts(jp, batches[i])
    return res


def test_bf16_stream_matches_jax_process_stream():
    tp = port_pipeline()
    rng = np.random.default_rng(7)
    a = face_frames(rng, 2, 180, 320)
    b = face_frames(rng, 3, 240, 200)
    first = tp(a)
    gal = first.embeddings.numpy()[first.valid.numpy()][:4]
    assert len(gal)
    tp.set_gallery(gal, [f"g{i}" for i in range(len(gal))])
    ref = jax_reference("test_torch_stream", "stream", frames_a=a,
                        frames_b=b, gallery=gal)
    batches = [a, b, a[::-1]]
    outs = list(tp.process_stream(iter(batches), depth=2))
    assert len(outs) == 3
    from scrfd_arcface_facerecognition_tpu_torch import ops

    lone = 0
    for i, (frames, out) in enumerate(zip(batches, outs)):
        scale = ops.tight_letterbox_plan(frames.shape[1:3],
                                         (256, 256)).det_scale
        lone += assert_outputs_close(ref, out, frames=frames,
                                     det_scale=scale, where=i,
                                     prefix=f"b{i}_")
    print("bf16 stream, faces on one side only (ties):", lone)
    assert lone <= 2
