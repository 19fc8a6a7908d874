"""The port's tracer (``stages.py``) on the CPU.

- A stream at depth 2 records one ``stream.dispatch``, ``stream.queued``
  and ``stream.finish`` a batch, and the three cover the batch's host time
  from being taken to being yielded.
- A PQ search records ``pq.search`` and, inside it, ``pq.readback``.
- Off, nothing is recorded and ``stage`` / ``span`` return one shared
  null context; a stage hook sees the same names, in the same order,
  whether the recorder is on or off.
- Under ``torch.profiler`` a span's start lies within 1 ms of its
  ``record_function`` event's: the stamps are on the profiler's clock.
"""
import contextlib

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch import stages
from scrfd_arcface_facerecognition_tpu_torch.gallery.pq import (PQCodec,
                                                                PQGallery)
from scrfd_arcface_facerecognition_tpu_torch.models.arcface import (
    ArcFaceConfig)
from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import SCRFDConfig
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector, Embedder, FacePipeline)
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


@pytest.fixture
def recorder():
    stages.enable()
    try:
        yield stages
    finally:
        stages.disable()
        stages.reset()


def batches(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2, 90, 160, 3), dtype=np.uint8)
            for _ in range(n)]


def gallery():
    rng = np.random.default_rng(5)
    codec = PQCodec(torch.from_numpy(
        rng.normal(size=(8, 16, 4)).astype(np.float32)))
    g = PQGallery(codec, capacity=64, device="cpu")
    g.add(np.arange(40), rng.normal(size=(40, 32)).astype(np.float32))
    return g, rng.normal(size=(3, 32)).astype(np.float32)


def by_name(name):
    return [(t0, t1) for n, t0, t1 in stages.recorded() if n == name]


def test_stream_spans_cover_each_batch(pipe, recorder):
    taken, done = [], []

    def feed():
        for b in batches():
            taken.append(stages.now())
            yield b

    for _ in pipe.process_stream(feed(), max_num=3, depth=2):
        done.append(stages.now())
    rep = stages.report()
    for name in ("stream.dispatch", "stream.queued", "stream.finish",
                 "stream.count_wait"):
        assert rep[name]["n"] == 4, name
    dispatch, queued, finish = (by_name("stream.dispatch"),
                                by_name("stream.queued"),
                                by_name("stream.finish"))
    for i in range(4):
        spans = (dispatch[i], queued[i], finish[i])
        assert all(t0 <= t1 for t0, t1 in spans)
        # one after the other: the wait starts as the dispatch ends and
        # ends as the finish starts
        assert dispatch[i][1] <= queued[i][0] <= queued[i][1] \
            <= finish[i][0]
        covered = sum(t1 - t0 for t0, t1 in spans)
        host = done[i] - taken[i]
        assert abs(covered - host) <= 0.05 * host, (i, covered, host)
    # a batch waits while the two behind it are dispatched
    assert queued[0][1] > dispatch[2][1]
    for t0, t1 in by_name("stream.count_wait"):
        assert any(f0 <= t0 and t1 <= f1 for f0, f1 in finish)


def test_pq_search_records_search_and_readback(recorder):
    g, q = gallery()
    g.search(q, k=3)
    rep = stages.report()
    assert rep["pq.search"]["n"] == 1 and rep["pq.readback"]["n"] == 1
    (s0, s1), (r0, r1) = by_name("pq.search")[0], by_name("pq.readback")[0]
    assert s0 <= r0 <= r1 <= s1
    assert rep["pq.search"]["ms"] >= rep["pq.readback"]["ms"]
    assert {"pq_lut", "pq_adc", "pq_topk"} <= set(rep)


def test_disabled_records_nothing_and_shares_a_null_context(pipe):
    stages.reset()
    assert stages.stage("scrfd") is stages.span("pq.search") \
        is stages.stage("match")
    assert isinstance(stages.span("x"), contextlib.nullcontext)
    g, q = gallery()
    g.search(q, k=3)
    list(pipe.process_stream(iter(batches(2)), max_num=3, depth=2))
    stages.interval("stream.queued", 0, stages.now())
    assert stages.report() == {} and stages.recorded() == []


def test_hook_sees_the_same_stage_names_and_order(pipe):
    seen = []

    @contextlib.contextmanager
    def hook(name):
        seen.append(name)
        yield

    def names(b):
        seen.clear()
        stages.set_stage_hook(hook)
        try:
            pipe(b, max_num=3)
        finally:
            stages.set_stage_hook(None)
        return list(seen)

    b = batches(1)[0]
    off = names(b)
    assert off[:3] == ["letterbox", "scrfd", "decode_nms"]
    assert set(off) <= set(stages.STAGES)
    stages.enable()
    try:
        on = names(b)
        recorded = [n for n, _, _ in sorted(stages.recorded(),
                                            key=lambda r: r[1])
                    if n in stages.STAGES]
    finally:
        stages.disable()
        stages.reset()
    assert on == off == recorded


def test_an_interval_from_before_the_recorder_is_dropped(recorder):
    early = stages.now()
    stages.reset()
    stages.interval("stream.queued", early, stages.now())
    t0 = stages.now()
    stages.interval("stream.queued", t0, t0 + 2_000_000)
    assert stages.report() == {"stream.queued": {"ms": 2.0, "n": 1}}


def test_span_start_matches_its_profiler_event(recorder):
    from torch.profiler import ProfilerActivity, profile

    with stages.span("probe.warm"):     # the first range's set-up apart
        pass
    stages.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with stages.span(f"probe.{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert len(events) == 3
    for name, t0, t1 in stages.recorded():
        e = events[name]
        assert abs(t0 - e.start_ns()) < 1_000_000, name
        assert abs(t1 - e.end_ns()) < 1_000_000, name
