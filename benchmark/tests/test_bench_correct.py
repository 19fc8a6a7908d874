"""``correct`` on small runs on the CPU: true for the program as it is,
false for the control and for each fault a cell can have, planted in the
timed path underneath the harness (which is driven past its look for a
card)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import calibrate, core, harness

STREAM = "buffalo_l.stream_1080p_card"
LOOKUP = "buffalo_l.lookup_pq10m"
SPEC = core.load_spec()


def run(small_cell, cell, seed=2 ** 31 + 101, trace=False, frames=None):
    spec, ctx = small_cell(cell, seed, trace)
    if frames:
        ctx.traffic["frames"] = frames
    return harness.run_cell(spec, ctx)


@pytest.mark.parametrize("cell", [STREAM, LOOKUP])
def test_the_program_as_it_is_is_correct(small_cell, cell):
    out = run(small_cell, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["line"].rstrip().endswith("}}}")      # checks come last
    assert list(out["metrics"])                      # a layer was read


def test_the_stream_control_is_not_correct(small_cell, monkeypatch):
    """The reference one precision step below the configuration's (fp8
    models, a TF32 match) in the program's place."""
    monkeypatch.setattr(harness, "context", _small(small_cell))
    got = calibrate.control_readings(SPEC, STREAM, 2 ** 32 + 7,
                                     torch.device("cpu"))
    limits = _limits(STREAM)
    assert any(got[k] > limits[k] for k in got), (got, limits)


def test_the_lookup_control_is_not_correct(small_cell, monkeypatch):
    """The program's own "hi" path (a bfloat16 table) in place of "hilo"."""
    monkeypatch.setattr(harness, "context", _small(small_cell))
    got = calibrate.control_readings(SPEC, LOOKUP, 2 ** 32 + 7,
                                     torch.device("cpu"))
    assert got["lookup_gap"] > _limits(LOOKUP)["lookup_gap"]


def _small(small_cell):
    def make(spec, cell, seed, seconds, trace, device, started):
        return small_cell(cell, seed, trace, seconds)[1]
    return make


def _limits(cell):
    return core.read_json(core.limits_file(cell))["limits"]


def _half_left_out(out):
    b = out.valid.shape[0]
    keep = (torch.arange(b) < b // 2).to(out.valid.device)
    return out._replace(
        valid=out.valid & keep[:, None],
        count=torch.where(keep, out.count, 0),
        embeddings=out.embeddings * keep[:, None, None],
        match_idx=torch.where(keep[:, None], out.match_idx, -1),
        match_sim=out.match_sim * keep[:, None])


def plant_half_of_the_batch(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline

    orig = face_pipeline.FacePipeline._finish

    def finish(self, batch):
        return _half_left_out(orig(self, batch))
    monkeypatch.setattr(face_pipeline.FacePipeline, "_finish", finish)


def plant_a_moved_box(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import ops

    orig = ops.distance2bbox

    def moved(points, distance, max_shape=None):
        box = orig(points, distance, max_shape)
        return box + torch.tensor([3.0, 0.0, 0.0, 0.0], device=box.device)
    monkeypatch.setattr(ops, "distance2bbox", moved)


def plant_an_altered_embedding(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline

    orig = face_pipeline.embed_crops

    def altered(*a, **k):
        emb = orig(*a, **k).clone()
        emb[0] = torch.roll(emb[0], 1)
        return emb
    monkeypatch.setattr(face_pipeline, "embed_crops", altered)


def plant_the_top_faces_by_score(monkeypatch):
    """The ``max_num`` faces of the highest scores kept, not the largest."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    def by_score(det, kps, valid, max_num, metric="max", frame_hw=None):
        return det[:, :max_num], kps[:, :max_num], valid[:, :max_num]
    monkeypatch.setattr(ops, "select_top_faces", by_score)


def plant_max_det_left_out(monkeypatch):
    """Every NMS survivor offered to the largest-face choice, not the
    first ``max_det``."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    orig = ops.compact_by_mask

    def every(mask, *arrays, max_out):
        return orig(mask, *arrays, max_out=mask.shape[-1])
    monkeypatch.setattr(ops, "compact_by_mask", every)


def plant_crops_from_the_wrong_frame(monkeypatch):
    """Each face's crop warped from the next frame of its batch."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline

    orig = face_pipeline.embed_crops

    def wrong(model, frames, kps, frame_idx, *a, **k):
        return orig(model, frames, kps, (frame_idx + 1) % frames.shape[0],
                    *a, **k)
    monkeypatch.setattr(face_pipeline, "embed_crops", wrong)


def plant_a_stale_batch(monkeypatch):
    """Every other batch handed the previous batch's outputs."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline

    orig = face_pipeline.FacePipeline.process_stream

    def stream(self, *a, **k):
        prev = None
        for i, out in enumerate(orig(self, *a, **k)):
            yield prev if i % 2 and prev is not None else out
            prev = out
    monkeypatch.setattr(face_pipeline.FacePipeline, "process_stream", stream)


def plant_an_altered_match(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import face_pipeline

    orig = face_pipeline._match_gallery

    def altered(*a, **k):
        idx, sim = orig(*a, **k)
        return idx, sim * 0.99
    monkeypatch.setattr(face_pipeline, "_match_gallery", altered)


@pytest.mark.parametrize("plant", [plant_half_of_the_batch, plant_a_moved_box,
                                   plant_the_top_faces_by_score,
                                   plant_max_det_left_out,
                                   plant_an_altered_embedding,
                                   plant_crops_from_the_wrong_frame,
                                   plant_a_stale_batch,
                                   plant_an_altered_match],
                         ids=["half_of_the_batch", "moved_box",
                              "top_faces_by_score", "max_det_left_out",
                              "altered_embedding", "wrong_frame_crops",
                              "stale_batch", "altered_match"])
def test_a_stream_fault_is_not_correct(small_cell, monkeypatch, plant):
    plant(monkeypatch)
    # a wrong selection swaps faces among near ties: it shows on some
    # frames, so those faults get eight frames a batch
    selects = plant in (plant_the_top_faces_by_score, plant_max_det_left_out)
    out = run(small_cell, STREAM, frames=8 if selects else None)
    assert not out["correct"], out["checks"]


def test_the_stand_ins_outputs_follow_the_frame(small_cell):
    """With their norms calibrated, the reference models give other
    detections and other embeddings for other frames: a batch or a crop
    taken from the wrong place can be told from the right one."""
    from benchmark.drivers import stream

    _, ctx = small_cell(STREAM, 2 ** 33 + 5)
    cfg, traffic = ctx.config, ctx.traffic
    sd = stream.seeds(ctx.seed)
    pool = stream.frame_pool(traffic, sd["frames"], ctx.device)
    det, rec, faces = stream.reference_models(cfg, traffic, sd, pool,
                                              ctx.device)
    with torch.no_grad():
        a = stream.reference_detections(det, pool[0], cfg)["score"]
        b = stream.reference_detections(det, pool[1], cfg)["score"]
    assert float((a - b).abs().max()) > 1e-2
    cos = faces @ faces.T
    assert float(cos[~torch.eye(len(faces), dtype=torch.bool)].max()) < 0.99


def plant_half_the_queries(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq

    orig = pq.PQGallery.search

    def search(self, queries, *a, **k):
        s, i = orig(self, queries, *a, **k)
        half = len(i) // 2
        return (np.concatenate([s[:half], np.zeros_like(s[half:])]),
                np.concatenate([i[:half], np.full_like(i[half:], -1)]))
    monkeypatch.setattr(pq.PQGallery, "search", search)


def plant_an_altered_row(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq

    orig = pq.PQGallery.search

    def search(self, queries, *a, **k):
        s, i = orig(self, queries, *a, **k)
        i = i.copy()
        i[0, 0] = (i[0, 0] + 1) % self.capacity
        return s, i
    monkeypatch.setattr(pq.PQGallery, "search", search)


def plant_a_stale_answer(monkeypatch):
    """The previous lookup's answer handed back for every other lookup."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq

    orig = pq.PQGallery.search
    seen = []

    def search(self, queries, *a, **k):
        seen.append(orig(self, queries, *a, **k))
        return seen[-2] if len(seen) % 2 == 0 else seen[-1]
    monkeypatch.setattr(pq.PQGallery, "search", search)


def plant_a_repeated_row(monkeypatch):
    """Each query's best row handed back at every rank."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq

    orig = pq.PQGallery.search

    def search(self, queries, *a, **k):
        s, i = orig(self, queries, *a, **k)
        return (np.repeat(s[:, :1], s.shape[1], 1),
                np.repeat(i[:, :1], i.shape[1], 1))
    monkeypatch.setattr(pq.PQGallery, "search", search)


@pytest.mark.parametrize("plant", [plant_half_the_queries,
                                   plant_an_altered_row,
                                   plant_a_stale_answer,
                                   plant_a_repeated_row],
                         ids=["half_the_queries", "altered_row",
                              "stale_answer", "repeated_row"])
def test_a_lookup_fault_is_not_correct(small_cell, monkeypatch, plant):
    plant(monkeypatch)
    out = run(small_cell, LOOKUP)
    assert not out["correct"], out["checks"]
