"""The port's decision-quality trainers and alignment
(``tools/exp_decisions.py`` of the port) against the JAX repository's
``tools/exp_decisions.py``, on the CPU.

The JAX tool is loaded from ``tools/`` by path; its trainers are wrapped
to catch their initial states, batches and losses. Tolerances:

- the trainers from JAX's initial state, 2 steps, the models swapped for
  narrow ones in tier-1 (full width in the slow test): every batch
  bit-equal (the embedder's made of the crops JAX aligned), each loss
  within 1e-5 relative, the detector's AP equal; the embedder's
  verification accuracies equal at step 0 and, at every eval, each
  pair's cosine similarity within 1e-5 (after a step the weights differ
  in their last float32 bits, and a model near chance has similarities
  close enough together that the accuracy sweep reorders them: at full
  width the step-2 accuracies differ by 7 pairs of 160 while every
  similarity agrees to 3.6e-7);
- ``extract_aligned`` on the committed det_500m: the port's detections
  within the f32 budget of JAX's (count equal, boxes and landmarks within
  1e-2 px), the same scenes kept, labels and hit rate; on JAX's
  detections, the aligned crops within a sixteenth of a u8 step (the
  normalized crop's 0.0625 / 127.5; the JAX tool's jitted warp and the
  port's eager one round the float32 sample coordinates apart, see
  ``CROP_TOL``);
"""
import json

import jax
import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu import parallel as jparallel
from scrfd_arcface_facerecognition_tpu import train as jtrain
from scrfd_arcface_facerecognition_tpu.models import arcface as jarc
from scrfd_arcface_facerecognition_tpu.models import scrfd as jscrfd
from scrfd_arcface_facerecognition_tpu_torch import train as ttrain
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as tarc
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as tscrfd
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    scrfd_train_state_from_jax, train_state_from_jax)
from scrfd_arcface_facerecognition_tpu_torch.tools import exp_decisions as tx
from test_torch_decisions import (  # noqa: F401 (fixtures)
    _checkpoint_trees_equal, crops, jx, trees)
from test_torch_host_tools import (LOSS_RTOL, TINY_ARC, TINY_DET,
                                   _bit_equal, _record)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

# the aligned crops, normalized ((x - 127.5) / 127.5): a sixteenth of a u8
# step. The JAX tool's jitted warp and the port's eager one round the
# float32 sample coordinates apart (JAX's own jitted and eager
# estimate_norm differ by 3e-5 px in the translation); at a sharp edge a
# 1e-4 px shift moves a value by ~0.03 u8
CROP_TOL = (1 / 16) / 127.5
# each verification pair's cosine similarity at every eval of the embedder
# trainer (float32 embeddings; measured 3.6e-7 at most, narrow and full
# width)
STEP_SIM_TOL = 1e-5


# -------------------------------------------------------------- the trainers


def _one_slot_mesh(monkeypatch):
    make_mesh = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh", lambda sizes, names: make_mesh(
        tuple(1 for _ in sizes), names, devices=jax.devices()[:1]))


def _narrow(monkeypatch, arc=True, det=True):
    if arc:
        monkeypatch.setitem(jarc.ARCFACE_CONFIGS, "w600k_mbf",
                            jarc.ArcFaceConfig(**TINY_ARC))
        monkeypatch.setitem(tarc.ARCFACE_CONFIGS, "w600k_mbf",
                            tarc.ArcFaceConfig(**TINY_ARC))
    if det:
        monkeypatch.setitem(jscrfd.SCRFD_CONFIGS, "det_500m",
                            jscrfd.SCRFDConfig(**TINY_DET))
        monkeypatch.setitem(tscrfd.SCRFD_CONFIGS, "det_500m",
                            tscrfd.SCRFDConfig(**TINY_DET))


def _losses_close(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (g, w)


def _train_detector_against_jax(monkeypatch, jx, crops, tiny):
    _one_slot_mesh(monkeypatch)
    if tiny:
        _narrow(monkeypatch, arc=False)
    js, ts = {}, {}
    _record(monkeypatch, jtrain, "SCRFDTrainer", js,
            scrfd_train_state_from_jax)
    _record(monkeypatch, ttrain, "SCRFDTrainer", ts,
            scrfd_train_state_from_jax)
    ids = np.asarray([0, 2, 5])
    _, jcurve = jx.train_detector(crops, ids, 2, batch=2, eval_every=2,
                                  log=lambda s: None)
    lines = []
    _, tcurve = tx.train_detector(crops, ids, 2, batch=2, eval_every=2,
                                  log=lines.append, device="cpu",
                                  start=js["start"])
    assert ts.get("from") and "start" not in ts
    assert tcurve == jcurve and [s for s, _ in tcurve] == [2]
    _losses_close(ts["losses"], js["losses"])
    assert len(ts["batches"]) == len(js["batches"]) == 2
    for bt, bj in zip(ts["batches"], js["batches"]):
        _bit_equal(bt[0].transpose(0, 2, 3, 1), bj[0])
        for x, y in zip(bt[1:], bj[1:]):
            np.testing.assert_array_equal(x, y)
    assert [set(json.loads(x)) for x in lines] == [
        {"curve", "step", "value", "loss", "elapsed_s", "ms_step"}]


def test_train_detector_matches_jax_from_its_state(monkeypatch, jx, crops):
    _train_detector_against_jax(monkeypatch, jx, crops, tiny=True)


@pytest.mark.slow
def test_train_detector_matches_jax_at_full_width(monkeypatch, jx, crops):
    _train_detector_against_jax(monkeypatch, jx, crops, tiny=False)


def _detectors(trees):
    from scrfd_arcface_facerecognition_tpu.pipeline import (
        Detector as JDetector)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Detector

    jd, _, td, _ = trees
    return (JDetector(variant="det_500m", variables=jd,
                      input_size=(tx.SCENE, tx.SCENE)),
            Detector(variant="det_500m", variables=td,
                     input_size=(tx.SCENE, tx.SCENE), device="cpu"))


def _jax_detections(jdet, seen):
    """JAX's ``detect_batched``, each call's outputs kept as numpy."""
    detect = jdet.detect_batched

    def recorded(frames, *a, **k):
        d = detect(frames, *a, **k)
        seen.append({f: np.asarray(getattr(d, f)) for f in
                     ("boxes", "scores", "kps", "valid", "count")})
        return d

    jdet.detect_batched = recorded


def test_extract_aligned_matches_jax(jx, trees, crops):
    """The committed det_500m over fresh composites. Each detection of
    the port's detector within the f32 budget of JAX's (the same count,
    boxes and landmarks within 1e-2 px), and the same scenes kept, labels
    and hit rate. Given JAX's detections, the port's alignment (template
    similarity, warp, normalize) gives JAX's crops within ``CROP_TOL``."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.detector import (
        Detections)

    jdet, tdet = _detectors(trees)
    seen = []
    _jax_detections(jdet, seen)
    ids = [0, 1, 4, 6]
    jc, jl, jh = jx.extract_aligned(jdet, crops, ids, 5, 3,
                                    log=lambda s: None, chunk=8)
    assert jh > 0.5 and len(seen) == 3
    # the port's own detections: the f32 budget, the same faces kept
    got = []
    detect = tdet.detect_batched
    tdet.detect_batched = lambda frames, *a, **k: (
        got.append(detect(frames, *a, **k)) or got[-1])
    _, tl, th = tx.extract_aligned(tdet, crops, ids, 5, 3,
                                   log=lambda s: None, chunk=8)
    assert th == jh
    np.testing.assert_array_equal(tl, jl)
    for d, want in zip(got, seen):
        np.testing.assert_array_equal(d.count.numpy(), want["count"])
        keep = want["valid"]
        for f in ("boxes", "kps"):
            np.testing.assert_allclose(getattr(d, f).numpy()[keep],
                                       want[f][keep], rtol=0, atol=1e-2)
    # the alignment on JAX's detections
    replay = iter(seen)
    tdet.detect_batched = lambda frames, *a, **k: Detections(
        **{f: torch.from_numpy(v) for f, v in next(replay).items()})
    tc, tl, th = tx.extract_aligned(tdet, crops, ids, 5, 3,
                                    log=lambda s: None, chunk=8)
    assert th == jh
    np.testing.assert_array_equal(tl, jl)
    assert tc.shape == jc.shape == (len(jl), 112, 112, 3)
    assert tc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=0, atol=CROP_TOL)


def _pair_similarities(monkeypatch):
    """Both packages' ``verification_metrics``, as ``evaluate_embedder``
    calls it, wrapped to keep each pair's cosine similarity from the
    embeddings that eval computed."""
    from scrfd_arcface_facerecognition_tpu.train import (
        arcface_train as jat)
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        arcface_train as tat)

    kept = ([], [])
    for module, sims in ((jat, kept[0]), (tat, kept[1])):
        metrics = module.verification_metrics

        def recorded(emb1, emb2, *a, _metrics=metrics, _sims=sims, **k):
            e1 = np.asarray(emb1, np.float64)
            e2 = np.asarray(emb2, np.float64)
            _sims.append((e1 * e2).sum(1) / np.maximum(
                np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1),
                1e-12))
            return _metrics(emb1, emb2, *a, **k)

        monkeypatch.setattr(module, "verification_metrics", recorded)
    return kept


def _train_embedder_against_jax(monkeypatch, jx, trees, crops, tiny):
    _one_slot_mesh(monkeypatch)
    if tiny:
        _narrow(monkeypatch, det=False)
    js, ts = {}, {}
    _record(monkeypatch, jtrain, "ArcFaceTrainer", js, train_state_from_jax)
    _record(monkeypatch, ttrain, "ArcFaceTrainer", ts, train_state_from_jax)
    jsims, tsims = _pair_similarities(monkeypatch)
    jd, _, td, _ = trees
    train_ids, val_ids = np.asarray([0, 3, 5]), np.asarray([1, 7])
    # the port's trainer takes the crops JAX's aligned (the alignment is
    # held on its own in test_extract_aligned_matches_jax)
    aligned = []
    extract = jx.extract_aligned
    monkeypatch.setattr(jx, "extract_aligned", lambda *a, **k: (
        aligned.append(extract(*a, **k)) or aligned[-1]))
    jv, jcurve, jbest = jx.train_embedder(
        jd, crops, train_ids, val_ids, 2, batch=8, per_id=2, eval_every=2,
        log=lambda s: None)
    replay = iter(aligned)
    asked = []
    monkeypatch.setattr(tx, "extract_aligned", lambda det, c, ids, per_id,
                        seed, log=None: (asked.append(
                            (list(ids), per_id, seed)) or next(replay)))
    lines = []
    tv, tcurve, tbest = tx.train_embedder(
        td, crops, train_ids, val_ids, 2, batch=8, per_id=2, eval_every=2,
        log=lines.append, device="cpu", start=js["start"])
    assert ts.get("from") and "start" not in ts
    _losses_close(ts["losses"], js["losses"])
    # the accuracies: equal at step 0 (the same weights); after a step the
    # weights differ in their last float32 bits, and the accuracy sweep
    # over 160 pairs whose similarities sit close together (a model near
    # chance) can reorder them, so what is held there is every pair's
    # similarity
    assert [c[0] for c in tcurve] == [c[0] for c in jcurve] == [0, 2]
    assert tcurve[0] == jcurve[0]
    assert len(tsims) == len(jsims) == 4           # val, seen at 0 and 2
    for i, (t, j) in enumerate(zip(tsims, jsims)):
        gap = float(np.abs(t - j).max())
        assert gap <= STEP_SIM_TOL, (i, gap, tcurve, jcurve)
    assert tbest["step"] in (0, 2) and jbest["step"] in (0, 2)
    assert asked == [(list(train_ids), 2, 0), (list(val_ids), 6, 1),
                     (list(train_ids), 6, 3)]
    assert len(ts["batches"]) == len(js["batches"]) == 2
    for bt, bj in zip(ts["batches"], js["batches"]):
        _bit_equal(bt[0].transpose(0, 2, 3, 1), bj[0])
        np.testing.assert_array_equal(bt[1], bj[1])
    kinds = [json.loads(x) for x in lines]
    assert [k.get("stage", k.get("curve")) for k in kinds] == [
        "decisions_verification"] * 2 + ["model_selection"]


def test_train_embedder_matches_jax_from_its_state(monkeypatch, jx, trees,
                                                  crops):
    _train_embedder_against_jax(monkeypatch, jx, trees, crops, tiny=True)


@pytest.mark.slow
def test_train_embedder_matches_jax_at_full_width(monkeypatch, jx, trees,
                                                  crops):
    _train_embedder_against_jax(monkeypatch, jx, trees, crops, tiny=False)


def test_fine_tune_starts_from_the_given_weights(trees, crops):
    """``init_variables``: the trainers start from the given weights (the
    rest of the state fresh): with no step taken, the kept embedder is
    those weights and the detector scores the given one's AP."""
    _, _, td, te = trees
    ids = np.asarray([0, 1])
    vars_, best_curve, best = tx.train_embedder(
        td, crops, ids, np.asarray([2, 3]), 0, batch=4, per_id=2,
        log=lambda s: None, device="cpu", init_variables=te)
    assert best["step"] == 0 and [c[0] for c in best_curve] == [0]
    _checkpoint_trees_equal(te, vars_)
