"""The port's pipeline (device="cpu") vs the JAX FacePipeline.

The JAX side runs its XLA warp (use_pallas_warp="off") with the same
tight canvas; both load the committed trained det_500m + w600k_mbf
checkpoints and see the same seeded synthetic frames. Tolerances: valid,
count and match_idx equal; boxes and kps atol 1e-2 px; scores and
match_sim atol 1e-4; embeddings on valid slots cosine >= 0.9999.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.pipeline import detector as jdet
from scrfd_arcface_facerecognition_tpu.pipeline import (
    Detector as JDetector, Embedder as JEmbedder, FacePipeline as JPipeline)
from scrfd_arcface_facerecognition_tpu_torch import ops as tops
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as twa
from scrfd_arcface_facerecognition_tpu_torch.pipeline import detector as tdet
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector as TDetector, Embedder as TEmbedder, FacePipeline as TPipeline)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "decisions")
_DET_KW = dict(input_size=(320, 320), conf_thres=0.1, pre_nms=64, max_det=8)


def _msgpack(name):
    from flax import serialization

    with open(os.path.join(_CKPT, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def weights():
    return _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")


@pytest.fixture(scope="module")
def frames():
    import cv2

    rng = np.random.default_rng(2)
    base = rng.integers(0, 255, (2, 9, 16, 3)).astype(np.float32)
    return np.stack([cv2.resize(b, (320, 180)) for b in base]
                    ).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pipelines(weights):
    det_v, emb_v = weights
    jp = JPipeline(detector=JDetector("det_500m", variables=det_v, **_DET_KW),
                   embedder=JEmbedder("w600k_mbf", variables=emb_v),
                   use_pallas_warp="off", tight_canvas=True,
                   gallery_capacity=16)
    tp = TPipeline(detector=TDetector("det_500m", variables=det_v,
                                      device="cpu", **_DET_KW),
                   embedder=TEmbedder("w600k_mbf", variables=emb_v,
                                      device="cpu"),
                   tight_canvas=True, gallery_capacity=16, device="cpu")
    return jp, tp


def _assert_outputs_agree(jo, to):
    jo = jax.tree.map(np.asarray, jo)
    to = [t.numpy() for t in to]
    (jb, js, jk, jv, jc, je, ji, jm) = jo
    (tb, ts, tk, tv, tc, te, ti, tm) = to
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tb, jb, atol=1e-2)
    np.testing.assert_allclose(tk, jk, atol=1e-2)
    np.testing.assert_allclose(ts, js, atol=1e-4)
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    a, b = te[jv], je[jv]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.9999, cos
    np.testing.assert_array_equal(te[~jv], je[~jv])      # zero slots


def test_face_pipeline_matches_reference(pipelines, frames):
    jp, tp = pipelines
    # gallery: the reference's own embeddings of the valid faces, among
    # random rows, so matches really happen
    first = jp(jnp.asarray(frames), max_num=2, metric="default")
    valid = np.asarray(first.valid)
    assert valid.sum() > 0
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(6, 512)).astype(np.float32)
    gal = np.concatenate([gal, np.asarray(first.embeddings)[valid]], 0)
    names = [f"p{i}" for i in range(len(gal))]
    jp.set_gallery(gal, names)
    tp.set_gallery(gal, names)

    launches = twa.launches
    for max_num, metric in ((2, "default"), (0, "max")):
        jo = jp(jnp.asarray(frames), max_num=max_num, metric=metric)
        to = tp(frames, max_num=max_num, metric=metric)
        _assert_outputs_agree(jo, to)
        assert (to.match_idx.numpy() >= 6).sum() > 0     # real matches
        assert tp.match_names(to) == jp.match_names(jo)
    assert twa.launches == launches     # the CPU path launches no kernel

    streamed = list(tp.process_stream([frames, frames[::-1]], max_num=2))
    assert len(streamed) == 2
    for got, f in zip(streamed, (frames, frames[::-1])):
        want = tp(f, max_num=2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_selection_applies_only_above_max_num(pipelines, frames):
    """Frame 0 has more faces than max_num=2 (area selection), frame 1
    not (score order kept)."""
    jp, tp = pipelines
    counts = tp(frames).count.numpy()
    assert counts[0] > 2 and counts[1] <= 2
    _assert_outputs_agree(jp(jnp.asarray(frames), max_num=2),
                          tp(frames, max_num=2))


def test_no_faces_gives_empty_outputs(weights):
    det_v, emb_v = weights
    tp = TPipeline(detector=TDetector("det_500m", variables=det_v,
                                      device="cpu", input_size=(320, 320),
                                      conf_thres=1.01),
                   embedder=TEmbedder("w600k_mbf", variables=emb_v,
                                      device="cpu"),
                   gallery_capacity=4, device="cpu")
    out = tp(np.zeros((1, 64, 96, 3), np.uint8))
    assert out.count.tolist() == [0]
    assert (out.match_idx == -1).all() and (out.embeddings == 0).all()


def _fake_outputs(rng, hw, tie=True):
    """Per-stride head outputs with saturated (tied) scores, the random-init
    regime."""
    h, w = hw
    out = {"scores": [], "bboxes": [], "kps": []}
    for s in (8, 16, 32):
        n = (h // s) * (w // s) * 2
        sc = rng.uniform(0, 1, (1, n, 1)).astype(np.float32)
        if tie:
            sc[:, rng.random(n) < 0.3] = 1.0
        out["scores"].append(sc)
        out["bboxes"].append(rng.uniform(0.5, 4, (1, n, 4)).astype(np.float32))
        out["kps"].append(rng.uniform(-3, 3, (1, n, 10)).astype(np.float32))
    return out


@pytest.mark.parametrize("max_num,metric", [(0, "max"), (3, "max"),
                                            (3, "default"), (20, "max")])
def test_detect_batch_with_tied_scores(max_num, metric):
    rng = np.random.default_rng(max_num)
    frame_hw = (150, 200)
    jplan = jops.tight_letterbox_plan(frame_hw, (128, 128))
    tplan = tops.tight_letterbox_plan(frame_hw, (128, 128))
    outs = _fake_outputs(rng, jplan.model_hw)
    frames = np.zeros((1, *frame_hw, 3), np.uint8)
    kw = dict(conf_thres=0.5, iou_thres=0.4, pre_nms=50, max_det=16,
              max_num=max_num, metric=metric)
    want = jax.jit(lambda f: jdet.detect_batch(
        lambda v, x: jax.tree.map(jnp.asarray, outs), None, f, plan=jplan,
        want_canvas=False, **kw))(jnp.asarray(frames))

    class Fake(torch.nn.Module):
        def forward(self, x):
            return {k: [torch.tensor(a) for a in v] for k, v in outs.items()}

    got = tdet.detect_batch(Fake(), torch.tensor(frames), plan=tplan, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-4)
    np.testing.assert_allclose(got.kps.numpy(), np.asarray(want.kps),
                               atol=1e-4)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def _jax_get_feat(embedder, crop):
    """The JAX Embedder.get_feat computation, jitted (its eager form runs
    op by op and dominates the test's time)."""
    net_in = jops.normalize_image(jnp.asarray(crop[None]), jops.ARCFACE_MEAN,
                                  jops.ARCFACE_STD)
    return np.asarray(jax.jit(embedder.model.apply)(embedder.variables,
                                                    net_in))


def test_detector_and_embedder_single_image_apis(pipelines, frames):
    jp, tp = pipelines
    jd, td, je, te = jp.detector, tp.detector, jp.embedder, tp.embedder
    jdets, jkps = jd.detect(frames[0], max_num=2)
    tdets, tkps = td.detect(frames[0], max_num=2)
    assert len(tdets) == len(jdets) > 0
    np.testing.assert_allclose(tdets, jdets, atol=1e-2)
    np.testing.assert_allclose(tkps, jkps, atol=1e-2)

    for got, want in ((te(frames[0], tkps[0]), je(frames[0], jkps[0])),
                      (te.get_feat(frames[0, :112, :112]),
                       _jax_get_feat(je, frames[0, :112, :112]))):
        got, want = np.ravel(got), np.ravel(want)
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.9999, cos
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_build_targets_from_images(pipelines, frames):
    jp, tp = pipelines
    n = tp.build_targets_from_images([frames[0], frames[1]], ["a", "b"])
    assert n == jp.build_targets_from_images([frames[0], frames[1]],
                                             ["a", "b"]) == 2
    assert tp.names == ["a", "b"]
    np.testing.assert_allclose(tp._gallery[:2].numpy(),
                               np.asarray(jp._gallery[:2]), atol=1e-4)
    tp.detector.conf_thres = 1.01          # nothing can pass
    try:
        with pytest.raises(ValueError, match="no faces"):
            tp.build_targets_from_images([frames[0]], ["x"])
    finally:
        tp.detector.conf_thres = _DET_KW["conf_thres"]
    assert tp.names == ["a", "b"]          # gallery left unchanged
