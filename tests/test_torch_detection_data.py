"""The port's detection data and AP against the JAX package's, on the CPU.

``parse_wider_annotations``, ``letterbox_example`` and
``batches_from_annotations`` equal JAX's bit for bit on label files and
images this test writes (host numpy on both sides); ``average_precision``
equal on seeded sets; ``evaluate_detector`` on the committed trained
det_500m (``checkpoints/decisions/det_500m.msgpack``) equal to JAX's,
both given the same image loader. Without cv2 and without a loader the
port raises a clear error naming ``image_loader``.
"""
import sys

import numpy as np
import pytest
import jax

from scrfd_arcface_facerecognition_tpu.pipeline import Detector as JDetector
from scrfd_arcface_facerecognition_tpu.train import detection_data as JD
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector as TDetector)
from scrfd_arcface_facerecognition_tpu_torch.train import detection_data as TD
from test_torch_bf16 import face_frames, msgpack
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

LABELS = """# imgs/a.jpg
10 20 30 40 11.0 21.0 0.0 15.0 21.0 0.0 13.0 25.0 0.0 11.5 30.0 0.0 14.5 30.0 0.0 0.8
50 60 10 10 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 -1.0 0.2
70.5 5.25 21 33 75.0 12.0 1.0 85.0 12.0 1.0 80.0 18.0 -1.0 76.0 25.0 1.0 84.0 25.0 1.0 0.9

# imgs/b.jpg
5 5 20 20
# imgs/empty.jpg
# imgs/c.jpg
0 0 64 48 10.0 10.0 0.0 40.0 10.0 0.0 25.0 20.0 0.0 15.0 35.0 0.0 35.0 35.0 0.0 0.5
1 2 3 4 5 6 0 7 8 0 9 10 0 11 12 0 13 14 0 0.1
"""


def _assert_same_annotations(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.path == w.path
        for f in ("boxes", "kps", "kps_valid"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("root", [None, "elsewhere"])
def test_parse_wider_annotations_equals_jax(tmp_path, root):
    label = tmp_path / "label.txt"
    label.write_text(LABELS)
    images_root = None if root is None else str(tmp_path / root)
    got = TD.parse_wider_annotations(str(label), images_root)
    want = JD.parse_wider_annotations(str(label), images_root)
    _assert_same_annotations(got, want)
    assert [a.kps_valid.tolist() for a in got] == [
        [True, False, False], [False], [], [True, True]]
    assert np.isnan(got[0].kps[2, 2]).all() and not np.isnan(
        got[0].kps[2, [0, 1, 3, 4]]).any()


def _annotations(rng, n, shapes):
    anns, images = [], {}
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        k = int(rng.integers(0, 5))
        xy = rng.uniform(0, 0.7, (k, 2)) * (w, h)
        wh = rng.uniform(0.05, 0.3, (k, 2)) * (w, h)
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        kps = (xy[:, None] + rng.uniform(0, 1, (k, 5, 2)) * wh[:, None]
               ).astype(np.float32)
        valid = rng.uniform(size=k) < 0.7
        kps[~valid] = np.nan
        path = f"mem://{i}"
        anns.append((path, boxes, kps, valid))
        images[path] = rng.integers(0, 255, (h, w, 3), np.uint8)
    return anns, images


SHAPES = [(48, 80), (120, 64), (64, 64), (200, 150), (33, 47)]


@pytest.mark.parametrize("input_size,max_gt", [((64, 64), 3), ((96, 128), 8)])
def test_letterbox_example_equals_jax(input_size, max_gt):
    rng = np.random.default_rng(1)
    raw, images = _annotations(rng, 10, SHAPES)
    for path, boxes, kps, valid in raw:
        got = TD.letterbox_example(images[path], TD.Annotation(
            path, boxes, kps, valid), input_size, max_gt)
        want = JD.letterbox_example(images[path], JD.Annotation(
            path, boxes, kps, valid), input_size, max_gt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_batches_from_annotations_equal_jax(seed, normalize):
    """One shuffled pass, the tail padded with empty images, an image the
    loader cannot read left out."""
    rng = np.random.default_rng(2)
    raw, images = _annotations(rng, 8, SHAPES)
    images["mem://5"] = None                    # unreadable: skipped

    def load(path):
        return images[path]

    def run(mod):
        anns = [mod.Annotation(*r) for r in raw]
        return list(mod.batches_from_annotations(
            anns, 3, (64, 96), max_gt=4, seed=seed, image_loader=load,
            normalize=normalize))

    got, want = run(TD), run(JD)
    assert len(got) == len(want) == 3           # 7 images: 3 + 3 + 1 padded
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    images_t, _, _, valid_t, kvalid_t = got[-1]
    assert not valid_t[1:].any() and not kvalid_t[1:].any()   # padding
    pad = -127.5 / 128.0 if normalize else 0.0
    assert (images_t[1:] == pad).all()


def test_average_precision_equals_jax():
    rng = np.random.default_rng(4)
    for trial in range(20):
        n_img = int(rng.integers(1, 6))
        pbs, pss, gbs = [], [], []
        for _ in range(n_img):
            g = _boxes(rng, int(rng.integers(0, 5)))
            p = np.concatenate([g + rng.normal(0, 3, g.shape),
                                _boxes(rng, int(rng.integers(0, 4)))])
            if trial % 4 == 0:
                p = p[:0]
            gbs.append(g)
            pbs.append(p.astype(np.float32))
            s = rng.uniform(size=len(p))
            if trial % 3 == 0:
                s = np.round(s, 1)              # tied scores
            pss.append(s.astype(np.float32))
        for thr in (0.5, 0.7):
            assert TD.average_precision(pbs, pss, gbs, thr) == \
                JD.average_precision(pbs, pss, gbs, thr)
    gt = [np.asarray([[0., 0., 10., 10.], [20., 20., 30., 30.]])]
    assert TD.average_precision(gt, [np.asarray([0.9, 0.8])], gt) == 1.0
    assert TD.average_precision([], [], []) == 0.0


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1)


def test_evaluate_detector_equals_jax_on_the_trained_detector():
    """The committed trained det_500m over seeded smooth frames (where it
    finds faces at a low threshold) against faces near its own JAX
    detections: the port's AP and image count equal JAX's, both given one
    loader; each leaves the detector's conf_thres as it found it."""
    v = msgpack("det_500m.msgpack")
    kw = dict(input_size=(256, 256), conf_thres=0.5, pre_nms=64, max_det=8)
    jdet = JDetector("det_500m", variables=v, **kw)
    tdet = TDetector("det_500m", variables=jax.tree.map(np.asarray, v),
                     device="cpu", **kw)
    rng = np.random.default_rng(7)
    frames = face_frames(rng, 4, 180, 240)
    images = {f"mem://{i}": f for i, f in enumerate(frames)}
    images["mem://gone"] = None
    anns = []
    for i, f in enumerate(frames):
        jdet.conf_thres = 0.05
        det, _ = jdet.detect(f)
        boxes = det[:3, :4] + rng.normal(0, 2, det[:3, :4].shape)
        anns.append(JD.Annotation(f"mem://{i}", boxes.astype(np.float32),
                                  np.zeros((len(boxes), 5, 2), np.float32),
                                  np.ones(len(boxes), bool)))
    jdet.conf_thres = 0.5
    anns.append(JD.Annotation("mem://gone", np.zeros((0, 4), np.float32),
                              np.zeros((0, 5, 2), np.float32),
                              np.zeros(0, bool)))
    assert sum(len(a.boxes) for a in anns) >= 4

    def load(path):
        return images[path]

    for conf in (0.02, 0.1):
        want = JD.evaluate_detector(jdet, anns, image_loader=load,
                                    conf_thres=conf)
        got = TD.evaluate_detector(
            tdet, [TD.Annotation(a.path, a.boxes, a.kps, a.kps_valid)
                   for a in anns], image_loader=load, conf_thres=conf)
        assert got["images"] == want["images"] == 4
        assert 0.0 < want["ap"] <= 1.0
        assert got["ap"] == pytest.approx(want["ap"], abs=1e-9), conf
        assert tdet.conf_thres == jdet.conf_thres == 0.5


def test_without_cv2_a_loader_must_be_given(monkeypatch):
    """No cv2 and no ``image_loader``: a clear error naming the argument,
    before any image is skipped, from the batches and from the AP."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    ann = TD.Annotation("a.jpg", np.zeros((1, 4), np.float32),
                        np.zeros((1, 5, 2), np.float32), np.ones(1, bool))
    with pytest.raises(RuntimeError, match="image_loader="):
        next(TD.batches_from_annotations([ann], 1, (64, 64)))
    det = TDetector("det_500m", input_size=(64, 64), device="cpu")
    with pytest.raises(RuntimeError, match="image_loader="):
        TD.evaluate_detector(det, [ann])
    assert det.conf_thres == 0.5
    # a replaced reader serves both
    monkeypatch.setattr(TD, "read_image", lambda path: np.zeros(
        (32, 48, 3), np.uint8))
    batch = next(TD.batches_from_annotations([ann], 1, (64, 64)))
    assert batch[0].shape == (1, 64, 64, 3)
    assert TD.evaluate_detector(det, [ann])["images"] == 1
