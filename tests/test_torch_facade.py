"""The port's facade path (device="cpu") against the JAX package.

The resize and letterbox pieces on seeded random images: the exact u8
resize bit-equal to the JAX one (the 2x-down reroute and the general
case), ``letterbox_matrices`` equal, ``letterbox_dynamic`` within 1e-4 of
the JAX one and of the port's exact-shape ``letterbox``. The detector's
dynamic route, ``FacePipeline.call_dynamic`` and ``FaceAnalysis`` on the
committed trained det_500m + w600k_mbf checkpoints against the JAX
package (XLA warp on the CPU), at the tolerances of
``tests/test_torch_pipeline.py``: valid, count and match_idx (faces per
image) equal; boxes and kps atol 1e-2 px; scores and match_sim atol 1e-4;
embedding cosine >= 0.9999.
"""
import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.apps.face_analysis import (
    FaceAnalysis as JFaceAnalysis)
from scrfd_arcface_facerecognition_tpu.pipeline import detector as jdet
from scrfd_arcface_facerecognition_tpu_torch import ops as tops
from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
    FaceAnalysis as TFaceAnalysis)
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as twa
from scrfd_arcface_facerecognition_tpu_torch.pipeline import detector as tdet
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "decisions")
DET_SIZE = (256, 256)
CONF = 0.1
MAX_DET = 4

# (frame_hw, bucket_hw): the bucket is 256-px multiples, as the facade pads
DYN_CASES = [((300, 200), (512, 256)), ((444, 216), (512, 256)),
             ((256, 256), (256, 256)), ((100, 700), (256, 768)),
             ((97, 131), (256, 256))]


def _msgpack(name):
    from flax import serialization

    with open(os.path.join(_CKPT, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


def face_image(rng, h, w):
    """Smooth random content (upsampled noise) at (h, w): the trained
    detector finds faces in it at a low threshold."""
    import cv2

    base = rng.integers(0, 255, (max(2, h // 20), max(2, w // 20), 3))
    return cv2.resize(base.astype(np.float32), (w, h)).clip(
        0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def apps():
    det_v, emb_v = _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")
    kw = dict(det_variant="det_500m", rec_variant="w600k_mbf",
              det_variables=det_v, rec_variables=emb_v, max_det=MAX_DET)
    ja = JFaceAnalysis(dtype=jnp.float32, **kw)
    ta = TFaceAnalysis(device="cpu", **kw)
    for a in (ja, ta):
        a.prepare(det_size=DET_SIZE, det_thresh=CONF)
    return ja, ta


def assert_faces_agree(want, got, where=""):
    """Per image: face count equal; bbox, kps atol 1e-2 px; det_score atol
    1e-4; embedding cosine >= 0.9999."""
    assert len(got) == len(want), where
    for i, (fw, fg) in enumerate(zip(want, got)):
        assert len(fg) == len(fw), f"{where} image {i}: face count"
        for a, b in zip(fw, fg):
            np.testing.assert_allclose(b.bbox, a.bbox, atol=1e-2,
                                       err_msg=f"{where} image {i} bbox")
            np.testing.assert_allclose(b.kps, a.kps, atol=1e-2,
                                       err_msg=f"{where} image {i} kps")
            assert abs(b.det_score - a.det_score) <= 1e-4, (where, i)
            e1 = np.asarray(a.normed_embedding)
            e2 = np.asarray(b.normed_embedding)
            cos = float(e1 @ e2 / (np.linalg.norm(e1) * np.linalg.norm(e2)))
            assert cos >= 0.9999, (where, i, cos)


# ------------------------------------------------------------ resize ops

RESIZE_CASES = [((108, 192), (36, 64)), ((90, 160), (180, 320)),
                ((77, 123), (53, 99)), ((64, 64), (64, 64)),
                ((112, 112), (56, 56)),        # exact 2x down: the AREA path
                ((360, 640), (180, 320)),      # 2x down, 16:9
                ((7, 5), (13, 11)), ((1080, 1920), (360, 640))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_u8_exact_is_bit_equal_to_jax(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = rng.integers(0, 256, size=(2, *src, 3), dtype=np.uint8)
    want = np.asarray(jops.resize_bilinear_u8_exact(jnp.asarray(img), dst))
    got = tops.resize_bilinear_u8_exact(torch.from_numpy(img), dst).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resize_u8_exact_refuses_floats():
    with pytest.raises(ValueError, match="uint8"):
        tops.resize_bilinear_u8_exact(torch.zeros((4, 4, 3)), (2, 2))


@pytest.mark.parametrize("frame_hw", [(180, 320), (300, 200), (97, 131)])
def test_letterbox_exact_u8_matches_jax(frame_hw):
    rng = np.random.default_rng(frame_hw[0])
    img = rng.integers(0, 256, size=(*frame_hw, 3), dtype=np.uint8)
    plan = tops.letterbox_plan(frame_hw, DET_SIZE)
    jplan = jops.letterbox_plan(frame_hw, DET_SIZE)
    want = np.asarray(jops.letterbox(jnp.asarray(img), jplan, exact_u8=True))
    got = tops.letterbox(torch.from_numpy(img), plan, exact_u8=True).numpy()
    np.testing.assert_array_equal(got, want)
    # the default path stays the float one
    flt = tops.letterbox(torch.from_numpy(img), plan).numpy()
    assert np.abs(flt - got).max() <= 1.0 + 1e-4


@pytest.mark.parametrize("frame_hw,padded_hw", DYN_CASES)
def test_letterbox_matrices_equal_jax(frame_hw, padded_hw):
    want = jops.letterbox_matrices(frame_hw, padded_hw, (640, 640))
    got = tops.letterbox_matrices(frame_hw, padded_hw, (640, 640))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(ValueError, match="smaller than frame"):
        tops.letterbox_matrices(frame_hw, (frame_hw[0] - 1, frame_hw[1]))


def test_letterbox_dynamic_matches_jax_and_exact_shape():
    """One batch of the five shapes in their buckets' padding (the widest
    bucket): within 1e-4 of the JAX canvas and of each image's exact-shape
    letterbox."""
    rng = np.random.default_rng(0)
    ph = max(p[0] for _, p in DYN_CASES)
    pw = max(p[1] for _, p in DYN_CASES)
    frames = np.zeros((len(DYN_CASES), ph, pw, 3), np.uint8)
    wys, wxs, imgs = [], [], []
    for b, (hw, _) in enumerate(DYN_CASES):
        img = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
        frames[b, :hw[0], :hw[1]] = img
        wy, wx, _ = tops.letterbox_matrices(hw, (ph, pw), (640, 640))
        wys.append(wy)
        wxs.append(wx)
        imgs.append(img)
    wy, wx = np.stack(wys), np.stack(wxs)
    want = np.asarray(jops.letterbox_dynamic(jnp.asarray(frames),
                                             jnp.asarray(wy), jnp.asarray(wx)))
    got = tops.letterbox_dynamic(torch.from_numpy(frames),
                                 torch.from_numpy(wy),
                                 torch.from_numpy(wx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    for b, (hw, _) in enumerate(DYN_CASES):
        exact = tops.letterbox(torch.from_numpy(imgs[b]),
                               tops.letterbox_plan(hw, (640, 640))).numpy()
        np.testing.assert_allclose(got[b], exact, atol=1e-4, err_msg=str(hw))


# --------------------------------------------------- detect / pipeline


def _dynamic_batch(ta, images):
    """The facade's dynamic inputs for ``images`` in their one 256 x 256
    bucket (the shapes the facade's own call takes)."""
    return ta.dynamic_inputs(images, list(range(len(images))), (256, 256))


@pytest.fixture(scope="module")
def mixed_images():
    """Four one-off shapes of one 256-px bucket."""
    rng = np.random.default_rng(3)
    return [face_image(rng, h, w) for h, w in
            ((200, 256), (97, 131), (256, 180), (150, 250))]


def test_detect_batch_dynamic_matches_jax(apps, mixed_images):
    ja, ta = apps
    frames, wy, wx, scales, hws = _dynamic_batch(ta, mixed_images)
    model_hw = ta.detector.input_size
    kw = dict(model_hw=model_hw, conf_thres=CONF, iou_thres=0.4, pre_nms=64,
              max_det=MAX_DET, max_num=2, metric="default")
    want = jax.jit(functools.partial(
        jdet.detect_batch_dynamic, ja.detector.model.apply, **kw))(
        ja.detector.variables, jnp.asarray(frames), jnp.asarray(wy),
        jnp.asarray(wx), 1.0 / jnp.asarray(scales), jnp.asarray(hws))
    got = tdet.detect_batch_dynamic(
        ta.detector.model, torch.from_numpy(frames), torch.from_numpy(wy),
        torch.from_numpy(wx), 1.0 / torch.from_numpy(scales),
        torch.from_numpy(hws), **kw)
    jv = np.asarray(want.valid)
    assert jv.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-2)
    np.testing.assert_allclose(got.kps.numpy(), np.asarray(want.kps),
                               atol=1e-2)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)
    # selection by centre distance took each frame's own size
    assert int(np.asarray(want.count).max()) <= 2


def _outputs_agree(jo, to):
    jb, js, jk, jv, jc, je, ji, jm = (np.asarray(a) for a in jo[:8])
    tb, ts, tk, tv, tc, te, ti, tm = (t.numpy() for t in to)
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
    np.testing.assert_array_equal(te[~jv], je[~jv])


def test_call_dynamic_matches_jax(apps, mixed_images):
    ja, ta = apps
    batch = _dynamic_batch(ta, mixed_images)
    # a gallery of the reference's own embeddings among random rows
    first = ja._pipe.call_dynamic(*batch)
    valid = np.asarray(first.valid)
    assert valid.sum() > 0
    rng = np.random.default_rng(0)
    gal = np.concatenate([rng.normal(size=(3, 512)).astype(np.float32),
                          np.asarray(first.embeddings)[valid][:5]], 0)
    names = [f"p{i}" for i in range(len(gal))]
    for a in (ja, ta):
        a._pipe.set_gallery(gal, names)
    try:
        before = twa.launches
        for max_num, metric in ((0, "max"), (2, "default")):
            jo = ja._pipe.call_dynamic(*batch, max_num=max_num,
                                       metric=metric)
            to = ta._pipe.call_dynamic(*batch, max_num=max_num,
                                       metric=metric)
            _outputs_agree(jo, to)
        assert (to.match_idx.numpy() >= 3).sum() > 0     # real matches
        assert twa.launches == before    # the CPU path launches no kernel
    finally:
        for a in (ja, ta):
            a._pipe.set_gallery(np.zeros((0, 512), np.float32), [])


def test_unbucketed_call_matches_bucketed(apps):
    """``__call__(bucketed=False)`` embeds every slot: the same outputs as
    the bucketed path, and as the JAX package's unbucketed call."""
    ja, ta = apps
    rng = np.random.default_rng(5)
    frames = np.stack([face_image(rng, 180, 320) for _ in range(3)])
    full = ta._pipe(frames, max_num=3, bucketed=False)
    bucketed = ta._pipe(frames, max_num=3)
    assert int(full.valid.sum()) > 0
    for a, b in zip(full[:5] + full[6:], bucketed[:5] + bucketed[6:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    v = full.valid
    torch.testing.assert_close(full.embeddings[v], bucketed.embeddings[v],
                               rtol=0, atol=1e-5)
    assert bool((full.embeddings[~v] == 0).all())
    _outputs_agree(ja._pipe(jnp.asarray(frames), max_num=3, bucketed=False),
                   full)


# ------------------------------------------------------------- facade


@pytest.fixture(scope="module")
def static_group():
    rng = np.random.default_rng(11)
    return [face_image(rng, 180, 320) for _ in range(TFaceAnalysis.
                                                     MIN_STATIC_GROUP + 1)]


def test_get_batch_static_route_matches_jax(apps, static_group):
    ja, ta = apps
    calls = []
    orig = ta._pipe.call_dynamic
    ta._pipe.call_dynamic = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        got = ta.get_batch(static_group)
    finally:
        ta._pipe.call_dynamic = orig
    assert not calls                      # one static chunk, no bucket
    assert sum(len(f) for f in got) > 0
    assert_faces_agree(ja.get_batch(static_group), got, "static")


def test_get_batch_dynamic_route_matches_jax(apps, mixed_images):
    ja, ta = apps
    shapes = []
    orig = ta._pipe.call_dynamic

    def spy(frames, *a, **k):
        shapes.append(tuple(np.shape(frames)))
        return orig(frames, *a, **k)

    ta._pipe.call_dynamic = spy
    try:
        got = ta.get_batch(mixed_images)
    finally:
        ta._pipe.call_dynamic = orig
    assert shapes and all(s[1] % 256 == 0 and s[2] % 256 == 0
                          for s in shapes)
    assert sum(len(f) for f in got) > 0
    assert_faces_agree(ja.get_batch(mixed_images), got, "dynamic")


def test_streamed_static_chunks_keep_order_and_match_jax(apps):
    """Two same-shape groups of MIN_STATIC_GROUP images in different
    shapes, interleaved: two static chunks stream through process_stream;
    each image gets its own faces, as in the JAX facade and as each group
    run alone."""
    ja, ta = apps
    rng = np.random.default_rng(13)
    n = ta.MIN_STATIC_GROUP
    a = [face_image(rng, 128, 192) for _ in range(n)]
    b = [face_image(rng, 192, 128) for _ in range(n)]
    batch = [x for pair in zip(a, b) for x in pair]
    streamed = []
    orig = ta._pipe.process_stream

    def spy(it, **kw):
        streamed.append(1)
        return orig(it, **kw)

    ta._pipe.process_stream = spy
    try:
        got = ta.get_batch(batch)
    finally:
        ta._pipe.process_stream = orig
    assert streamed == [1]
    assert sum(len(f) for f in got) > 0
    assert_faces_agree(ja.get_batch(batch), got, "streamed")
    assert_faces_agree(ta.get_batch(a), got[0::2], "group a alone")
    assert_faces_agree(ta.get_batch(b), got[1::2], "group b alone")


def test_get_matches_get_batch(apps, mixed_images):
    _, ta = apps
    batch = ta.get_batch(mixed_images, max_num=1)
    assert sum(len(f) for f in batch) > 0
    for i, im in enumerate(mixed_images):
        assert_faces_agree([batch[i]], [ta.get(im, max_num=1)], f"get {i}")


def test_power_of_two_padding_leaves_faces_unchanged(apps, mixed_images):
    """The JAX facade pads each batch with zero images to a power of two
    (its compile count); the port does not. Padding a static chunk of 5
    and a dynamic chunk of 3 changes no image's faces."""
    _, ta = apps
    rng = np.random.default_rng(17)
    five = np.stack([face_image(rng, 180, 320) for _ in range(5)])
    padded = np.concatenate([five, np.zeros((3, *five.shape[1:]),
                                            np.uint8)])
    want, got = [None] * 5, [None] * 8
    ta._scatter_faces(ta._pipe(five), list(range(5)), want)
    ta._scatter_faces(ta._pipe(padded), list(range(8)), got)
    assert sum(len(f) for f in want) > 0
    assert_faces_agree(want, got[:5], "static padded")

    three = mixed_images[:3]
    frames, wy, wx, sc, hws = ta.dynamic_inputs(three, [0, 1, 2], (512, 512))
    pad = lambda a, v=0: np.concatenate(  # noqa: E731
        [a, np.full((1, *a.shape[1:]), v, a.dtype)])
    want, got = [None] * 3, [None] * 4
    ta._scatter_faces(ta._pipe.call_dynamic(frames, wy, wx, sc, hws),
                      [0, 1, 2], want)
    ta._scatter_faces(ta._pipe.call_dynamic(
        pad(frames), pad(wy), pad(wx), pad(sc, 1), pad(hws, 512)),
        [0, 1, 2, 3], got)
    assert sum(len(f) for f in want) > 0
    assert_faces_agree(want, got[:3], "dynamic padded")


def test_facade_arguments_and_device(monkeypatch, tmp_path):
    """bfloat16 builds bfloat16 models, dtype=None is float32 on the CPU,
    a dtype the models do not compute in raises; ``det_onnx`` /
    ``rec_onnx`` load the files through the graph executor and run them;
    no card, no facade."""
    bf = TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                       dtype=torch.bfloat16, device="cpu")
    assert bf.dtype == bf.detector.dtype == bf.embedder.dtype == torch.bfloat16
    assert TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                         device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                      dtype=torch.float16, device="cpu")
    from scrfd_arcface_facerecognition_tpu_torch.models import graph_models
    from torch_export import TorchIResNet, TorchSCRFD, export_onnx, seeded

    det, rec = str(tmp_path / "det.onnx"), str(tmp_path / "rec.onnx")
    export_onnx(seeded(TorchSCRFD(stem=8, blocks=(1, 1, 1, 1),
                                  planes=(8, 8, 16, 16), neck=8,
                                  head_feat=16, head_stacks=1), 0),
                torch.randn(1, 3, 640, 640), det)
    export_onnx(seeded(TorchIResNet(blocks=(1, 1, 1, 1),
                                    planes=(8, 8, 16, 16)), 0),
                torch.randn(1, 3, 112, 112), rec)
    image = np.random.default_rng(5).integers(0, 255, (96, 128, 3), np.uint8)
    for kw in (dict(det_onnx=det, rec_onnx=rec), dict(det_onnx=det),
               dict(rec_onnx=rec)):
        ta = TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                           device="cpu", **kw)
        ta.prepare(det_size=(128, 128), det_thresh=0.0)
        assert isinstance(ta.detector.model, graph_models.SCRFDGraphModule) \
            == ("det_onnx" in kw)
        assert isinstance(ta.embedder.model, graph_models.ArcFaceGraphModule) \
            == ("rec_onnx" in kw)
        faces = ta.get_batch([image])[0]
        assert faces and all(
            f.embedding.shape == (512,) and np.isfinite(f.embedding).all()
            for f in faces)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf")
