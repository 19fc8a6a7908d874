"""Port ops vs the JAX reference on the same numpy inputs (CPU).

Each test feeds one seeded numpy input to the JAX function and to its
PyTorch counterpart in ``scrfd_arcface_facerecognition_tpu_torch.ops`` and
states its tolerance.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.ops import nms as jnms
from scrfd_arcface_facerecognition_tpu.ops import warp as jwarp
from scrfd_arcface_facerecognition_tpu.pipeline.face_pipeline import (
    _match_gallery as j_match_gallery)
from scrfd_arcface_facerecognition_tpu_torch import ops as tops
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as twa
from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
    _match_gallery as t_match_gallery)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def _t(a):
    return torch.tensor(np.asarray(a))


def _smooth_frames(rng, b, h, w):
    """Smooth u8 content, so resampling differences are meaningful."""
    import cv2

    base = rng.integers(0, 255, (b, max(h // 8, 2), max(w // 8, 2), 3))
    return np.stack([cv2.resize(x.astype(np.float32), (w, h)) for x in base]
                    ).clip(0, 255).astype(np.uint8)


# ------------------------------------------------- normalize / anchors / decode


@pytest.mark.parametrize("mean,std", [(jops.SCRFD_MEAN, jops.SCRFD_STD),
                                      (jops.ARCFACE_MEAN, jops.ARCFACE_STD)])
def test_normalize_image(mean, std):
    x = np.random.default_rng(0).integers(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    want = np.asarray(jops.normalize_image(jnp.asarray(x), mean, std))
    got = tops.normalize_image(_t(x), mean, std).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)   # stated: 1e-5


@pytest.mark.parametrize("hw", [(640, 640), (384, 640), (192, 320)])
def test_anchor_tables(hw):
    want = np.asarray(jops.scrfd_anchor_table(hw))
    got = tops.scrfd_anchor_table(hw, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    want8 = np.asarray(jops.anchor_centers(hw[0] // 8, hw[1] // 8, 8))
    np.testing.assert_allclose(
        tops.anchor_centers(hw[0] // 8, hw[1] // 8, 8, device="cpu").numpy(), want8,
        atol=1e-5)


@pytest.mark.parametrize("max_shape", [None, (300, 400)])
def test_decode(max_shape):
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 400, (3, 50, 2)).astype(np.float32)
    dist = rng.uniform(-20, 80, (3, 50, 4)).astype(np.float32)
    dk = rng.uniform(-40, 40, (3, 50, 10)).astype(np.float32)
    np.testing.assert_allclose(
        tops.distance2bbox(_t(pts), _t(dist), max_shape).numpy(),
        np.asarray(jops.distance2bbox(jnp.asarray(pts), jnp.asarray(dist),
                                      max_shape)), atol=1e-5)
    np.testing.assert_allclose(
        tops.distance2kps(_t(pts), _t(dk), max_shape).numpy(),
        np.asarray(jops.distance2kps(jnp.asarray(pts), jnp.asarray(dk),
                                     max_shape)), atol=1e-5)


# ---------------------------------------------------------------- letterbox


_PLAN_CASES = [((1080, 1920), (640, 640)), ((720, 1280), (640, 640)),
               ((1920, 1080), (640, 640)), ((480, 640), (640, 640)),
               ((320, 320), (320, 320)), ((181, 333), (320, 320)),
               ((500, 200), (384, 640))]


@pytest.mark.parametrize("frame_hw,model_hw", _PLAN_CASES)
def test_letterbox_plans_equal(frame_hw, model_hw):
    for fn in ("letterbox_plan", "tight_letterbox_plan"):
        want = getattr(jops, fn)(frame_hw, model_hw)
        got = getattr(tops, fn)(frame_hw, model_hw)
        assert (got.frame_hw, got.model_hw, got.new_hw, got.det_scale) == (
            want.frame_hw, want.model_hw, want.new_hw, want.det_scale), fn


@pytest.mark.parametrize("frame_hw,model_hw,tight", [
    ((90, 160), (64, 64), False), ((90, 160), (640, 640), True),
    ((120, 60), (96, 128), False)])
def test_letterbox_canvas(frame_hw, model_hw, tight):
    frames = np.random.default_rng(2).integers(
        0, 256, (2, *frame_hw, 3)).astype(np.uint8)
    plan_fn = "tight_letterbox_plan" if tight else "letterbox_plan"
    jplan = getattr(jops, plan_fn)(frame_hw, model_hw)
    tplan = getattr(tops, plan_fn)(frame_hw, model_hw)
    want = np.asarray(jops.letterbox(jnp.asarray(frames), jplan))
    got = tops.letterbox(_t(frames), tplan).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)   # u8 units


# ------------------------------------------------------- umeyama / inverse


def _landmarks(rng, n):
    dst = np.asarray(jops.ARCFACE_DST)
    ang = rng.uniform(-np.pi, np.pi, n)
    scale = rng.uniform(0.3, 4.0, n)
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    pts = (dst[None] @ rot.transpose(0, 2, 1)) * scale[:, None, None]
    pts += rng.uniform(0, 800, (n, 1, 2)) + rng.normal(0, 2.0, (n, 5, 2))
    return pts.astype(np.float32)


def test_estimate_norm_and_invert_affine():
    kps = _landmarks(np.random.default_rng(3), 64)
    want = np.asarray(jops.estimate_norm(jnp.asarray(kps)))
    got = tops.estimate_norm(_t(kps)).numpy()
    # stated: rtol 1e-5 (atol scaled to each matrix's magnitude for the
    # entries that cancel to near zero)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    wi = np.asarray(jwarp.invert_affine(jnp.asarray(want)))
    gi = tops.invert_affine(_t(want)).numpy()
    np.testing.assert_allclose(gi, wi, rtol=1e-5, atol=1e-5 * np.abs(wi).max())


def test_estimate_norm_degenerate_landmarks_match_reference():
    """All-equal landmarks: var_s clamps to 1e-12, the inverse divides by
    a zero determinant — both sides give the same non-finite pattern."""
    kps = np.full((2, 5, 2), 40.0, np.float32)
    kps[1] = np.nan
    want = np.asarray(jwarp.invert_affine(jops.estimate_norm(jnp.asarray(kps))))
    got = tops.invert_affine(tops.estimate_norm(_t(kps))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ------------------------------------------------------- K1 plain version


def _warp_cases(rng, b, h, w, n):
    """(F, 2, 3) src -> dst matrices: rotations to 180 deg, scales
    0.2-4, crops partly and wholly off-frame, plus degenerate ones."""
    ms = []
    for i in range(n):
        sigma = rng.uniform(0.2, 4.0)          # source px per crop px
        ang = rng.uniform(-np.pi, np.pi)
        cx = rng.uniform(-0.3 * w, 1.3 * w)
        cy = rng.uniform(-0.3 * h, 1.3 * h)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        t = np.array([55.5, 55.5]) - rot @ np.array([cx, cy])
        ms.append(np.concatenate([rot, t[:, None]], 1))
    ms = np.stack(ms).astype(np.float32)
    ms[0] = 0.0                                 # singular: inf/NaN inverse
    ms[1, :, 2] = np.nan                        # NaN translation
    ms[2] = [[1, 0, -1e6], [0, 1, 0]]           # wholly off-frame
    fidx = rng.integers(0, b, n).astype(np.int32)
    return ms, fidx


def _jax_k1(frames, ms, fidx):
    crops = jwarp.warp_affine_flat(jnp.asarray(frames), jnp.asarray(ms),
                                   jnp.asarray(fidx))
    net = jops.normalize_image(crops, jops.ARCFACE_MEAN, jops.ARCFACE_STD)
    return np.asarray(net).transpose(0, 3, 1, 2)


def test_k1_plain_matches_reference_warp():
    rng = np.random.default_rng(4)
    frames = _smooth_frames(rng, 3, 90, 150)
    ms, fidx = _warp_cases(rng, 3, 90, 150, 24)
    want = _jax_k1(frames, ms, fidx)
    minv = tops.invert_affine(_t(ms))
    got = tops.warp_align_plain(_t(frames), minv, _t(fidx)).numpy()
    assert got.shape == (24, 3, 112, 112)
    # stated: 1e-3 in u8 units; NaN where the reference gives NaN
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:2]).all() and np.isfinite(got[2:]).all()
    np.testing.assert_allclose(got * 127.5, want * 127.5, atol=1e-3)


def test_k1_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    frames = _smooth_frames(rng, 2, 64, 96)
    ms, fidx = _warp_cases(rng, 2, 64, 96, 6)
    minv = tops.invert_affine(_t(ms))
    before = twa.launches
    got = tops.warp_align_crops(_t(frames), minv, _t(fidx))
    assert twa.launches == before       # no kernel launch on the CPU
    want = tops.warp_align_plain(_t(frames), minv, _t(fidx))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert tops.warp_align_crops(
        _t(frames), minv[:0], _t(fidx[:0])).shape == (0, 3, 112, 112)


@pytest.mark.slow
def test_k1_plain_vs_pallas_kernel_inside_envelope():
    """The exact warp against the TPU kernel (interpret mode) on in-envelope
    crops, with that kernel's own bars against the exact warp (mean < 2.5,
    p99 < 16 u8). Canvas-level crops are held to warp_affine_flat only."""
    from scrfd_arcface_facerecognition_tpu.ops import pallas_warp as pw

    rng = np.random.default_rng(123)
    frames = _smooth_frames(rng, 2, 540, 960)
    specs = []
    for _ in range(24):
        sigma = rng.uniform(0.45, pw.SIGMA_MAX - 0.03)
        ang = rng.uniform(-0.22, 0.22)
        cx, cy = rng.uniform(120, 840), rng.uniform(100, 440)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        t = np.array([55.5, 55.5]) - rot @ np.array([cx, cy])
        specs.append(np.concatenate([rot, t[:, None]], 1))
    ms = np.stack(specs).astype(np.float32)
    fidx = rng.integers(0, 2, len(specs)).astype(np.int32)
    plan = jops.letterbox_plan((540, 960), (640, 640))
    params = pw.prepare_warp_params(jnp.asarray(ms), jnp.asarray(fidx),
                                    (540, 960), plan.det_scale)
    canvas = jnp.clip(jnp.round(jops.letterbox(jnp.asarray(frames), plan)),
                      0, 255).astype(jnp.uint8)
    pallas = np.asarray(pw.warp_crops_pallas(
        pw.planarize(jnp.asarray(frames)), pw.planarize(canvas), params,
        interpret=True))
    port = tops.warp_align_plain(_t(frames), tops.invert_affine(_t(ms)),
                                 _t(fidx)).numpy()
    port_u8 = (port * 127.5 + 127.5).transpose(0, 2, 3, 1)[..., ::-1]  # BGR
    exact = np.asarray(jwarp.warp_affine_flat(jnp.asarray(frames),
                                              jnp.asarray(ms),
                                              jnp.asarray(fidx)))
    np.testing.assert_allclose(port_u8, exact, atol=1e-3)
    level = np.asarray(params.iparams)[:, 1]
    ok = ~np.asarray(params.fallback) & (level == 0)
    assert ok.sum() >= len(specs) - 2
    for i in np.nonzero(ok)[0]:
        d = np.abs(port_u8[i] - pallas[i])
        assert d.mean() < 2.5, (i, d.mean())
        assert np.percentile(d, 99) < 16.0, i


# ---------------------------------------------------------------------- NMS


def _slate(rng, k, n_valid, tie_frac):
    """Score-descending slate of k boxes; a share of exactly tied scores;
    clustered boxes so suppression really happens; the tail invalid."""
    centers = rng.uniform(50, 300, (max(k // 6, 1), 2))
    c = centers[rng.integers(0, len(centers), k)] + rng.normal(0, 8, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.uniform(0.05, 1.0, k)).astype(np.float32)[::-1]
    n_tie = int(k * tie_frac)
    scores[:n_tie] = 1.0                       # saturated, exactly tied
    valid = np.arange(k) < n_valid
    kps = rng.uniform(0, 400, (k, 5, 2)).astype(np.float32)
    return boxes, scores.copy(), valid, kps


@pytest.mark.parametrize("k,n_valid,tie_frac,iou", [
    (40, 33, 0.5, 0.4), (70, 50, 1.0, 0.3), (100, 7, 0.2, 0.5),
    (256, 200, 0.3, 0.4)])
def test_nms_mask_compaction_and_selection(k, n_valid, tie_frac, iou):
    rng = np.random.default_rng(k * 7 + n_valid)
    boxes, scores, valid, kps = _slate(rng, k, n_valid, tie_frac)
    want_keep = np.asarray(jnms.nms_mask_blocked(jnp.asarray(boxes), iou,
                                                 jnp.asarray(valid)))
    got_keep = tops.nms_mask_blocked(_t(boxes), iou, _t(valid)).numpy()
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_allclose(
        tops.iou_matrix_legacy(_t(boxes)).numpy(),
        np.asarray(jnms.iou_matrix_legacy(jnp.asarray(boxes))), atol=1e-6)

    det = np.concatenate([boxes, scores[:, None]], 1)
    max_out = min(16, k)
    jout = jnms.compact_by_mask(jnp.asarray(want_keep), jnp.asarray(det),
                                jnp.asarray(kps), max_out=max_out)
    tout = tops.compact_by_mask(_t(got_keep), _t(det), _t(kps),
                                max_out=max_out)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    _, mask_c, det_c, kps_c = (np.asarray(x) for x in jout)
    # ties in area too: duplicate a few compacted rows' geometry
    det_c = det_c.copy()
    det_c[1::3, :4] = det_c[0, :4]
    for metric in ("max", "default"):
        for max_num in (1, 3, max_out):
            want = jnms.select_top_faces(
                jnp.asarray(det_c), jnp.asarray(kps_c), jnp.asarray(mask_c),
                max_num, metric, frame_hw=(360, 480))
            got = tops.select_top_faces(_t(det_c), _t(kps_c), _t(mask_c),
                                        max_num, metric, frame_hw=(360, 480))
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_nms_batched_equals_per_slate():
    rng = np.random.default_rng(9)
    slates = [_slate(rng, 48, 40, 0.3) for _ in range(3)]
    boxes = np.stack([s[0] for s in slates])
    valid = np.stack([s[2] for s in slates])
    got = tops.nms_mask_blocked(_t(boxes), 0.4, _t(valid)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jnms.nms_mask_blocked(
                jnp.asarray(boxes[i]), 0.4, jnp.asarray(valid[i]))))


# ------------------------------------------------------------ gallery match


def test_match_gallery():
    rng = np.random.default_rng(10)
    gal = rng.normal(size=(12, 32)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    emb = rng.normal(size=(9, 32)).astype(np.float32)
    emb[:4] = gal[[3, 7, 7, 11]] + 0.01 * emb[:4]    # near-matches
    emb[4] = gal[5] * 0.0                            # zero embedding
    emb[5] = np.nan                                  # non-finite slot
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    emb[5] = np.nan
    gvalid = np.ones(12, bool)
    gvalid[11] = False                               # masked gallery row
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1, 0], bool)
    for gv in (gvalid, np.zeros(12, bool)):          # and an empty gallery
        want = j_match_gallery(jnp.asarray(emb), jnp.asarray(gal),
                               jnp.asarray(gv), jnp.asarray(valid), 0.4)
        got = t_match_gallery(_t(emb), _t(gal), _t(gv), _t(valid), 0.4)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-6)
