"""bfloat16 compute: the port against the JAX package at bf16 (CPU).

The same seeded numpy inputs go through the JAX models and pipeline at
``dtype=jnp.bfloat16`` and through the port at ``torch.bfloat16``, on the
tiny configs of ``tests/test_torch_models.py`` (seeded Flax init) and on
the committed trained ``checkpoints/decisions/{det_500m,w600k_mbf}``.
bf16 parity is not bitwise (each side accumulates in float32 in its own
order and rounds to bf16 between layers), so the tolerances count bf16
ulps (``bf16_ulp``: 2^(floor(log2 x) - 7)):

- head outputs within 2 ulps at the output's largest magnitude (scores:
  the logits' 2 ulps through the sigmoid's slope; a random-init net may
  also stray as far as JAX's own bf16 strays from its float32); embedding
  cosine >= 0.9999; and on the checkpoints the port's bf16 outputs stray
  from its own float32 ones by at least half an ulp (heads) or 1e-6 of
  1 - cosine (embeddings), so a forward that stays float32 fails;
- ``letterbox(dtype=bf16)`` within 1 intensity step of the JAX one;
- detections matched by IoU >= 0.9; a face found on one side only must
  have a score within 2 ulps of ``conf_thres`` or of the pre-NMS slate's
  cut, or overlap a face of the other side at an IoU within 0.05 of the
  NMS threshold (a tie that one ulp moves); such faces are counted and
  printed, not hidden, and stay at most ``MAX_TIES`` a test; matched boxes and kps within 2 ulps of the box's
  extent in canvas pixels, over det_scale (the stride-unit distances the
  head outputs carry one ulp of their magnitude, times the stride);
  scores within 2 ulps of 1;
- match_idx equal wherever both sides' match_sim is more than 2 ulps
  from the similarity threshold; embeddings of matched faces cosine
  >= 0.999.
"""
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.apps.face_analysis import (
    FaceAnalysis as JFaceAnalysis)
from scrfd_arcface_facerecognition_tpu.models import arcface as jarc
from scrfd_arcface_facerecognition_tpu.models import scrfd as jscrfd
from scrfd_arcface_facerecognition_tpu.models.init_utils import cpu_init
from scrfd_arcface_facerecognition_tpu.pipeline import (
    Detector as JDetector, Embedder as JEmbedder, FacePipeline as JPipeline)
from scrfd_arcface_facerecognition_tpu_torch import ops as tops
from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
    FaceAnalysis as TFaceAnalysis)
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as tarc
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as tscrfd
from scrfd_arcface_facerecognition_tpu_torch.models import load_flax_variables
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector as TDetector, Embedder as TEmbedder, FacePipeline as TPipeline)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "decisions")
_TINY_DET = dict(name="tiny_det", stem_filters=8, stage_blocks=(1, 2, 1, 1),
                 stage_filters=(8, 8, 16, 24), neck_filters=8, head_stacks=2,
                 head_filters=16, gn_groups=4)
_TINY_R = dict(name="tiny_r", arch="iresnet", emb_dim=32,
               stage_blocks=(1, 2, 1, 1), stage_filters=(8, 16, 16, 32))
_TINY_MBF = dict(name="tiny_mbf", arch="mobilefacenet", emb_dim=32,
                 mbf_blocks=(2, 1, 2, 1), mbf_stem_filters=16,
                 mbf_stem_dw_groups=8, mbf_stage_filters=(16, 24, 24),
                 mbf_down_groups=(16, 32, 32), mbf_res_groups=(16, 16, 32, 32),
                 mbf_sep_filters=32)
DET_KW = dict(input_size=(256, 256), conf_thres=0.1, pre_nms=64, max_det=6)
SIM = 0.4
MAX_TIES = 2     # faces found on one side only, each a checked tie, a test


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    x = abs(float(x))
    if x == 0 or not math.isfinite(x):
        return 0.0
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def msgpack(name):
    from flax import serialization

    with open(os.path.join(_CKPT, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


def face_frames(rng, n, h, w):
    """Smooth seeded content (upsampled noise): the trained detector finds
    faces in it at a low threshold."""
    import cv2

    base = rng.integers(0, 255, (n, max(2, h // 20), max(2, w // 20), 3))
    return np.stack([cv2.resize(b.astype(np.float32), (w, h)) for b in base]
                    ).clip(0, 255).astype(np.uint8)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


# ------------------------------------------------------------- the models


def score_tol(s, logit_max):
    """2 ulps of the logits (at their largest magnitude) through the
    sigmoid's slope, plus 2 ulps of the score's own rounding."""
    s = np.asarray(s, np.float64)
    return (2 * bf16_ulp(logit_max) * s * (1 - s)
            + 2 * np.vectorize(bf16_ulp)(s))


def _check_head(jmodel, jvars, tmodel, hw, seed=0, jmodel_f32=None):
    """Head outputs: boxes and kps within 2 ulps at their largest
    magnitude, scores by ``score_tol``. The JAX model runs eagerly, one
    op at a time, so each op rounds where Flax puts the cast (the jitted
    one keeps excess precision; see ``jax_reference``).

    With ``jmodel_f32`` (random-init nets: their outputs come out of long
    cancellations, and two bf16 runs that round alike in another order
    drift apart by several ulps) the port is held instead to stray from
    float32 (which the port's float32 meets to 1e-4) no further than 1.5
    times as far as JAX's bf16 strays, plus 2 ulps."""
    x = np.random.default_rng(seed).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jmodel.apply(jvars, jnp.asarray(x))
    exact = (jmodel_f32.apply(jvars, jnp.asarray(x)) if jmodel_f32
             else None)
    with torch.no_grad():
        got = tmodel.eval()(_nchw(x))
    for key in ("scores", "bboxes", "kps"):
        for li, (g, w) in enumerate(zip(got[key], want[key])):
            w = np.asarray(w)
            g = g.numpy()
            assert g.dtype == np.float32 and w.dtype == np.float32
            ulps = 2 * bf16_ulp(np.abs(w).max())
            if exact is not None:
                f = np.asarray(exact[key][li])
                jax_gap = float(np.abs(w - f).max())
                port_gap = float(np.abs(g - f).max())
                assert port_gap <= 1.5 * jax_gap + ulps, (key, li, port_gap,
                                                          jax_gap)
                continue
            if key == "scores":
                ws = np.clip(w.astype(np.float64), 1e-12, 1 - 1e-12)
                logits = np.abs(np.log(ws / (1 - ws)))
                tol = score_tol(w, logits.max())
            else:
                tol = ulps
            err = np.abs(g - w)
            assert (err <= tol).all(), (key, li, float(err.max()))


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _check_embedding(jmodel, jvars, tmodel, n=8, seed=1, jmodel_f32=None):
    """Embedding cosine >= 0.9999 against eager JAX; with ``jmodel_f32``
    (a deep random-init net) the port's angle to float32 at most 1.5
    times JAX's bf16 one."""
    x = np.random.default_rng(seed).normal(size=(n, 112, 112, 3)
                                           ).astype(np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))     # eagerly
    with torch.no_grad():
        got = tmodel.eval()(_nchw(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    cos = _cos(got, want)
    if jmodel_f32 is None:
        assert cos.min() >= 0.9999, cos
        return
    f = np.asarray(jmodel_f32.apply(jvars, jnp.asarray(x)))
    angle = lambda a, b: np.arccos(np.clip(_cos(a, b), -1.0, 1.0))
    jax_gap, port_gap = angle(want, f), angle(got, f)
    assert (port_gap <= 1.5 * jax_gap + 1e-3).all(), (port_gap, jax_gap)


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def test_tiny_scrfd_bf16_head_outputs():
    jm = jscrfd.SCRFDNet(jscrfd.SCRFDConfig(**_TINY_DET), dtype=jnp.bfloat16)
    jv = _np_tree(cpu_init(jscrfd.SCRFDNet(jscrfd.SCRFDConfig(**_TINY_DET)),
                           0, (1, 64, 96, 3)))
    tm = load_flax_variables(tscrfd.SCRFDNet(
        tscrfd.SCRFDConfig(**_TINY_DET), dtype=torch.bfloat16), jv)
    _check_head(jm, jv, tm, (64, 96),
                jmodel_f32=jscrfd.SCRFDNet(jscrfd.SCRFDConfig(**_TINY_DET)))


@pytest.mark.parametrize("cfg,cls", [(_TINY_R, "IResNet"),
                                     (_TINY_MBF, "MobileFaceNet")])
def test_tiny_embedders_bf16(cfg, cls):
    jm = getattr(jarc, cls)(jarc.ArcFaceConfig(**cfg), dtype=jnp.bfloat16)
    jv = _np_tree(cpu_init(getattr(jarc, cls)(jarc.ArcFaceConfig(**cfg)), 1,
                           (1, 112, 112, 3)))
    rng = np.random.default_rng(0)
    jv["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        jv["batch_stats"])
    tm = load_flax_variables(getattr(tarc, cls)(
        tarc.ArcFaceConfig(**cfg), dtype=torch.bfloat16), jv)
    _check_embedding(jm, jv, tm)


def test_det_500m_checkpoint_bf16_head_outputs():
    jv = msgpack("det_500m.msgpack")
    tm = load_flax_variables(tscrfd.build_scrfd("det_500m",
                                                dtype=torch.bfloat16), jv)
    _check_head(jscrfd.build_scrfd("det_500m", dtype=jnp.bfloat16), jv, tm,
                (96, 128), seed=5)


def test_w600k_mbf_checkpoint_bf16_embeddings():
    jv = msgpack("w600k_mbf.msgpack")
    tm = load_flax_variables(tarc.build_arcface("w600k_mbf",
                                                dtype=torch.bfloat16), jv)
    _check_embedding(jarc.build_arcface("w600k_mbf", dtype=jnp.bfloat16), jv,
                     tm, seed=6)


@pytest.mark.parametrize("net", ["det_500m", "w600k_mbf"])
def test_checkpoint_bf16_outputs_leave_float32(net):
    """The comparisons above would also pass a forward that never rounds
    to bf16, so the port's bf16 outputs must stray from its own float32
    ones: head outputs by at least half a bf16 ulp at their largest
    magnitude (the checkpoint reads 0.9-1.8 ulps; float32 against itself
    0), embeddings by 1 - cosine >= 1e-6 (bf16 reads about 1e-5)."""
    jv = msgpack(net + ".msgpack")
    if net == "det_500m":
        build, shape = tscrfd.build_scrfd, (2, 96, 128, 3)
    else:
        build, shape = tarc.build_arcface, (8, 112, 112, 3)
    x = _nchw(np.random.default_rng(5).normal(size=shape).astype(np.float32))
    with torch.no_grad():
        lo = load_flax_variables(build(net, dtype=torch.bfloat16), jv).eval()(x)
        hi = load_flax_variables(build(net), jv).eval()(x)
    if net == "w600k_mbf":
        assert (1 - _cos(lo.numpy(), hi.numpy())).min() >= 1e-6
        return
    for key in ("scores", "bboxes", "kps"):
        gap = max(float((a - b).abs().max()) for a, b in zip(lo[key], hi[key]))
        mag = max(float(b.abs().max()) for b in hi[key])
        assert gap >= 0.5 * bf16_ulp(mag), (key, gap, bf16_ulp(mag))


def test_weights_stay_f32_and_are_rounded_once():
    """The parameters and the state dict stay float32; the bf16 copies are
    made when the dtype is set and again when weights are loaded, and the
    forward uses them."""
    m = tscrfd.build_scrfd("det_500m", dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert all(t.dtype == torch.float32 for t in m.state_dict().values()
               if t.is_floating_point())
    conv = m.backbone.stem1.conv
    assert conv.weight_c.dtype == torch.bfloat16
    load_flax_variables(m, msgpack("det_500m.msgpack"))
    assert torch.equal(conv.weight_c, conv.weight.to(torch.bfloat16))
    assert m.head.scale1_c.dtype == torch.bfloat16
    f32 = tscrfd.build_scrfd("det_500m")
    assert f32.backbone.stem1.conv.weight_c is None
    assert set(f32.state_dict()) == set(m.state_dict())


# -------------------------------------------------------------- letterbox


@pytest.mark.parametrize("frame_hw", [(180, 320), (300, 200), (97, 131),
                                      (256, 256)])
def test_bf16_letterbox_within_one_step_of_jax(frame_hw):
    rng = np.random.default_rng(frame_hw[0])
    img = rng.integers(0, 256, size=(2, *frame_hw, 3), dtype=np.uint8)
    for tight in (False, True):
        plan = (tops.tight_letterbox_plan if tight else tops.letterbox_plan)(
            frame_hw, (256, 256))
        jplan = (jops.tight_letterbox_plan if tight else jops.letterbox_plan)(
            frame_hw, (256, 256))
        want = np.asarray(jops.letterbox(jnp.asarray(img), jplan,
                                         dtype=jnp.bfloat16))
        got = tops.letterbox(torch.from_numpy(img), plan,
                             dtype=torch.bfloat16)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= 1.0
        # both stray from the float32 canvas alike (up to 1.83 steps when
        # upscaling: the intermediate rounds at 1 step above 128)
        f32 = tops.letterbox(torch.from_numpy(img), plan).numpy()
        jf32 = np.asarray(jops.letterbox(jnp.asarray(img), jplan))
        assert (np.abs(got.numpy() - f32).max()
                <= np.abs(want - jf32).max() + 1e-6)


# -------------------------------------------------- detections and matches


def iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def near(value, edge):
    return abs(float(value) - float(edge)) <= 2 * bf16_ulp(edge)


def match_detections(want, got, *, conf, cut, iou_thres, det_scale, where):
    """One frame: ``want`` / ``got`` lists of (box (4,), score, kps (5, 2)).
    Pairs faces by IoU >= 0.9 (best first), holds each pair to the bf16
    box / kps / score tolerances, and returns the faces found on one side
    only, each checked to be a tie (``near`` conf or the slate's cut, or
    an IoU within 0.05 of the NMS threshold with a face of the other
    side). Returns (pairs [(i, j)], one-sided count)."""
    pairs, used = [], set()
    for i, (wb, ws, wk) in enumerate(want):
        best, bj = 0.9, None
        for j, (gb, gs, gk) in enumerate(got):
            if j not in used and iou(wb, gb) >= best:
                best, bj = iou(wb, gb), j
        if bj is not None:
            used.add(bj)
            pairs.append((i, bj))
    for i, j in pairs:
        (wb, ws, wk), (gb, gs, gk) = want[i], got[j]
        extent = max(wb[2] - wb[0], wb[3] - wb[1]) * det_scale
        tol = 2 * bf16_ulp(extent) / det_scale
        assert np.abs(gb - wb).max() <= tol, (where, gb, wb, tol)
        assert np.abs(gk - wk).max() <= tol, (where, gk, wk, tol)
        assert abs(gs - ws) <= 2 * bf16_ulp(1.0), (where, gs, ws)
    paired_w = {i for i, _ in pairs}
    paired_g = {j for _, j in pairs}
    lone = ([(f, got) for i, f in enumerate(want) if i not in paired_w]
            + [(f, want) for j, f in enumerate(got) if j not in paired_g])
    for (box, score, _), other in lone:
        nms_tie = any(abs(iou(box, ob) - iou_thres) <= 0.05
                      for ob, _, _ in other)
        assert near(score, conf) or near(score, cut) or nms_tie, (
            where, "a face found on one side only is no tie", box, score,
            conf, cut)
    return pairs, len(lone)


def faces_of(boxes, scores, kps, valid):
    return [(boxes[k], float(scores[k]), kps[k])
            for k in range(len(valid)) if valid[k]]


def jax_slate_cut(jdet, frames, plan, pre_nms, letterbox_dtype):
    """The score of the pre_nms-th anchor of each frame on the JAX side:
    the slate's cut (numpy)."""
    def cut(x):
        canvas = jops.letterbox(x, plan, dtype=letterbox_dtype)
        net_in = jops.normalize_image(canvas, jops.SCRFD_MEAN, jops.SCRFD_STD)
        out = jdet.model.apply(jdet.variables, net_in)
        scores = jnp.concatenate([s[..., 0] for s in out["scores"]], axis=1)
        return jax.lax.top_k(scores, pre_nms)[0][:, -1]

    return np.asarray(jax.jit(cut)(jnp.asarray(frames)))


# ------------------------------------ the JAX reference, in its own process
#
# XLA's jit keeps bf16 intermediates of a fusion in float32 where it likes
# (its default xla_allow_excess_precision): jitted JAX bf16 on the CPU sits
# several ulps from the Flax placement of the casts (det_500m's top score
# 0.8086 jitted, 0.7891 eagerly and with the flag off; the port 0.7891).
# The flag is read when XLA starts, and this test process's XLA has
# started, so the jitted JAX paths run in a fresh process with it off.


def run_job(module: str, job: str, inp: str, out: str) -> None:
    """In the reference process: ``<module>._job_<job>(**arrays of inp)``
    -> arrays saved to ``out``."""
    import importlib

    fn = getattr(importlib.import_module(module), "_job_" + job)
    with np.load(inp, allow_pickle=False) as args:
        res = fn(**{k: args[k] for k in args.files})
    np.savez(out, **res)


def jax_reference(module: str, job: str, **arrays) -> dict:
    """``<module>._job_<job>(**arrays)`` in a fresh process whose XLA rounds
    every bf16 op (``--xla_allow_excess_precision=false``)."""
    import subprocess
    import sys
    import tempfile

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]))
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(inp, **arrays)
        r = subprocess.run(
            [sys.executable, "-c", "import sys, test_torch_bf16 as t; "
             "t.run_job(*sys.argv[1:])", module, job, inp, out],
            env=env, cwd=d, capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-4000:]
        with np.load(out, allow_pickle=False) as res:
            return {k: res[k] for k in res.files}


def jax_pipeline(**kw):
    det_v, emb_v = msgpack("det_500m.msgpack"), msgpack("w600k_mbf.msgpack")
    return JPipeline(detector=JDetector("det_500m", variables=det_v,
                                        dtype=jnp.bfloat16, **DET_KW),
                     embedder=JEmbedder("w600k_mbf", variables=emb_v,
                                        dtype=jnp.bfloat16),
                     use_pallas_warp="off", tight_canvas=True,
                     similarity_thresh=SIM, gallery_capacity=16, **kw)


def port_pipeline(**kw):
    det_v, emb_v = msgpack("det_500m.msgpack"), msgpack("w600k_mbf.msgpack")
    return TPipeline(detector=TDetector("det_500m", variables=det_v,
                                        dtype=torch.bfloat16, device="cpu",
                                        **DET_KW),
                     embedder=TEmbedder("w600k_mbf", variables=emb_v,
                                        dtype=torch.bfloat16, device="cpu"),
                     tight_canvas=True, similarity_thresh=SIM,
                     gallery_capacity=16, device="cpu", **kw)


OUT_FIELDS = ("boxes", "scores", "kps", "valid", "count", "embeddings",
              "match_idx", "match_sim")


def output_arrays(out, prefix="") -> dict:
    """A JAX PipelineOutput as named numpy arrays, plus each frame's slate
    cut is added by the caller."""
    return {prefix + f: np.asarray(getattr(out, f)) for f in OUT_FIELDS}


def pipeline_cuts(jp, frames):
    plan = jops.tight_letterbox_plan(frames.shape[1:3],
                                     jp.detector.input_size)
    return jax_slate_cut(jp.detector, frames, plan, jp.pre_nms, jnp.bfloat16)


def _job_detect(**images):
    det_v = msgpack("det_500m.msgpack")
    jd = JDetector("det_500m", variables=det_v, dtype=jnp.bfloat16, **DET_KW)
    res = {}
    for name, img in images.items():
        det, kps = jd.detect(img)
        plan = jops.letterbox_plan(img.shape[:2], jd.input_size)
        res[name + "_det"], res[name + "_kps"] = det, kps
        res[name + "_cut"] = jax_slate_cut(jd, img[None], plan, jd.pre_nms,
                                           None)
    return res


def _job_pipeline(frames, gallery):
    jp = jax_pipeline()
    jp.set_gallery(gallery, [f"g{i}" for i in range(len(gallery))])
    return dict(output_arrays(jp(frames)), cut=pipeline_cuts(jp, frames))


def _job_facade(**images):
    det_v, emb_v = msgpack("det_500m.msgpack"), msgpack("w600k_mbf.msgpack")
    ja = JFaceAnalysis(dtype=jnp.bfloat16, det_variant="det_500m",
                       rec_variant="w600k_mbf", det_variables=det_v,
                       rec_variables=emb_v, max_det=4)
    ja.prepare(det_size=(256, 256), det_thresh=0.1)
    names = sorted(images, key=lambda n: int(n[3:]))
    res = {}
    for name, faces in zip(names, ja.get_batch([images[n] for n in names])):
        res[name + "_bbox"] = np.reshape([f.bbox for f in faces], (-1, 4))
        res[name + "_kps"] = np.reshape([f.kps for f in faces], (-1, 5, 2))
        res[name + "_score"] = np.asarray([f.det_score for f in faces],
                                          np.float32)
        res[name + "_emb"] = np.reshape(
            [np.asarray(f.normed_embedding, np.float32) for f in faces],
            (-1, 512))
    return res


# ------------------------------------------------------------------ tests


def test_detector_detect_bf16_matches_jax():
    td = TDetector("det_500m", variables=msgpack("det_500m.msgpack"),
                   dtype=torch.bfloat16, device="cpu", **DET_KW)
    rng = np.random.default_rng(11)
    images = {f"img{i}": face_frames(rng, 1, *hw)[0]
              for i, hw in enumerate(((180, 320), (240, 200), (256, 256)))}
    ref = jax_reference("test_torch_bf16", "detect", **images)
    lone = 0
    for name, img in images.items():
        wd, wk = ref[name + "_det"], ref[name + "_kps"]
        gd, gk = td.detect(img)
        plan = tops.letterbox_plan(img.shape[:2], td.input_size)
        want = [(wd[i, :4], wd[i, 4], wk[i]) for i in range(len(wd))]
        got = [(gd[i, :4], gd[i, 4], gk[i]) for i in range(len(gd))]
        assert want, f"no face in {name}: the comparison would be empty"
        _, n = match_detections(want, got, conf=td.conf_thres,
                                cut=float(ref[name + "_cut"][0]),
                                iou_thres=td.iou_thres,
                                det_scale=plan.det_scale, where=name)
        lone += n
    print("Detector.detect bf16, faces on one side only (ties):", lone)
    assert lone <= MAX_TIES


def assert_outputs_close(ref, to, *, frames, det_scale, where, prefix=""):
    """One batch's outputs, the JAX reference's arrays (``ref``, with the
    frames' slate cuts under ``<prefix>cut``) against the port's
    PipelineOutput, at the bf16 tolerances; returns the count of faces
    found on one side only."""
    jb, js, jk, jv, _, je, ji, jm = (ref[prefix + f] for f in OUT_FIELDS)
    tb, ts, tk, tv, _, te, ti, tm = (t.numpy() for t in to)
    assert te.dtype == je.dtype and ts.dtype == js.dtype
    lone = 0
    for b in range(len(jv)):
        want = faces_of(jb[b], js[b], jk[b], jv[b])
        got = faces_of(tb[b], ts[b], tk[b], tv[b])
        pairs, n = match_detections(
            want, got, conf=DET_KW["conf_thres"],
            cut=float(ref[prefix + "cut"][b]), iou_thres=0.4,
            det_scale=det_scale, where=(where, b))
        lone += n
        wk = np.flatnonzero(jv[b])
        gk = np.flatnonzero(tv[b])
        for i, j in pairs:
            a, c = je[b, wk[i]], te[b, gk[j]]
            cos = float(a @ c / (np.linalg.norm(a) * np.linalg.norm(c)))
            assert cos >= 0.999, (where, b, cos)
            ws, gs = jm[b, wk[i]], tm[b, gk[j]]
            if not (near(ws, SIM) or near(gs, SIM)):
                assert ji[b, wk[i]] == ti[b, gk[j]], (where, b, ws, gs)
    return lone


def test_pipeline_call_bf16_matches_jax():
    tp = port_pipeline()
    rng = np.random.default_rng(3)
    frames = face_frames(rng, 3, 180, 320)
    first = tp(frames)
    gal = first.embeddings.numpy()[first.valid.numpy()][:6]
    assert len(gal), "no face to build a gallery from"
    tp.set_gallery(gal, [f"g{i}" for i in range(len(gal))])
    ref = jax_reference("test_torch_bf16", "pipeline", frames=frames,
                        gallery=gal)
    to = tp(frames)
    assert to.embeddings.dtype == torch.float32
    assert int((to.match_idx >= 0).sum()) > 0
    scale = tops.tight_letterbox_plan((180, 320), (256, 256)).det_scale
    lone = assert_outputs_close(ref, to, frames=frames, det_scale=scale,
                                where="call")
    print("FacePipeline bf16, faces on one side only (ties):", lone)
    assert lone <= MAX_TIES


def test_face_analysis_dtype_default_and_bf16_matches_jax():
    det_v, emb_v = msgpack("det_500m.msgpack"), msgpack("w600k_mbf.msgpack")
    kw = dict(det_variant="det_500m", rec_variant="w600k_mbf",
              det_variables=det_v, rec_variables=emb_v, max_det=4)
    assert TFaceAnalysis(device="cpu", **kw).detector.dtype == torch.float32
    ta = TFaceAnalysis(dtype=torch.bfloat16, device="cpu", **kw)
    ta.prepare(det_size=(256, 256), det_thresh=0.1)
    rng = np.random.default_rng(4)
    images = list(face_frames(rng, 8, 120, 160))      # the static route
    images += [face_frames(rng, 1, h, w)[0]           # the dynamic route
               for h, w in ((100, 140), (300, 200))]
    ref = jax_reference("test_torch_bf16", "facade",
                        **{f"img{i}": im for i, im in enumerate(images)})
    got = ta.get_batch(images)
    lone = 0
    for i, fg in enumerate(got):
        p = f"img{i}_"
        want = list(zip(ref[p + "bbox"], ref[p + "score"], ref[p + "kps"]))
        scale = tops.letterbox_plan(images[i].shape[:2], (256, 256)).det_scale
        pairs, n = match_detections(
            want, [(f.bbox, f.det_score, f.kps) for f in fg], conf=0.1,
            cut=-1.0, iou_thres=0.4, det_scale=scale, where=i)
        lone += n
        for a, b in pairs:
            e2 = np.asarray(fg[b].normed_embedding, np.float32)
            assert float(ref[p + "emb"][a] @ e2) >= 0.999
    assert sum(len(f) for f in got) > 0
    print("FaceAnalysis bf16, faces on one side only (ties):", lone)
    assert lone <= MAX_TIES


@pytest.mark.slow
def test_full_width_det_10g_and_w600k_r50_bf16():
    """det_10g + w600k_r50 at full width, seeded Flax init carried across,
    both at bf16 (random-init nets: the tolerances of the tiny ones)."""
    jv = _np_tree(cpu_init(jscrfd.build_scrfd("det_10g"), 0,
                           (1, 128, 160, 3)))
    tm = load_flax_variables(tscrfd.build_scrfd("det_10g",
                                                dtype=torch.bfloat16), jv)
    _check_head(jscrfd.build_scrfd("det_10g", dtype=jnp.bfloat16), jv, tm,
                (128, 160), jmodel_f32=jscrfd.build_scrfd("det_10g"))
    jv = _np_tree(cpu_init(jarc.build_arcface("w600k_r50"), 0,
                           (1, 112, 112, 3)))
    tm = load_flax_variables(tarc.build_arcface("w600k_r50",
                                                dtype=torch.bfloat16), jv)
    _check_embedding(jarc.build_arcface("w600k_r50", dtype=jnp.bfloat16), jv,
                     tm, n=4, jmodel_f32=jarc.build_arcface("w600k_r50"))
