"""The port's measurement tools against the JAX repository's profiling
scripts (``tools/profile_stages.py``, ``exp_r50.py``, ``exp_r50b.py``,
``exp_scrfd.py``, ``trace_ops.py``, ``exp_int8.py``), on the CPU, on the
same seeds, at narrow configs.

The JAX tools are loaded from ``tools/`` by path. Where a JAX tool builds
its models and functions inside ``main``, ``main`` runs with its timing
replaced by a recorder, so the test holds the very callables and configs
it would have timed; tier-1 swaps both packages' "det_10g" / "w600k_r50"
config entries for narrow ones and carries JAX's weights into the port
with ``models.weights.load_flax_variables``. Tolerances:

- ``profile_stages``: the tool's sub-stage chain yields the port's
  ``FacePipeline`` output bit for bit; each sub-stage against the JAX
  function the JAX tool calls, at f32, within the f32 budget of the root
  ``PERF.md`` §2 (canvas and raw head outputs 1e-4, boxes and kps 1e-2
  px, scores 1e-4, valid and count equal, the canvas' u8 equal; the
  warp's matrices within 1e-4, and the warp on the same matrices within
  1e-3 u8 of the JAX package's exact warp, which its own tests hold the
  Pallas kernel to; embeddings (the port's crops against JAX's) cosine
  >= 0.9999, match sims 1e-4 and rows equal);
- ``exp_r50``: each prefix (stem through layer4) against JAX's ``Prefix``
  (computing in f32) within 1e-4 of its largest magnitude, NCHW
  transposed to NHWC; ``channels_last`` against NCHW alike; the FLOP count
  equal to 2 x the MACs of the convs and the FC;
- ``exp_r50b``: heads A-D against JAX's ``head_a``..``head_d`` on the same
  (x, w, b) within 1e-4 of the largest magnitude, in f32 (the JAX tool's
  own check is 2e-2 absolute);
- ``exp_scrfd``: ``Backbone`` -> ``PAFPN`` -> ``SCRFDHead`` against JAX's
  submodules within 1e-4 of each output's largest magnitude; the padded
  configs equal JAX's field for field, ``s2d_stem`` aside;
- ``trace_ops``: ``summarize_trace`` gives JAX's total, order and shares
  on one synthetic event set, written as a torch Chrome trace and in the
  JAX layout;
- ``exp_int8``: the im2col ``_int_mm`` conv equals ``lax.conv_general_
  dilated`` int8 -> int32 exactly (K and N that need padding included);
  the requantized int8 tensors equal JAX's formula bit for bit; the
  chain's shapes equal the JAX tool's.

The full-width cases are marked slow.
"""
import dataclasses
import gzip
import importlib.util
import inspect
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.models import arcface as jarc
from scrfd_arcface_facerecognition_tpu.models import init_utils as jinit
from scrfd_arcface_facerecognition_tpu.models import scrfd as jscrfd
from scrfd_arcface_facerecognition_tpu.ops import warp as jwarp
from scrfd_arcface_facerecognition_tpu.pipeline import detector as jdet
from scrfd_arcface_facerecognition_tpu_torch import ops as tops
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as tarc
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as tscrfd
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    load_flax_variables)
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    exp_int8, exp_r50, exp_r50b, exp_scrfd, profile_stages, trace_ops)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_R50 = dict(name="w600k_r50", arch="iresnet", stage_blocks=(1, 1, 2, 1),
                stage_filters=(8, 8, 16, 16))
TINY_10G = dict(name="det_10g", stem_filters=8, stage_blocks=(1, 1, 1, 1),
                stage_filters=(8, 8, 16, 16), neck_filters=8, head_stacks=1,
                head_filters=16)
RTOL = 1e-4
PROFILE_HW = (540, 960)     # the JAX tool's frames are 1080p


def _jax_tool(name):
    """The JAX repository's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' "w600k_r50" and "det_10g" entries narrow."""
    monkeypatch.setitem(jarc.ARCFACE_CONFIGS, "w600k_r50",
                        jarc.ArcFaceConfig(**TINY_R50))
    monkeypatch.setitem(tarc.ARCFACE_CONFIGS, "w600k_r50",
                        tarc.ArcFaceConfig(**TINY_R50))
    monkeypatch.setitem(jscrfd.SCRFD_CONFIGS, "det_10g",
                        jscrfd.SCRFDConfig(**TINY_10G))
    monkeypatch.setitem(tscrfd.SCRFD_CONFIGS, "det_10g",
                        tscrfd.SCRFDConfig(**TINY_10G))


def _close(got, want, rtol=RTOL):
    """Within ``rtol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, (
        float(np.abs(got - want).max()) / scale)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ profile_stages


def _jax_models(det_name, rec_name):
    """JAX's det and rec models at f32 with their seeded Flax variables."""
    det = jscrfd.SCRFDNet(jscrfd.SCRFD_CONFIGS[det_name], dtype=jnp.float32)
    dv = jinit.cpu_init(det, 0, (1, 128, 128, 3))
    from scrfd_arcface_facerecognition_tpu.models import build_arcface

    rec = build_arcface(rec_name, dtype=jnp.float32)
    rv = jinit.cpu_init(rec, 0, (1, 112, 112, 3))
    return (det, jax.tree.map(np.asarray, dv)), (rec, jax.tree.map(
        np.asarray, rv))


def _port_pipe(dv, rv):
    pipe = profile_stages.make_pipeline("cpu", torch.float32)
    load_flax_variables(pipe.detector.model, dv)
    load_flax_variables(pipe.embedder.model, rv)
    return pipe


@pytest.fixture(scope="module")
def profile_case():
    """Narrow models (JAX's seeded variables in both packages), two frames
    of the JAX tool's draws at ``PROFILE_HW``, the port's pipeline and
    sub-stages."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jarc.ARCFACE_CONFIGS, "w600k_r50",
               jarc.ArcFaceConfig(**TINY_R50))
    mp.setitem(tarc.ARCFACE_CONFIGS, "w600k_r50",
               tarc.ArcFaceConfig(**TINY_R50))
    mp.setitem(jscrfd.SCRFD_CONFIGS, "det_10g",
               jscrfd.SCRFDConfig(**TINY_10G))
    mp.setitem(tscrfd.SCRFD_CONFIGS, "det_10g",
               tscrfd.SCRFDConfig(**TINY_10G))
    (jd, dv), (jr, rv) = _jax_models("det_10g", "w600k_r50")
    s = dict(profile_stages.SETTINGS, frame_hw=PROFILE_HW)
    mp.setattr(profile_stages, "SETTINGS", s)
    pipe = _port_pipe(dv, rv)
    gallery, frames = profile_stages.draws(2)
    plan = tops.tight_letterbox_plan(s["frame_hw"], s["input_size"])
    sub = profile_stages.SubStages(pipe, plan, s["max_num"])
    yield dict(jd=jd, dv=dv, jr=jr, rv=rv, pipe=pipe, gallery=gallery,
               frames=frames, plan=plan, sub=sub, settings=s,
               jplan=jops.tight_letterbox_plan(s["frame_hw"],
                                               s["input_size"]))
    mp.undo()


def test_profile_stages_chain_is_the_pipelines_output(profile_case):
    """The sub-stages composed give ``FacePipeline``'s output bit for bit,
    at the tool's max_num 10, with faces found."""
    c = profile_case
    frames = torch.from_numpy(c["frames"])
    with torch.inference_mode():
        got = profile_stages.chain(c["sub"], frames)
        want = c["pipe"](c["frames"], max_num=10)
    assert int(want.count.sum()) > 0
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_profile_stages_substages_match_the_jax_tools_functions(
        profile_case):
    """Each sub-stage against the JAX function the JAX tool times, on the
    same frames, at f32 (the warp against the JAX package's exact warp)."""
    c = profile_case
    sub, plan, jplan, s = c["sub"], c["plan"], c["jplan"], c["settings"]
    frames = torch.from_numpy(c["frames"])
    jframes = jnp.asarray(c["frames"])
    with torch.inference_mode():
        canvas = sub.letterbox(frames)
        net_in = sub.normalize(canvas)
        outputs = sub.scrfd(net_in)
        decoded = sub.decode(outputs)
        det = sub.topk_nms(*decoded)
        canvas_u8 = sub.canvas_u8(canvas)
    def jax_stage1(v, f):          # the JAX tool's detect sub-stages
        canvas = jops.letterbox(f, jplan, dtype=jnp.float32)
        net_in = jops.normalize_image(canvas, jops.SCRFD_MEAN,
                                      jops.SCRFD_STD)
        out = c["jd"].apply(v, net_in)
        det = jdet.detect_batch(
            c["jd"].apply, v, f, plan=jplan, conf_thres=s["conf"],
            iou_thres=s["iou"], pre_nms=s["pre_nms"], max_det=s["max_det"],
            max_num=s["max_num"], metric="max", compute_dtype=None)
        u8 = jnp.clip(jnp.round(canvas), 0, 255).astype(jnp.uint8)
        return (canvas, net_in, out, jdet.decode_outputs(out, jplan.model_hw),
                det, u8)

    jcanvas, jnet_in, jout, jdec, jd, ju8 = jax.jit(jax_stage1)(c["dv"],
                                                                jframes)
    _close(canvas, jcanvas)
    _close(net_in, jnet_in)
    for k in ("scores", "bboxes", "kps"):
        for a, b in zip(outputs[k], jout[k]):
            _close(a, b)
    np.testing.assert_allclose(decoded[0].numpy(), np.asarray(jdec[0]),
                               atol=1e-4)
    for a, b in zip(decoded[1:], jdec[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-2)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(det.count.numpy(), np.asarray(jd.count))
    assert int(det.count.sum()) > 0
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jd.boxes),
                               atol=1e-2)
    np.testing.assert_allclose(det.kps.numpy(), np.asarray(jd.kps),
                               atol=1e-2)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jd.scores),
                               atol=1e-4)
    np.testing.assert_array_equal(canvas_u8.numpy(), np.asarray(ju8))
    # stage 2 on the port's slots, the same kps to both warps
    b, k = det.valid.shape
    bucket = c["pipe"]._round_bucket(int(det.count.sum()), b * k)
    _, frame_idx, kps_sel, valid_sel = profile_stages.slots(det, bucket)
    with torch.inference_mode():
        crops = sub.warp(frames, kps_sel, frame_idx)
        emb = sub.r50(crops)
        emb_l2, idx, sim = sub.match(emb, valid_sel)
    # the warp's matrices (umeyama in each package's f32), then the warp
    # on the same matrices (K1's plain version on the CPU)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)

    def jax_stage2(v, exact, gallery):       # the embed sub-stages
        emb = c["jr"].apply(v, jops.normalize_image(
            exact, jops.ARCFACE_MEAN, jops.ARCFACE_STD))
        sims = jnp.dot(jops.l2_normalize(emb),
                       jops.l2_normalize(gallery).T,
                       precision=jax.lax.Precision.HIGHEST)
        return emb, sims

    # the warp eager, op by op: under jit XLA contracts the matrix
    # inversion into FMAs, another rounding than the port's inversion
    jms = jops.estimate_norm(jnp.asarray(kps_sel.numpy()), 112)
    jminv, ms = np.asarray(jwarp.invert_affine(jms)), np.array(jms)
    exact = jwarp.warp_affine_flat(jframes, jms, jnp.asarray(
        frame_idx.numpy()))
    jemb, jsims = (np.asarray(a) for a in jax.jit(jax_stage2)(
        c["rv"], exact, c["gallery"]))
    exact = np.asarray(exact)
    _close(crop_matrices(kps_sel), jminv)
    on_jax_ms = tops.warp_align_crops(
        frames, tops.invert_affine(torch.from_numpy(ms)), frame_idx)
    port_u8 = (on_jax_ms.numpy() * 127.5 + 127.5).transpose(
        0, 2, 3, 1)[..., ::-1]
    np.testing.assert_allclose(port_u8, exact, atol=1e-3)
    e = emb.numpy()
    cos = (e * jemb).sum(-1) / (np.linalg.norm(e, axis=-1)
                                * np.linalg.norm(jemb, axis=-1))
    assert cos.min() >= 0.9999, cos
    v = valid_sel.numpy()
    np.testing.assert_allclose(sim.numpy()[v], np.maximum(
        jsims.max(-1), 0)[v], atol=1e-4)
    hit = v & (jsims.max(-1) > s["sim"] + 1e-4)
    np.testing.assert_array_equal(idx.numpy()[hit], jsims.argmax(-1)[hit])


def test_profile_stages_run_prints_the_jax_tools_rows(profile_case):
    """``run`` on the CPU: every row of the JAX tool in its order (the
    Pallas warp's row named for K1, the normalize fused), faces found, K1
    called through its wrapper (the plain version on the CPU)."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    c = profile_case
    lines, calls = [], []
    crops = tops.warp_align_crops

    def counted(*a, **k):
        calls.append(a[0].device.type)
        return crops(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(tops, "warp_align_crops", counted)
    try:
        out = profile_stages.run(2, iters=1, pipe=c["pipe"],
                                 emit=lines.append)
    finally:
        mp.undo()
    assert calls and set(calls) == {"cpu"} and wa.launches >= 0
    labels = [line[:42].strip() for line in lines
              if not line.startswith(("  faces=", "  =>"))]
    assert labels == ["detect (full stage 1)", "embed+match (full stage 2)",
                      "letterbox", "normalize", "scrfd forward", "decode",
                      "topk+nms+compact", "canvas->u8", "warp (K1)",
                      "arcface normalize", "r50 forward", "l2+match"]
    assert out["rows"]["arcface normalize"] == profile_stages.FUSED
    assert out["faces"] > 0 and out["bucket"] >= out["faces"]
    assert any(line.startswith("  => e2e ") for line in lines)


# ------------------------------------------------------------------- exp_r50


def _recorded_main(monkeypatch, tool, timer="timed", **patches):
    """Run a JAX tool's ``main`` with its timer replaced: the calls it
    would have timed, as (function, args)."""
    calls = []

    def record(f, *args, **kw):
        calls.append((f, args))
        return 1.0

    monkeypatch.setattr(tool, timer, record)
    for name, value in patches.items():
        monkeypatch.setattr(tool, name, value)
    tool.main()
    return calls


def _analytic_r50_flops(cfg, n):
    """2 x the MACs of an iResNet's convs and FC at 112 x 112."""
    side, macs = 112, 9 * 3 * cfg.stage_filters[0] * 112 * 112
    ch = cfg.stage_filters[0]
    for nb, f in zip(cfg.stage_blocks, cfg.stage_filters):
        for bi in range(nb):
            stride = 2 if bi == 0 else 1
            out = side // stride
            macs += 9 * ch * f * side * side          # conv1, stride 1
            macs += 9 * f * f * out * out             # conv2
            if stride != 1 or ch != f:
                macs += ch * f * out * out            # 1x1 downsample
            side, ch = out, f
    macs += ch * side * side * cfg.emb_dim
    return 2 * n * macs


def test_exp_r50_prefixes_layout_and_flops_match_jax(narrow, monkeypatch):
    """JAX's ``Prefix`` modules (made to compute in f32) against the
    port's prefixes of one model carrying the same variables; the layout
    variant against NCHW; the FLOP count against the analytic one."""
    jt = _jax_tool("exp_r50")
    calls = _recorded_main(monkeypatch, jt, flops_of=lambda *a: 0.0)
    prefixes = [f.__wrapped__.__self__ for f, _ in calls
                if getattr(f.__wrapped__, "__self__", None) is not None
                and hasattr(f.__wrapped__.__self__, "upto")]
    assert [p.upto for p in prefixes] == [0, 1, 2, 3, 4]
    variables = calls[0][1][0]
    pv = {"params": variables["params"],
          "batch_stats": variables["batch_stats"]}
    model = exp_r50.make_model("cpu", torch.float32)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    x = torch.from_numpy(exp_r50.make_input(3))
    np.testing.assert_array_equal(_nhwc(x), np.asarray(
        calls[0][1][1])[:3])                          # the same crops
    with torch.inference_mode():
        for p in prefixes:
            f32 = type("Prefix32", (type(p),), {"dtype": jnp.float32})
            want = np.asarray(jax.jit(f32(upto=p.upto).apply)(
                pv, jnp.asarray(_nhwc(x))))
            _close(_nhwc(exp_r50.prefix(model, x, p.upto)), want)
        assert exp_r50.check(model, x) == 0.0
        cl = model.to(memory_format=torch.channels_last)
        got = cl(x.contiguous(memory_format=torch.channels_last))
        model = model.to(memory_format=torch.contiguous_format)
        _close(got, model(x))
    cfg = tarc.ARCFACE_CONFIGS["w600k_r50"]
    assert exp_r50.flops(lambda: model(x)) == _analytic_r50_flops(cfg, 3)


def test_exp_r50_run_rows(narrow):
    lines = []
    model = exp_r50.make_model("cpu")
    out = exp_r50.run(4, (2,), iters=1, model=model, emit=lines.append)
    assert [line[:3] for line in lines] == (
        ["[1]", "[5]"] + ["[2]"] * 6 + ["[3]", "[4]", "[4]"])
    assert len(out["prefix"]) == 5 and out["flops"] > 0
    assert "TF32 off" in lines[-1]


# ------------------------------------------------------------------ exp_r50b


def test_exp_r50b_heads_match_jax(narrow, monkeypatch):
    """Heads A-D against JAX's head_a..head_d on the same (x, w, b)."""
    jt = _jax_tool("exp_r50b")
    calls = _recorded_main(monkeypatch, jt)
    heads = {f.__wrapped__.__name__: f.__wrapped__ for f, _ in calls
             if f.__wrapped__.__name__.startswith("head_")}
    assert sorted(heads) == ["head_a", "head_b", "head_c", "head_d"]
    # the JAX tool's (w_flat, bias) and first check input, in its order
    rng = np.random.default_rng(0)
    w, b = exp_r50b.make_head_weights(rng)
    xs = rng.normal(size=(4, 7, 7, 512)).astype(np.float32)
    _, (_, jw, jb) = next(c for c in calls
                          if c[0].__wrapped__.__name__ == "head_a")
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(b, np.asarray(jb))
    xt = torch.from_numpy(np.ascontiguousarray(xs.transpose(0, 3, 1, 2)))
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    for k, port in exp_r50b.HEADS.items():
        want = np.asarray(heads[f"head_{k.lower()}"](
            jnp.asarray(xs), jnp.asarray(w), jnp.asarray(b)))
        with torch.inference_mode():
            _close(port(xt, wt, bt), want)
    assert max(exp_r50b.agreement(xt, wt, bt).values()) <= RTOL


def test_exp_r50b_full_variants_equal_the_model(narrow):
    """In the full model each head gives the forward's embedding; A, the
    production head, bit for bit."""
    model = exp_r50.make_model("cpu", torch.float32)
    x = torch.from_numpy(exp_r50.make_input(3))
    wp = exp_r50b.permuted_rows(model.fc.w("weight").t())
    with torch.inference_mode():
        want = model(x)
        for k in exp_r50b.HEADS:
            got = exp_r50b.full(model, k, wp)(x)
            if k == "A":
                assert torch.equal(got, want)
            _close(got, want)


# ------------------------------------------------------------------ exp_scrfd


def test_exp_scrfd_parts_match_jax_submodules(narrow):
    """The port's backbone, neck and head of one net against JAX's
    submodules on the same variables, at f32."""
    cfg = jscrfd.SCRFD_CONFIGS["det_10g"]
    jnet = jscrfd.SCRFDNet(cfg, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jinit.cpu_init(jnet, 0, (1, 128, 128, 3)))
    net = exp_scrfd.make_net(tscrfd.SCRFD_CONFIGS["det_10g"], "cpu",
                             torch.float32)
    load_flax_variables(net, v)
    x = torch.from_numpy(exp_scrfd.make_input(2, size=128))
    jx = jnp.asarray(_nhwc(x))

    def sub(name):
        return {"params": v["params"][name],
                "batch_stats": v["batch_stats"].get(name, {})}

    jfeats = jax.jit(jscrfd.Backbone(cfg, dtype=jnp.float32).apply)(
        sub("backbone"), jx)
    jnf = jax.jit(jscrfd.PAFPN(cfg.neck_filters, dtype=jnp.float32).apply)(
        sub("neck"), jfeats)
    jhead = jax.jit(jscrfd.SCRFDHead(cfg, dtype=jnp.float32).apply)(
        {"params": v["params"]["head"]}, jnf)
    with torch.inference_mode():
        feats = net.backbone(x)
        nf = net.neck(feats)
        head = net.head(nf)
        whole = net(x)
    for a, b in zip(feats, jfeats):
        _close(_nhwc(a), b)
    for a, b in zip(nf, jnf):
        _close(_nhwc(a), b)
    for k in ("scores", "bboxes", "kps"):
        for a, b in zip(head[k], jhead[k]):
            _close(a, b)
    assert exp_scrfd.compose_gap(whole, head) == dict(scores=0.0,
                                                      bboxes=0.0, kps=0.0)


class _Recorder:
    """Stands in for a JAX model class: keeps its config, inits to {}."""
    seen = []

    def __init__(self, cfg, *a, **k):
        _Recorder.seen.append(cfg)

    def init(self, *a, **k):
        return {}


def test_exp_scrfd_padded_configs_are_the_jax_tools(monkeypatch):
    jt = _jax_tool("exp_scrfd")
    _Recorder.seen = []
    for name in ("SCRFDNet", "Backbone", "PAFPN", "SCRFDHead"):
        monkeypatch.setattr(jscrfd, name, _Recorder)
    monkeypatch.setattr(jinit, "cpu_init", lambda *a, **k: {})
    monkeypatch.setattr(jt, "timeit", lambda name, fn, args, iters, sync: (
        [jnp.zeros(1)] * 3, 0.0))
    monkeypatch.setattr(sys, "argv", ["exp_scrfd.py", "--batch", "1"])
    jt.main()
    nets = [c for c in _Recorder.seen if isinstance(c, jscrfd.SCRFDConfig)
            and c.name != "det_10g"]
    assert [c.name for c in nets] == ["det_10g_pad", "det_10g_128"]
    port = [c for _, c in exp_scrfd.padded_configs()]
    for j, t in zip(nets, port):
        jd = dataclasses.asdict(j)
        assert jd.pop("s2d_stem") is True
        assert jd == dataclasses.asdict(t)


def test_exp_scrfd_run_rows(narrow):
    lines = []
    out = exp_scrfd.run(1, iters=1, size=64, device="cpu", emit=lines.append)
    assert lines[0] == exp_scrfd.STEM_NOTE
    assert list(out["rows"]) == [
        "det_10g full (bf16, s2d)", "backbone only", "neck only",
        "head only", "det_10g widths padded to mult-of-32",
        "det_10g widths 64/128/256", "det_10g full (f32, s2d)"]
    assert exp_scrfd.compose_gap(*out["outputs"]) == dict(
        scores=0.0, bboxes=0.0, kps=0.0)


# ------------------------------------------------------------------ trace_ops

_EVENTS = [("conv_a", 300.0), ("bn", 120.0), ("conv_a", 200.0),
           ("relu", 120.0), ("copy", 60.0), ("conv_b", 450.0),
           ("relu", 5.0)]


def _write_torch_trace(path):
    ev = [{"ph": "X", "cat": "kernel" if n != "copy" else "gpu_memcpy",
           "name": n, "pid": 0, "tid": 7, "ts": 10.0 * i, "dur": d}
          for i, (n, d) in enumerate(_EVENTS)]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 99,
            "tid": 1, "ts": 0.0, "dur": 9999.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 99, "tid": 1, "ts": 0.0, "dur": 7777.0}]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def _write_jax_trace(path):
    ev = [{"ph": "M", "name": "process_name", "pid": 3,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 9,
           "args": {"name": "/host:CPU"}}]
    ev += [{"ph": "X", "name": n, "pid": 3, "tid": 1, "ts": 10.0 * i,
            "dur": d} for i, (n, d) in enumerate(_EVENTS)]
    ev += [{"ph": "X", "name": "host_op", "pid": 9, "tid": 1, "ts": 0.0,
            "dur": 9999.0}]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_summarize_trace_matches_jax_on_one_event_set(tmp_path, capsys):
    jt = _jax_tool("trace_ops")
    jdir, tdir = tmp_path / "jax" / "plugins", tmp_path / "torch"
    jdir.mkdir(parents=True)
    tdir.mkdir()
    _write_jax_trace(jdir / "host.trace.json.gz")
    _write_torch_trace(tdir / "trace.json")
    capsys.readouterr()
    jt.summarize_trace(str(tmp_path / "jax"), top=4)
    jax_lines = capsys.readouterr().out.splitlines()
    lines = []
    res = trace_ops.summarize_trace(str(tdir), top=4, emit=lines.append)
    assert jax_lines[0].split(":", 1)[1] == lines[0].split(":", 1)[1]
    assert jax_lines[1:] == lines[1:]
    assert [n for n, _, _ in res["top"]] == ["conv_a", "conv_b", "relu",
                                            "bn"]
    assert res["total_ms"] == pytest.approx(sum(d for _, d in _EVENTS) / 1e3)


def test_summarize_trace_raises_without_device_events(tmp_path):
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "a",
                                    "dur": 5.0}]}, f)
    with pytest.raises(RuntimeError, match="holds no device event"):
        trace_ops.summarize_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="no trace file"):
        trace_ops.summarize_trace(str(tmp_path / "none"))
    lines = []
    res = trace_ops.summarize_trace(str(tmp_path), device=False,
                                    emit=lines.append)
    assert res["total_ms"] == 0.005 and "(--device cpu)" in lines[0]


def test_trace_ops_run_on_the_cpu_says_so(narrow, tmp_path):
    lines = []
    res = trace_ops.run("full", batch=1, iters=1, top=3,
                        trace_dir=str(tmp_path), device="cpu",
                        emit=lines.append)
    assert lines[0].startswith("wall: ") and "CPU-op (--device cpu)" in \
        lines[1]
    assert len(res["top"]) == 3 and res["total_ms"] > 0


# ------------------------------------------------------------------- exp_int8


@pytest.mark.parametrize("shape", [(2, 6, 7, 28, 28), (1, 5, 4, 16, 24),
                                   (2, 4, 4, 3, 8)])
def test_int8_conv_equals_jax_lax_conv_exactly(shape):
    """The im2col ``_int_mm`` conv against the JAX tool's int8 conv (its
    dimension numbers and padding), K = 9 * 28 = 252 and 27 padded, N = 28
    padded."""
    rng = np.random.default_rng(1)
    x, w = exp_int8.conv_inputs(rng, shape, True, "cpu")
    got = exp_int8.conv(x, exp_int8.gemm_weight(w), shape[-1])
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (1, 1),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert exp_int8.exact_conv_gap(x, w, got) == 0


def test_int8_requantization_equals_jax_bit_for_bit():
    """The chain's scale + BN + ReLU and requantization on one int32
    accumulator, the JAX tool's formula op by op (no fusion), values on
    the rounding ties included."""
    rng = np.random.default_rng(2)
    acc = rng.integers(-40000, 40000, (4, 8, 8, 24)).astype(np.int32)
    g = rng.normal(size=24).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    y = jnp.maximum(jnp.asarray(acc).astype(jnp.float32) * jnp.float32(0.01)
                    * jnp.asarray(g) + jnp.asarray(b), 0.0)
    want = jnp.clip(jnp.round(y * 12.7), -127, 127).astype(jnp.int8)
    yt = torch.clamp_min(torch.from_numpy(acc).float() * 0.01
                         * torch.from_numpy(g) + torch.from_numpy(b), 0.0)
    got = exp_int8.requantize(yt)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ties = np.array([0.5, 1.5, 2.5, -0.5, 126.5, 127.5, 200.0, -300.0],
                    np.float32) / np.float32(12.7)
    np.testing.assert_array_equal(
        exp_int8.requantize(torch.from_numpy(ties)).numpy(),
        np.asarray(jnp.clip(jnp.round(jnp.asarray(ties) * 12.7), -127,
                            127).astype(jnp.int8)))


def test_int8_chain_shapes_are_the_jax_tools():
    """The JAX tool's own shape code (``bench_chain``), run alone."""
    src = inspect.getsource(_jax_tool("exp_int8").bench_chain)
    start, end = src.index("    shapes = ["), src.index("    ws, scales")
    ns = {}
    exec(textwrap.dedent(src[start:end]), ns)
    assert exp_int8.chain_shapes() == ns["shapes"]
    assert len(ns["shapes"]) == 28        # the JAX label says 38


def test_int8_run_checks_and_rows(monkeypatch):
    shapes = exp_int8.chain_shapes()
    monkeypatch.setattr(exp_int8, "chain_shapes", lambda: [
        (h // 20, w // 20, ci, co, st) for h, w, ci, co, st in shapes])
    lines = []
    out = exp_int8.run(((2, 4, 4, 28, 28),), matmul=32, chain_batch=1,
                       device="cpu", check=True, emit=lines.append)
    assert set(out["exact"].values()) == {0}
    assert [line.split(" ")[0] for line in lines] == [
        "bf16", "int8", "cudnn", "bf16", "int8", "bf16", "int8", "chain"]
    assert "of 1,979 TOP/s int8" in lines[4]


# ----------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("mod,argv,want", [
    (profile_stages, ["--batch", "8", "--iters", "3", "--bucket", "16"],
     ((8, 3, 16), {})),
    (exp_scrfd, ["--batch", "4", "--iters", "2"], ((4, 2), {})),
    (trace_ops, ["--what", "embed", "--batch", "2", "--iters", "1", "--top",
                 "5", "--dir", "d"], (("embed", 2, 1, 5, "d"), {})),
    (exp_r50, [], ((), {})), (exp_r50b, [], ((), {})),
    (exp_int8, [], ((), {}))])
def test_main_takes_the_jax_tools_flags(monkeypatch, capsys, mod, argv,
                                        want):
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a, **k: seen.append((a, k)))
    assert mod.main(argv + ["--device", "cpu"]) == 0
    (args, kw), = seen
    dev = kw.pop("device", None) or args[-1]
    assert getattr(dev, "type", dev) == "cpu"
    assert tuple(a for a in args if getattr(a, "type", None) != "cpu") == \
        want[0]
    assert capsys.readouterr().out.startswith("card: no card: --device cpu")


# ------------------------------------------------------------ full width


@pytest.mark.slow
def test_exp_r50_prefixes_match_jax_at_full_width(monkeypatch):
    jt = _jax_tool("exp_r50")
    calls = _recorded_main(monkeypatch, jt, flops_of=lambda *a: 0.0)
    variables = calls[0][1][0]
    model = exp_r50.make_model("cpu", torch.float32)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    pv = {"params": variables["params"],
          "batch_stats": variables["batch_stats"]}
    x = torch.from_numpy(exp_r50.make_input(2))
    for f, _ in calls:
        p = getattr(f.__wrapped__, "__self__", None)
        if p is None or not hasattr(p, "upto"):
            continue
        f32 = type("Prefix32", (type(p),), {"dtype": jnp.float32})
        want = np.asarray(f32(upto=p.upto).apply(pv, jnp.asarray(_nhwc(x))))
        with torch.inference_mode():
            _close(_nhwc(exp_r50.prefix(model, x, p.upto)), want)
    cfg = tarc.ARCFACE_CONFIGS["w600k_r50"]
    with torch.inference_mode():
        assert exp_r50.flops(lambda: model(x)) == _analytic_r50_flops(cfg, 2)


@pytest.mark.slow
def test_exp_scrfd_parts_match_jax_at_full_width():
    cfg = jscrfd.SCRFD_CONFIGS["det_10g"]
    jnet = jscrfd.SCRFDNet(cfg, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jinit.cpu_init(jnet, 0, (1, 128, 128, 3)))
    net = exp_scrfd.make_net(tscrfd.SCRFD_CONFIGS["det_10g"], "cpu",
                             torch.float32)
    load_flax_variables(net, v)
    x = torch.from_numpy(exp_scrfd.make_input(1, size=128))
    want = jnet.apply(v, jnp.asarray(_nhwc(x)))
    with torch.inference_mode():
        head = net(x)
    for k in ("scores", "bboxes", "kps"):
        for a, b in zip(head[k], want[k]):
            _close(a, b)
