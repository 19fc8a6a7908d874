"""The plain reference: what it imports, its frozen models against the
repository's stand-ins, and each of its stages against a hand case."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import core
from benchmark.reference import align, detect, pq, standins

ROOT = Path(__file__).resolve().parents[2]
PORT = "scrfd_arcface_facerecognition_tpu_torch"


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    """Every module of the benchmark and what it imports of the port, in a
    fresh interpreter: no loaded module's whole top-level name is jax,
    jaxlib, flax or the JAX package (whose name the port's begins
    with)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark import core, harness, compare, counts, trace, control
from benchmark import calibrate
from benchmark.drivers import stream, lookup
from benchmark.reference import align, detect, pq, precision, standins
for f in sorted(Path(core.HERE, "metrics").glob("*.py")):
    core.reader(f.stem)
for f in sorted(Path(core.HERE, "reference", "models").glob("*.py")):
    core.family(f.stem)
import {PORT}.pipeline, {PORT}.gallery.pq, {PORT}.stages
import {PORT}.models.config_from_graph
print(json.dumps([core.forbidden_loaded(),
                  sorted({{n.split('.')[0] for n in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    found, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == []
    assert PORT in tops and "scrfd_arcface_facerecognition_tpu" not in tops


def test_the_forbidden_check_compares_whole_top_level_names():
    assert core.forbidden_loaded([PORT, PORT + ".ops", "jaxtyping"]) == []
    assert core.forbidden_loaded(["jax.numpy", "flax"]) == ["flax", "jax"]
    assert core.forbidden_loaded(
        ["scrfd_arcface_facerecognition_tpu.ops"]) == [
            "scrfd_arcface_facerecognition_tpu"]


def torch_export():
    spec = importlib.util.spec_from_file_location(
        "torch_export", ROOT / "tests" / "torch_export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("part", ["detector", "embedder"])
def test_frozen_architectures_are_the_stand_ins(part):
    """The frozen classes build the repository's stand-ins: at the test
    helper's sizes of the configured variant, the same parameters and
    buffers by name and shape. The configured detector then takes its
    widths from the configuration (``scrfd_10g_bnkps.py``'s, not the
    test helper's)."""
    spec = core.read_json(core.config_file("buffalo_l"))[part]
    te = torch_export()
    with torch.device("meta"):
        want = te.STAND_INS[spec["variant"]]().state_dict()
        got = core.family(spec["family"]).MODULE().state_dict()
        configured = standins.architecture(spec)
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in want)
    if part == "detector":
        stages = configured.backbone.stages
        assert [len(s) for s in stages] == spec["blocks"]
        assert [s[-1].conv2[0].out_channels for s in stages] == \
            spec["planes"]


FAMILIES = sorted(p.stem for p in
                  (core.HERE / "reference" / "models").glob("*.py"))
# an input of each model entry of a configuration: a detector's canvas, an
# embedder's aligned crop
INPUTS = {"detector": (2, 3, 64, 96), "embedder": (2, 3, 112, 112)}
# hand-sized cases, a stage of two blocks in each, so that every kind of
# block runs (iResNet's identity shortcut among them): the sizes, the
# input, and the function that prepares both sides after the stand-in's
# seeding, named alike in ``tests/torch_export.py`` and the family's file
SMALL = {
    "scrfd": (dict(stem=8, blocks=(1, 2, 1, 1), planes=(8, 8, 16, 16),
                   neck=8, head_feat=16, head_stacks=2, gn_groups=4),
              (2, 3, 64, 96), "calibrate_detector"),
    "iresnet": (dict(blocks=(1, 1, 2, 1), planes=(4, 8, 8, 16), emb=16),
                (2, 3, 112, 112), None),
}


def family_entries(name):
    """(model entry, input shape) of each configuration's entries that
    name the family ``name``, cut to its ``small`` size."""
    out = []
    for path in sorted((core.HERE / "configs").glob("*.json")):
        for part, entry in core.model_entries(core.read_json(path)).items():
            if entry["family"] == name:
                out.append((standins.small(entry), INPUTS[part]))
    return out


def same_outputs(ref, ours, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref.eval()(x), ours.eval()(x)
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert len(a) == len(b)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(bool(torch.isfinite(v).all()) for v in b)


@pytest.mark.parametrize("family", FAMILIES)
def test_frozen_copy_computes_what_the_stand_in_computes(family):
    """The repository's stand-in of the family's class name
    (``tests/torch_export.py``) and the frozen copy, given the same
    weights: the same outputs, bit for bit. At the hand-sized case, the
    stand-in seeded and prepared as the test helper does it, and the
    frozen copy prepared by its own file's function of the same name; at
    each configuration's entry of the family cut to its ``small`` size,
    the frozen copy built and prepared from a seed (``standins.build``).
    A family with no stand-in has nothing here to be held to: it needs a
    check of its own, against a case worked out apart from its file."""
    te = torch_export()
    fam = core.family(family)
    stand_in = getattr(te, fam.MODULE.__name__, None)
    if stand_in is None:
        pytest.skip(f"no stand-in {fam.MODULE.__name__} in "
                    "tests/torch_export.py: the family needs a test of its "
                    "own against an independently computed case")
    cases = family_entries(family)
    assert cases, f"no configuration names the family {family!r}"
    for spec, shape in cases:
        ours = standins.build(spec, 2 ** 31 + 7, "cpu")
        ref = stand_in(**standins.sizes(spec))
        ref.load_state_dict(ours.state_dict())
        same_outputs(ref, ours, shape)
    if family in SMALL:
        kw, shape, prepare = SMALL[family]
        ref = te.seeded(stand_in(**kw), seed=7)
        ours = fam.MODULE(**kw)
        ours.load_state_dict(ref.state_dict())
        if prepare is not None:
            getattr(te, prepare)(ref)
            getattr(fam, prepare)(ours)
        same_outputs(ref, ours, shape)


# sha256 of ``standins.build(spec, seed, "cpu").state_dict()`` (each name,
# then its tensor's bytes, in order) for buffalo_l's entries one block a
# stage deep, as recorded on the tree before the families had files of
# their own (e7ac93b): the move keeps every seeded weight bit for bit
BUILT = {
    ("detector", 2 ** 40 + 9):
        "58f1085a2471fcce06fc1348967192a36834bc90698aac5a48f22e6d86f6f41c",
    ("detector", 2 ** 31 + 5):
        "fbf2c19d7c8358371e249b5c8a15a1e3fe79fc9e520e7b07705b991ce2f57604",
    ("embedder", 2 ** 40 + 9):
        "350c363a1d6320e3134f8aceed0d9601375a0c84bd8ebb303f813a3cf505ed06",
    ("embedder", 2 ** 31 + 5):
        "44460591de93a1ff98b87370e97a79751b20bebc6ad7439be9111a6c0d40917c",
}


@pytest.mark.parametrize("part, seed", sorted(BUILT))
def test_build_draws_the_recorded_weights(part, seed):
    spec = standins.small(core.read_json(core.config_file("buffalo_l"))[part])
    h = hashlib.sha256()
    for name, t in standins.build(spec, seed, "cpu").state_dict().items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == BUILT[(part, seed)]


def test_calibrated_norms_are_the_inputs_statistics():
    """After ``calibrate_norms_`` every BatchNorm's running statistics
    are those of what reaches it from the calibration batch, and the
    outputs of different inputs differ."""
    model = standins.build(dict(family="iresnet", blocks=[1, 1, 1, 1],
                                planes=[4, 4, 8, 8], emb=8),
                           2 ** 33 + 1, "cpu")
    x = torch.randn((6, 3, 112, 112),
                    generator=torch.Generator().manual_seed(2))
    seen = {}
    model.bn1.register_forward_hook(
        lambda m, i, o: seen.setdefault("x", i[0].detach()))
    standins.calibrate_norms_(model, x)
    got = seen["x"]
    assert torch.allclose(model.bn1.running_mean, got.mean((0, 2, 3)),
                          atol=1e-6)
    assert torch.allclose(model.bn1.running_var,
                          got.var((0, 2, 3), unbiased=True), rtol=1e-4)
    assert not model.training
    with torch.no_grad():
        e = torch.nn.functional.normalize(model(x), dim=1)
    assert float((e[0] * e[1]).sum()) < 0.99


def test_build_draws_the_same_weights_from_the_same_seed():
    spec = dict(family="iresnet", blocks=[1, 1, 1, 1], planes=[4, 4, 8, 8],
                emb=8)
    a = standins.build(spec, 2 ** 40 + 9, "cpu").state_dict()
    b = standins.build(spec, 2 ** 40 + 9, "cpu").state_dict()
    c = standins.build(spec, 2 ** 40 + 10, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    var = torch.cat([v.flatten() for k, v in a.items()
                     if k.endswith("running_var")])
    assert 0.75 <= float(var.min()) and float(var.max()) < 1.25


def test_letterbox_of_1080p_is_the_trimmed_canvas():
    assert detect.letterbox_plan((1080, 1920), (640, 640)) == (
        (384, 640), (360, 640), 1 / 3)
    w = detect.interp_matrix(5, 12, "cpu")
    assert torch.allclose(w.sum(1), torch.ones(5))
    frames = torch.full((1, 9, 16, 3), 200, dtype=torch.uint8)
    net_in, scale = detect.letterbox(frames, (32, 32))
    assert scale == 2.0
    # content (200 - 127.5) / 128 on the resized 18 x 32 rows, pad below
    assert torch.allclose(net_in[0, :, :18], torch.full((3, 18, 32),
                                                        72.5 / 128))
    assert torch.allclose(net_in[0, :, 18:], torch.full((3, 14, 32),
                                                         -127.5 / 128))


def test_select_keeps_greedy_nms_then_the_largest():
    box = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 80, 80],
                         [0, 40, 5, 45], [100, 0, 120, 20]]],
                       dtype=torch.float)
    hd = {"score": torch.tensor([[0.9, 0.8, 0.7, 0.6, 0.4]]), "box": box}
    sel = detect.select(hd, conf=0.5, iou=0.4, pre_nms=5, max_det=4,
                        max_num=2)
    # box 1 overlaps box 0; box 4 is under conf; of 0, 2, 3 the two largest
    assert sel["kept"].tolist() == [[2, 0]]
    assert sel["count"].tolist() == [2]
    assert float(sel["cut"][0]) == pytest.approx(0.4)


def _select_frame_by_frame(hd, conf, iou, pre_nms, max_det, max_num):
    """The selection written as a loop over frames, ties broken the same."""
    kept = []
    for f in range(hd["score"].shape[0]):
        top_s, top_i = torch.sort(hd["score"][f], descending=True,
                                  stable=True)
        top_s, top_i = top_s[:pre_nms], top_i[:pre_nms]
        boxes = hd["box"][f, top_i]
        over = detect.iou_plus1(boxes, boxes) > iou
        keep = top_s >= conf
        for i in range(pre_nms):
            if keep[i]:
                keep[i + 1:] &= ~over[i, i + 1:]
        idx = top_i[keep][:max_det]
        if 0 < max_num < len(idx):
            bx = hd["box"][f, idx]
            area = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
            idx = idx[torch.sort(area, descending=True,
                                 stable=True).indices[:max_num]]
        kept.append(idx.tolist())
    return kept


@pytest.mark.parametrize("max_num", [0, 3, 10, 20])
def test_select_over_a_batch_is_select_frame_by_frame(max_num):
    """On scores and areas with exact ties; then a tier and a band of 1
    keep exactly the favoured anchors."""
    g = torch.Generator().manual_seed(max_num)
    score = (torch.rand((6, 400), generator=g) * 25).round() / 50 + 0.4
    corner = torch.rand((6, 400, 2), generator=g) * 300
    wh = (torch.rand((6, 400, 2), generator=g) * 6).round() * 10 + 5
    hd = {"score": score, "box": torch.cat([corner, corner + wh], -1)}
    sel = detect.select(hd, conf=0.5, iou=0.4, pre_nms=64, max_det=16,
                        max_num=max_num)
    want = _select_frame_by_frame(hd, 0.5, 0.4, 64, 16, max_num)
    got = [[a for a in row if a >= 0] for row in sel["kept"].tolist()]
    assert got == want
    assert sel["count"].tolist() == [len(w) for w in want]
    # favour the first two kept anchors of each frame, against the rest
    tier = torch.full_like(score, -1)
    fav = sel["kept"][:, :2]
    tier.scatter_(1, fav, 1.0)
    forced = detect.select(hd, conf=0.5, iou=0.4, pre_nms=64, max_det=2,
                           max_num=0, tier=tier, band=1.0)
    assert torch.equal(forced["kept"].sort(1).values, fav.sort(1).values)


def test_similarity_recovers_a_rotation_and_the_warp_samples():
    tpl = torch.tensor(align.TEMPLATE)
    ang, s = 0.3, 2.0
    rot = torch.tensor([[torch.cos(torch.tensor(ang)),
                         -torch.sin(torch.tensor(ang))],
                        [torch.sin(torch.tensor(ang)),
                         torch.cos(torch.tensor(ang))]]) * s
    src = (tpl - 50) @ torch.linalg.inv(rot).T + torch.tensor([300., 200.])
    m = align.similarity(src[None])
    back = src @ m[0, :, :2].T + m[0, :, 2]
    assert torch.allclose(back, tpl, atol=1e-3)
    frames = torch.randint(0, 256, (2, 120, 130, 3), dtype=torch.uint8)
    eye = torch.tensor([[[1.0, 0.0, 3.0], [0.0, 1.0, 2.0]]])
    crop = align.warp(frames, eye, torch.tensor([1]))
    assert torch.equal(crop[0, :112, :112].round().to(torch.uint8),
                       frames[1, 2:114, 3:115])
    off = torch.tensor([[[1.0, 0.0, 1e4], [0.0, 1.0, 0.0]]])
    assert float(align.warp(frames, off, torch.tensor([0])).abs().max()) == 0


def test_pq_reference_against_a_brute_force_decode():
    g = torch.Generator().manual_seed(3)
    cent = torch.randn((4, 16, 2), generator=g)
    codes = torch.randint(0, 16, (300, 4), generator=g, dtype=torch.uint8)
    q = torch.randn((3, 8), generator=g)
    rows = cent[torch.arange(4)[None], codes.long()].reshape(300, 8)
    want = q.double() @ rows.double().T
    table = pq.lut(q, cent)
    assert torch.allclose(pq.scores(table, codes), want)
    assert torch.allclose(pq.top(table, codes, 5, block=64),
                          want.topk(5, dim=1).values)
    picks = torch.tensor([[0, 5], [299, 7], [3, 3]])
    assert torch.allclose(pq.at(table, codes, picks),
                          want.gather(1, picks))
