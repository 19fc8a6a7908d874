"""The port's release sign-off (``tools/verify_release.py``,
``tools/parity_harness.py``, ``tools/check_ui_js.py``) and its reference
replica (``tools/e2e_oracle.py``), on the CPU.

- The replica's numpy resize and warp are bit-equal to cv2 (the card's
  machine has no cv2, so the replica cannot call it).
- The replica imports nothing of the code it checks.
- The graph stage on the det_500m and w600k_mbf stand-ins is within its
  budgets, and the port's executor gives the JAX executor's outputs
  within 1e-4 on the same blobs.
- A bad release file fails the entry point with exit 2, its class and
  the runbook, before anything else runs.
- The port's copy of the web page lint gives the root tool's verdicts.

Marked slow: the whole stand-in sign-off, and the end-to-end stage
against the JAX tool's on the same stand-ins and frames.
"""
import ast
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch.models.onnx_write import (
    encode_attr_ints, encode_model, encode_node)
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    check_ui_js, e2e_oracle as eo, parity_harness, verify_release as vr)
from torch_cores import shared_cores  # noqa: F401

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------ the replica against cv2


RESIZE_CASES = {
    "down": ((108, 192), (36, 64)),
    "up": ((90, 160), (180, 320)),
    "odd": ((77, 123), (53, 99)),
    "same": ((64, 64), (64, 64)),
    "2x_down_area": ((112, 112), (56, 56)),
    "1080p_letterbox": ((1080, 1920), (360, 640)),
    "720p_letterbox_2x": ((720, 1280), (360, 640)),
    "portrait_letterbox": ((1920, 1080), (640, 360)),
    "tiny_up": ((7, 5), (13, 11)),
    "center_crop_up": ((60, 100), (112, 112)),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_linear_u8_is_cv2_bit_for_bit(case):
    (h, w), (oh, ow) = RESIZE_CASES[case]
    rng = np.random.default_rng(sorted(RESIZE_CASES).index(case))
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                rng.integers(0, 256, (h, w), dtype=np.uint8)):
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(eo.resize_linear_u8(img, (oh, ow)),
                                      want)


def test_resize_linear_u8_is_cv2_on_random_shapes():
    rng = np.random.default_rng(40)
    for _ in range(60):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 300, 4))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(eo.resize_linear_u8(img, (oh, ow)),
                                      want, err_msg=f"{(h, w)}->{(oh, ow)}")


def _similarity(rng, deg, scale, shift):
    a = np.deg2rad(deg)
    return np.array([[scale * np.cos(a), -scale * np.sin(a), shift[0]],
                     [scale * np.sin(a), scale * np.cos(a), shift[1]]])


def _face_matrix(rng, h, w, off_frame=False):
    """estimate_norm of five jittered landmarks around a face in the frame
    (or half past its edge)."""
    side = rng.uniform(20, min(h, w) / 2)
    cx = (w + side * 0.3) if off_frame else rng.uniform(side, w - side)
    cy = rng.uniform(side, h - side)
    kps = eo.REFERENCE_ALIGNMENT / 112.0 * side + [cx - side / 2,
                                                   cy - side / 2]
    kps = kps + rng.normal(scale=side * 0.03, size=kps.shape)
    return eo.estimate_norm(kps.astype(np.float32))


WARP_CASES = ("faces", "faces_off_frame", "rotations_30deg", "downscales",
              "upscales", "any_rotation", "narrow_outputs")


@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_affine_linear_u8_is_cv2_bit_for_bit(case):
    """112 x 112 crops (the replica's one output size) from face-like
    matrices, rotations up to 30 deg, down- and upscales, taps off the
    frame; and outputs narrower than 16 columns (cv2's scalar code)."""
    rng = np.random.default_rng(WARP_CASES.index(case) + 100)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(60, 700, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            img = cv2.GaussianBlur(img, (0, 0), 2)    # lerps near .5 steps
        out_hw = (112, 112)
        if case in ("faces", "faces_off_frame"):
            m = _face_matrix(rng, h, w, off_frame=case == "faces_off_frame")
        elif case == "rotations_30deg":
            m = _similarity(rng, rng.uniform(-30, 30), rng.uniform(0.5, 2),
                            rng.uniform(-150, 50, 2))
        elif case == "downscales":
            m = _similarity(rng, rng.uniform(-30, 30), rng.uniform(0.05, 0.5),
                            rng.uniform(-20, 60, 2))
        elif case == "upscales":
            m = _similarity(rng, rng.uniform(-30, 30), rng.uniform(2, 6),
                            -rng.uniform(0, 600, 2))
        elif case == "any_rotation":
            m = _similarity(rng, rng.uniform(-180, 180), rng.uniform(0.3, 3),
                            rng.uniform(-100, 200, 2))
        else:
            m = _similarity(rng, rng.uniform(-30, 30), rng.uniform(0.3, 3),
                            rng.uniform(-50, 50, 2))
            out_hw = (int(rng.integers(1, 200)), int(rng.integers(1, 16)))
        want = cv2.warpAffine(img, m, out_hw[::-1], borderValue=0.0)
        np.testing.assert_array_equal(
            eo.warp_affine_linear_u8(img, m, out_hw), want,
            err_msg=f"{case} {i}: {(h, w)} -> {out_hw}")


def test_warp_tail_columns_are_within_one_step_of_cv2():
    """Outputs wider than 16 whose width is not a multiple of 16: the
    last width % 16 columns take cv2's scalar code, which the replica
    follows to one step at about one pixel in a million (its module
    docstring); the vector columns stay bit-equal."""
    rng = np.random.default_rng(7)
    n_tail = n_off = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(60, 500, 2))
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3),
                                            dtype=np.uint8), (0, 0), 2)
        m = _similarity(rng, rng.uniform(-180, 180), rng.uniform(0.2, 3),
                        rng.uniform(-50, 50, 2))
        oh, ow = 100, int(rng.integers(17, 200)) | 1
        want = cv2.warpAffine(img, m, (ow, oh), borderValue=0.0)
        got = eo.warp_affine_linear_u8(img, m, (oh, ow))
        v = ow - ow % eo.WARP_VECTOR_COLUMNS
        np.testing.assert_array_equal(got[:, :v], want[:, :v])
        d = np.abs(got[:, v:].astype(int) - want[:, v:])
        assert d.max(initial=0) <= 1
        n_tail += d.size
        n_off += int((d > 0).sum())
    assert n_off <= max(1, n_tail // 100_000), (n_off, n_tail)


def test_fma_f32_rounds_once():
    """The emulated FMA against exact rational arithmetic rounded to
    float32, on values whose separate rounding differs."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.normal(size=2000).astype(np.float32) * 300
    b = rng.normal(size=2000).astype(np.float32)
    c = -(a * b).astype(np.float32) + rng.normal(size=2000).astype(
        np.float32) * 1e-4
    got = eo.fma_f32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(
            float(ci))
        lo = np.float32(float(exact))
        # the float32 nearest the exact value, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(x)) - exact) for x in cands]
        best = min(errs)
        near = [x for x, e in zip(cands, errs) if e == best]
        assert gi in near, (ai, bi, ci, gi, near)
    assert (got != (a * b + c)).any()     # separate rounding differs


def test_the_replica_imports_nothing_of_the_code_under_test():
    path = eo.__file__
    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, ast.dump(node)
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "typing", "numpy", "torch"}, roots


def test_synthetic_frames_are_resized_by_the_letterbox():
    frames = eo.synthetic_frames(3)
    assert [f.shape for f in frames] == [(480, 640, 3), (720, 1280, 3),
                                         (1080, 1920, 3)]
    assert all(f.dtype == np.uint8 for f in frames)
    assert {eo.letterbox(f)[1] for f in frames} == {1.0, 0.5, 1 / 3}


# --------------------------------------------------- the graph stage


@pytest.mark.parametrize("name", ["det_500m", "w600k_mbf"])
def test_graph_parity_on_the_standins_and_the_jax_executor(name, tmp_path):
    """Executor and importer against the torch stand-in over 2 synthetic
    frames within the budgets; the executor within 1e-4 of the JAX
    executor on the same blobs."""
    import jax
    import jax.numpy as jnp
    from scrfd_arcface_facerecognition_tpu.models.onnx_exec import (
        onnx_model as jax_onnx_model)

    is_det = name.startswith("det")
    path, tm, mode = vr.resolve_graph(name, None, str(tmp_path))
    assert mode == "standin"
    imgs = eo.synthetic_frames(2)
    w = vr.graph_parity(name, path, vr.torch_forward(tm, is_det), imgs,
                        torch.device("cpu"))
    if is_det:
        assert w["exec_diff"] < vr.DET_RAW_BUDGET, w
        assert w["imp_diff"] < vr.DET_RAW_BUDGET, w
    else:
        assert w["exec_cos"] > 1 - vr.COS_BUDGET, w
        assert w["imp_cos"] > 1 - vr.COS_BUDGET, w

    port = vr.executor_forwards(path, is_det, torch.device("cpu"))
    jm = jax_onnx_model(path)
    apply = jax.jit(jm.apply)
    for im in imgs:
        blob = (eo.det_blob(eo.letterbox(im)[0]) if is_det
                else eo.rec_blob([eo.center_crop112(im)]))
        want = apply(jm.variables, jnp.asarray(blob.transpose(0, 2, 3, 1)))
        want = [np.asarray(t) for t in want] if is_det else [
            np.asarray(want[0] if isinstance(want, (list, tuple)) else want)]
        got = port(blob)
        got = got if is_det else [got]
        assert len(got) == len(want)
        for g, wt in zip(got, want):
            np.testing.assert_allclose(g.reshape(wt.shape), wt, rtol=0,
                                       atol=1e-4)


# ------------------------------------------- bad files at the entry point


def _conv_graph(path, n_outputs=1, op="Conv"):
    """x -> op -> y[, y2 ...]: one Conv keeps the family on iresnet."""
    attrs = []
    if op == "Conv":
        attrs = [encode_attr_ints("kernel_shape", [3, 3]),
                 encode_attr_ints("strides", [1, 1]),
                 encode_attr_ints("pads", [1, 1, 1, 1])]
    outs = [f"y{i}" for i in range(n_outputs)]
    nodes = [encode_node(op, ["x", "w"] if op == "Conv" else ["x"],
                         [outs[0]], attrs=attrs)]
    nodes += [encode_node("Relu", [outs[0]], [o]) for o in outs[1:]]
    init = {"w": np.zeros((4, 1, 3, 3), np.float32)} if op == "Conv" else {}
    with open(path, "wb") as f:
        f.write(encode_model(nodes, init, ["x"], outs))


def _truncated(path):
    _conv_graph(path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:            # cut mid-initializer
        f.write(raw[: int(len(raw) * 0.6)])


BAD_FILES = {
    "empty_file": lambda p: open(p, "wb").close(),
    "not_onnx": lambda p: open(p, "wb").write(b"\x89PNG" + b"\x00" * 500),
    "corrupt_or_truncated": _truncated,
    "unsupported_op": lambda p: _conv_graph(p, op="Atan"),
    "wrong_graph_kind": lambda p: _conv_graph(p, n_outputs=1),
    "output_arity": lambda p: _conv_graph(p, n_outputs=3),
}


@pytest.mark.parametrize("kind", list(BAD_FILES))
def test_signoff_entry_point_fails_loudly(kind, tmp_path, capsys):
    """A bad det_500m.onnx (the first file of the order) stops the port's
    sign-off with exit 2, ``SIGN-OFF FAIL``, the class and the runbook,
    before any stand-in is exported or any frame made."""
    weights = tmp_path / "weights"
    weights.mkdir()
    BAD_FILES[kind](str(weights / "det_500m.onnx"))
    rc = vr.main(["--device", "cpu", "--weights", str(weights), "--n", "2",
                  "--out", str(tmp_path / "PARITY.md")])
    out = capsys.readouterr().out
    assert rc == 2
    assert "SIGN-OFF FAIL" in out and kind in out, out
    assert "RUNBOOK" in out
    assert "frames:" not in out and not (tmp_path / "PARITY.md").exists()


def test_the_bad_file_classes_are_the_jax_entry_points():
    src = open(os.path.join(_REPO, "tests",
                            "test_verify_release_negative.py")).read()
    tree = ast.parse(src)
    lists = [ast.literal_eval(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "ENTRY_CLASSES"]
    assert lists == [list(BAD_FILES)]


# ----------------------------------------------------- the page lint


def _root_lint():
    spec = importlib.util.spec_from_file_location(
        "root_check_ui_js", os.path.join(_REPO, "tools", "check_ui_js.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pages():
    from scrfd_arcface_facerecognition_tpu.apps.webui import (
        INDEX_HTML as jax_page)
    from scrfd_arcface_facerecognition_tpu_torch.apps.webui import (
        INDEX_HTML as port_page)
    head, script = port_page.split("<script>", 1)

    def broken(drop):
        return head + "<script>" + script.replace(drop, "", 1)
    return {"jax": jax_page, "port": port_page,
            "unbalanced_brace": broken("{"),
            "unterminated_template": broken("`")}


@pytest.mark.parametrize("page", ["jax", "port", "unbalanced_brace",
                                  "unterminated_template"])
def test_check_ui_js_gives_the_root_tools_verdict(page):
    root = _root_lint()
    html = _pages()[page]
    verdicts = []
    for check in (root.check_js, check_ui_js.check_js):
        try:
            check(check_ui_js.script_of(html))
            verdicts.append("ok")
        except AssertionError as e:
            verdicts.append(f"fails: {e}")
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] == "ok") == (page in ("jax", "port"))


def test_check_ui_js_checks_the_ports_page_by_default(tmp_path, capsys,
                                                      monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.apps import webui

    assert check_ui_js.main([]) == 0
    monkeypatch.setattr(webui, "INDEX_HTML", _pages()["unbalanced_brace"])
    with pytest.raises(AssertionError):
        check_ui_js.main([])


# ------------------------------------------------ slow: the whole sign-off


@pytest.mark.slow
def test_five_graph_standin_signoff(tmp_path, capsys):
    """``verify_release --device cpu``: all five stand-ins through both
    load paths and the round trip, both pairings end to end, every row
    PASS, the report written where ``--out`` says."""
    out = tmp_path / "PARITY.md"
    assert vr.main(["--device", "cpu", "--n", "3", "--out", str(out)]) == 0
    text = out.read_text()
    assert "Device: **CPU**" in text and "FAIL" not in text
    for name in vr.DETS + vr.RECS:
        assert f"| {name} | standin |" in text
    assert text.count("| PASS |") == 7
    assert parity_harness.main(["--device", "cpu", "--n", "2", "--tmpdir",
                                str(tmp_path / "harness")]) == 0


@pytest.mark.slow
def test_e2e_stage_matches_the_jax_tools(tmp_path):
    """The port's e2e stage and the JAX tool's on the same det_500m +
    w600k_mbf stand-ins and synthetic frames: the same picked thresholds,
    face counts and mismatches, both PASS. The strict faces and tie swaps
    may differ only inside the replica's tie chains: a kept face and the
    overlapping candidates that tie its score, one of which rounding at
    1e-7 (XLA's convolutions against torch's) keeps. On these frames one
    chain of three anchors moves two faces from strict to tie swaps."""
    sys.path[:0] = [os.path.join(_REPO, "tools"), os.path.join(_REPO,
                                                               "tests")]
    try:
        import verify_release as jvr
    finally:
        del sys.path[:2]
    imgs = eo.synthetic_frames(3)
    det_path, det_tm, _ = vr.resolve_graph("det_500m", None, str(tmp_path))
    rec_path, rec_tm, _ = vr.resolve_graph("w600k_mbf", None, str(tmp_path))
    port = vr.e2e_parity("det_500m", "w600k_mbf", det_path, rec_path,
                         vr.torch_forward(det_tm, True),
                         vr.torch_forward(rec_tm, False), imgs,
                         torch.device("cpu"))
    jax_w = jvr.e2e_parity("det_500m", "w600k_mbf", det_path, rec_path,
                           jvr.torch_forward(det_tm, True),
                           jvr.torch_forward(rec_tm, False), imgs)
    assert port["thresh"] == jax_w["thresh"]
    for key in ("n_faces", "count_mismatch"):
        assert port[key] == jax_w[key], (key, port, jax_w)
    assert vr.e2e_passed(port) and vr.e2e_passed(jax_w), (port, jax_w)
    oracle = eo.OracleStack(vr.torch_forward(det_tm, True),
                            vr.torch_forward(rec_tm, False),
                            conf_thres=port["thresh"],
                            iou_thres=port["iou"])
    members = 0                       # faces and candidates in tie chains
    for im in imgs:
        cands = oracle.candidates(im)
        iou = eo.pairwise_iou_legacy(cands)
        for d in oracle.detect(im, max_num=10)[0]:
            i = int(np.flatnonzero((cands == d).all(1))[0])
            chain = ((np.abs(cands[:, 4] - cands[i, 4]) < 1e-6)
                     & (iou[i] > port["iou"]))
            members += int(chain.sum()) if chain.sum() > 1 else 0
    moved = abs(port["n_strict"] - jax_w["n_strict"])
    assert moved == abs(port["tie_swaps"] - jax_w["tie_swaps"])
    assert moved <= members, (moved, members, port, jax_w)
