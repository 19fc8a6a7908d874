"""The port's ONNX load path against the JAX package's, on the CPU.

Seeded torch stand-ins (``tests/torch_export.py``: det_500m at 320 px,
w600k_mbf, and width/depth-mutated det_10g and w600k_r50 graphs) are
exported to ONNX with the exporter that needs no ``onnx`` package, then
loaded by both packages. Tolerances: the parsed graphs, the inferred
configs and the imported weight trees equal (exactly, leaf by leaf); the
models built from the two trees agree at the port's model tolerances
(rtol 1e-4 of the output scale, embedding cosine >= 0.99999) and the
detectors' detections at the pipeline's (boxes and kps 1e-2 px, scores
1e-4, valid equal).
"""
import dataclasses
import os
import sys
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_export import (MUTATED_STAND_INS, STAND_INS,  # noqa: E402
                          calibrate_detector, export_onnx, seeded)
from scrfd_arcface_facerecognition_tpu.models import (  # noqa: E402
    config_from_graph as jcfg, onnx_proto as jproto)
from scrfd_arcface_facerecognition_tpu.pipeline import (  # noqa: E402
    Detector as JDetector)
from scrfd_arcface_facerecognition_tpu_torch.models import (  # noqa: E402
    config_from_graph as tcfg, onnx_import as toi, onnx_proto as tproto)
from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import (  # noqa: E402
    build_scrfd)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (  # noqa: E402
    _leaves)
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (  # noqa: E402
    Detector as TDetector, Embedder as TEmbedder)

# name -> (stand-in constructor, input side)
GRAPHS = {
    "det_500m": (STAND_INS["det_500m"], 320),
    "w600k_mbf": (STAND_INS["w600k_mbf"], 112),
    "det_10g_mutated": (MUTATED_STAND_INS["det_10g"], 320),
    "w600k_r50_mutated": (MUTATED_STAND_INS["w600k_r50"], 112),
}


def export(name, ctor, side, directory):
    tm = seeded(ctor(), seed=zlib.crc32(name.encode()) % 1000)
    if hasattr(tm, "scales"):
        tm = calibrate_detector(tm)
    path = os.path.join(str(directory), f"{name}.onnx")
    export_onnx(tm, torch.randn(1, 3, side, side), path)
    return path


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    return {n: export(n, c, s, d) for n, (c, s) in GRAPHS.items()}


@pytest.fixture(scope="module")
def imported(graphs):
    """name -> (JAX model, JAX variables, port config, port tree)."""
    out = {}
    for name, path in graphs.items():
        side = GRAPHS[name][1]
        jm, jv = jcfg.flax_from_onnx(path, input_size=(side, side))
        cfg, tv = tcfg.variables_from_onnx(path, input_size=(side, side))
        out[name] = (jm, jax.tree.map(np.asarray, jv), cfg, tv)
    return out


def _attr_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name", list(GRAPHS))
def test_onnx_proto_copy_parses_the_same(graphs, name):
    want = jproto.load_onnx(graphs[name])
    got = tproto.load_onnx(graphs[name])
    assert got.inputs == want.inputs and got.outputs == want.outputs
    assert len(got.nodes) == len(want.nodes) > 0
    for g, w in zip(got.nodes, want.nodes):
        assert (g.op_type, g.name, g.inputs, g.outputs) == (
            w.op_type, w.name, w.inputs, w.outputs)
        assert set(g.attrs) == set(w.attrs)
        assert all(_attr_equal(g.attrs[k], w.attrs[k]) for k in g.attrs)
    assert list(got.initializers) == list(want.initializers)
    for k, v in want.initializers.items():
        assert got.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.initializers[k], v)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_infer_config_matches_jax(graphs, name):
    want = jcfg.infer_config(jproto.load_onnx(graphs[name]), name=name)
    got = tcfg.infer_config(tproto.load_onnx(graphs[name]), name=name)
    fields = [f.name for f in dataclasses.fields(got)]
    assert len(fields) >= 8
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (list, tuple)):
            g, w = tuple(g), tuple(w)
        assert g == w, f


def _flat(tree):
    return {p: np.asarray(v) for p, v in _leaves(tree)}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_imported_tree_equals_flax_from_onnx(imported, name):
    _, jv, _, tv = imported[name]
    want, got = _flat(jv), _flat(tv)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == np.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))


def _close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["det_500m", "det_10g_mutated"])
def test_detector_from_onnx_agrees_with_jax(imported, name):
    jm, jv, cfg, tv = imported[name]
    side = GRAPHS[name][1]
    det = TDetector(config=cfg, variables=tv, input_size=(side, side),
                    conf_thres=0.5, pre_nms=64, max_det=32, device="cpu")
    x = np.random.default_rng(5).normal(size=(1, side, side, 3)).astype(
        np.float32) * 0.5
    want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = det.model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for key in ("scores", "bboxes", "kps"):
        for g, w in zip(got[key], want[key]):
            _close(g.numpy(), np.asarray(w))

    # detections on a smooth frame, against the JAX Detector on its tree
    rng = np.random.default_rng(6)
    small = torch.from_numpy(rng.uniform(0, 255, (1, 3, 12, 16)).astype(
        np.float32))
    frame = torch.nn.functional.interpolate(
        small, size=(240, 320), mode="bilinear", align_corners=False).round(
        ).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    jdet = JDetector(config=jm.config, variables=jv, input_size=(side, side),
                     conf_thres=0.5, pre_nms=64, max_det=32)
    jd = jax.tree.map(np.asarray, jdet.detect_batched(jnp.asarray(frame)))
    td = det.detect_batched(frame)
    assert 0 < int(td.valid.sum()) < 32         # faces found, not saturated
    np.testing.assert_array_equal(td.valid.numpy(), jd.valid)
    np.testing.assert_allclose(td.boxes.numpy(), jd.boxes, atol=1e-2)
    np.testing.assert_allclose(td.kps.numpy(), jd.kps, atol=1e-2)
    np.testing.assert_allclose(td.scores.numpy(), jd.scores, atol=1e-4)


@pytest.mark.parametrize("name", ["w600k_mbf", "w600k_r50_mutated"])
def test_embedder_from_onnx_agrees_with_jax(imported, name):
    jm, jv, cfg, tv = imported[name]
    emb = TEmbedder(config=cfg, variables=tv, device="cpu")
    x = np.random.default_rng(7).normal(size=(2, 112, 112, 3)).astype(
        np.float32) * 0.5
    want = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = emb.model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
                        ).numpy()
    _close(got, want)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999, cos


def test_wrong_family_and_wrong_architecture_are_refused(graphs):
    g = tproto.load_onnx(graphs["w600k_mbf"])
    assert tcfg.detect_family(g) == "mobilefacenet"
    with pytest.raises(tcfg.ConfigInferenceError):
        tcfg.infer_scrfd_config(g)
    # the registry's det_10g cannot take the mutated graph's weights
    with pytest.raises(toi.ImportError_):
        toi.import_into_module(lambda: build_scrfd("det_10g"),
                               tproto.load_onnx(graphs["det_10g_mutated"]),
                               (1, 3, 320, 320))


def test_not_onnx_is_refused(tmp_path):
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"\xff\xff\xff\xff not a model")
    with pytest.raises(ValueError):
        tproto.load_onnx(str(bad))


@pytest.mark.slow
@pytest.mark.parametrize("name,side", [("det_10g", 640), ("w600k_r50", 112)])
def test_full_size_stand_ins_import_like_jax(tmp_path, name, side):
    """The main path's stand-ins, exported as chip_smoke.py exports them:
    equal trees, and the port's models agree with the JAX ones."""
    tm = seeded(STAND_INS[name](), seed=zlib.crc32(name.encode()) % 1000)
    if hasattr(tm, "scales"):
        tm = calibrate_detector(tm)
    path = str(tmp_path / f"{name}.onnx")
    export_onnx(tm, torch.randn(1, 3, side, side), path)
    jm, jv = jcfg.flax_from_onnx(path, name=name, input_size=(side, side))
    cfg, tv = tcfg.variables_from_onnx(path, name=name,
                                       input_size=(side, side))
    want, got = _flat(jax.tree.map(np.asarray, jv)), _flat(tv)
    assert set(got) == set(want)
    for path_, w in want.items():
        np.testing.assert_array_equal(got[path_], w)
    if name == "w600k_r50":
        emb = TEmbedder(config=cfg, variables=tv, device="cpu")
        x = np.random.default_rng(8).normal(size=(1, 112, 112, 3)).astype(
            np.float32) * 0.5
        want_e = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(x)))
        with torch.no_grad():
            got_e = emb.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        _close(got_e, want_e)
