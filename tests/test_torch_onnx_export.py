"""The port's ONNX exporter and writer against the JAX package's, on the CPU.

Seeded Flax trees (``_randomize``: He-scaled kernels, BN near identity, the
JAX exporter tests' statistics) of the tiny iResNet, MobileFaceNet (stage 0
a plain dw conv, and residual blocks) and SCRFD (plain and space-to-depth
stems) go through the JAX exporter and through the port's, the port's
taking a port module loaded with the tree and the tree with its config.
Tolerances: the exported bytes equal; export -> import equal bit for bit;
the exported file through the port's executor within the f32 budget of
the models (atol 1e-4 + rtol 1e-4 elementwise, as the JAX exporter's
tests; embedding cosine >= 0.9999); the writer's bytes equal the JAX
writer's on the same inputs.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.models import arcface as JA
from scrfd_arcface_facerecognition_tpu.models import onnx_export as JE
from scrfd_arcface_facerecognition_tpu.models import onnx_write as JW
from scrfd_arcface_facerecognition_tpu.models import scrfd as JS
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as TA
from scrfd_arcface_facerecognition_tpu_torch.models import onnx_export as TE
from scrfd_arcface_facerecognition_tpu_torch.models import onnx_write as TW
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_exec import onnx_model
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_import import (
    import_into_module)
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_proto import (
    iter_fields, load_onnx)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    _leaves, load_flax_variables, variables_from_module)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

IRES = dict(name="tiny_ires", arch="iresnet", emb_dim=32,
            stage_blocks=(1, 1, 1, 1), stage_filters=(8, 8, 16, 16))
MBF = dict(name="tiny_mbf", arch="mobilefacenet", emb_dim=32,
           mbf_blocks=(1, 1, 1, 1), mbf_scale=1)
MBF2 = dict(MBF, mbf_blocks=(2, 1, 1, 1))
DET = (("tiny_det", 8, (1, 1, 1, 1), (8, 8, 16, 16)),
       dict(neck_filters=8, head_stacks=2, head_filters=16))


def _randomize(tree, seed=0):
    """Random weights with sane statistics (the JAX exporter tests'):
    He-scaled kernels, BN near identity, var > 0."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "scale" or name.startswith("scale"):
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name in ("bias", "mean", "alpha"):
            return rng.normal(size=a.shape, scale=0.1).astype(np.float32)
        fan_out = a.shape[-1] if a.ndim >= 1 else 1
        rec = int(np.prod(a.shape[:-2])) if a.ndim > 2 else 1
        std = float(np.sqrt(2.0 / max(fan_out * rec, 1)))
        return rng.normal(size=a.shape, scale=std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


def jax_and_port(kind, seed=0):
    """(JAX model, numpy Flax tree, port config, port module on that tree)."""
    if kind == "det":
        args, kw = DET
        jm, tcfg = JS.SCRFDNet(JS.SCRFDConfig(*args, **kw)), \
            TS.SCRFDConfig(*args, **kw)
        shape = (1, 64, 64, 3)
    else:
        kw = {"ires": IRES, "mbf": MBF, "mbf2": MBF2}[kind]
        jcfg = JA.ArcFaceConfig(**kw)
        jm = JA.IResNet(jcfg) if kw["arch"] == "iresnet" \
            else JA.MobileFaceNet(jcfg)
        tcfg = TA.ArcFaceConfig(**kw)
        shape = (1, 112, 112, 3)
    tree = _randomize(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros(shape))), seed)
    module = (TS.SCRFDNet(tcfg) if kind == "det"
              else TA.arcface_from_config(tcfg))
    return jm, tree, tcfg, load_flax_variables(module, tree)


def _jax_bytes(jm, tree):
    return JE.export_model(jm, jax.tree.map(jnp.asarray, tree))


# ------------------------------------------------------- byte-equal exports


@pytest.mark.parametrize("kind", ["ires", "mbf", "mbf2", "det"])
def test_exports_equal_the_jax_exporters_bytes(kind):
    jm, tree, cfg, module = jax_and_port(kind)
    want = _jax_bytes(jm, tree)
    assert TE.export_model(module) == want
    assert TE.export_model(cfg, tree) == want
    fn = TE.export_scrfd if kind == "det" else TE.export_arcface
    assert fn(module) == want


def test_s2d_stem_tree_exports_the_jax_exporters_bytes():
    args, kw = DET
    jm, tree, cfg, _ = jax_and_port("det", seed=3)
    s2d_model = JS.SCRFDNet(JS.SCRFDConfig(*args, **kw, s2d_stem=True))
    s2d_tree = jax.tree.map(np.asarray, JS.adapt_stem_variables(
        jax.tree.map(jnp.asarray, tree), True))
    assert s2d_tree["params"]["backbone"]["stem1"]["conv"]["kernel"].shape[
        :3] == (2, 2, 12)
    want = JE.export_scrfd(s2d_model, jax.tree.map(jnp.asarray, s2d_tree))
    assert want == _jax_bytes(jm, tree)        # the plain stem it equals
    assert TE.export_scrfd(cfg, s2d_tree) == want
    module = load_flax_variables(TS.SCRFDNet(cfg), s2d_tree)
    assert TE.export_scrfd(module) == want


def test_a_config_without_its_tree_is_refused():
    _, _, cfg, _ = jax_and_port("mbf")
    with pytest.raises(ValueError, match="needs its variables"):
        TE.export_arcface(cfg)
    with pytest.raises(ValueError, match="unknown ArcFace arch"):
        TE.export_arcface(dataclasses.replace(cfg, arch="vit"), {})


# ------------------------------------------------- round trip and executor


def _flat(tree):
    return {p: np.asarray(v) for p, v in _leaves(tree)}


@pytest.mark.parametrize("kind", ["ires", "mbf", "mbf2", "det"])
def test_export_import_round_trip_is_bit_exact(tmp_path, kind):
    _, _, cfg, module = jax_and_port(kind, seed=1)
    path = str(tmp_path / f"{kind}.onnx")
    TE.export_model(module, path=path)
    if kind == "det":
        build, shape = (lambda: TS.SCRFDNet(cfg)), (1, 3, 64, 64)
    else:
        build, shape = (lambda: TA.arcface_from_config(cfg)), \
            (1, 3, 112, 112)
    got = _flat(import_into_module(build, load_onnx(path), shape))
    want = _flat(variables_from_module(module))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("kind", ["ires", "mbf", "det"])
def test_exported_file_runs_through_the_executor(tmp_path, kind):
    _, _, cfg, module = jax_and_port(kind, seed=2)
    path = str(tmp_path / f"{kind}.onnx")
    TE.export_model(module, path=path)
    side = (64, 64) if kind == "det" else (112, 112)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 3, *side)).astype(np.float32))
    with torch.no_grad():
        got = onnx_model(path, device="cpu")(x)
        ref = module.eval()(x)
    if kind == "det":
        ref = ref["scores"] + ref["bboxes"] + ref["kps"]
        assert len(got) == 9
    else:
        ref = [ref]
        cos = torch.nn.functional.cosine_similarity(got[0], ref[0])
        assert float(cos.min()) >= 0.9999
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------------------------ writer details


def test_negative_attribute_ints_and_the_writer_copy(tmp_path):
    """Negative ints encode as 64-bit two's complement; every encoder of
    the port's writer gives the JAX writer's bytes."""
    def nodes(w):
        return [w.encode_node("Flatten", ["x"], ["y"],
                              attrs=[w.encode_attr_int("axis", -1)]),
                w.encode_node("Slice", ["y"], ["z"], name="s",
                              attrs=[w.encode_attr_ints("starts", [0]),
                                     w.encode_attr_ints("ends", [-1]),
                                     w.encode_attr_ints("axes", [-1])]),
                w.encode_node("Resize", ["z"], ["r"], attrs=[
                    w.encode_attr_string("mode", "nearest"),
                    w.encode_attr_float("epsilon", 1e-5)])]

    rng = np.random.default_rng(0)
    inits = {"a": rng.normal(size=(2, 3)).astype(np.float32),
             "b": np.asarray([1, -2, 3], np.int64),
             "c": rng.integers(0, 255, 4).astype(np.uint8)}
    io = {"x": (1, ("batch", 3, 8, "w")), "r": (1, ("batch", 4))}
    for kw in ({}, {"io_types": io, "opset": 13, "graph_name": "g"}):
        got = TW.encode_model(nodes(TW), inits, ["x"], ["r"], **kw)
        assert got == JW.encode_model(nodes(JW), inits, ["x"], ["r"], **kw)
    for a in (inits["a"], inits["b"], inits["c"]):
        assert TW.encode_tensor("t", a) == JW.encode_tensor("t", a)
    assert TW._varint(-1) == JW._varint(-1) and len(TW._varint(-1)) == 10
    p = str(tmp_path / "neg.onnx")
    with open(p, "wb") as f:
        f.write(TW.encode_model(nodes(TW)[:2], {}, ["x"], ["z"]))
    g = load_onnx(p)
    assert g.nodes[0].attrs["axis"] == -1
    assert g.nodes[1].attrs["ends"] == [-1]
    assert g.nodes[1].attrs["axes"] == [-1]


def _value_infos(data):
    for field, wire, val in iter_fields(data):
        if field == 7 and wire == 2:                   # ModelProto.graph
            for f2, w2, v2 in iter_fields(val):
                if f2 in (11, 12) and w2 == 2:         # input / output
                    yield f2, v2


def _parse_value_info(buf):
    name, elem, dims = None, None, []
    for f, w, v in iter_fields(buf):
        if f == 1 and w == 2:
            name = v.decode()
        elif f == 2 and w == 2:                        # TypeProto
            for f3, w3, v3 in iter_fields(v):
                if f3 == 1 and w3 == 2:                # tensor_type
                    for f4, w4, v4 in iter_fields(v3):
                        if f4 == 1 and w4 == 0:
                            elem = v4
                        elif f4 == 2 and w4 == 2:      # shape
                            dims += [v5 for f5, w5, v5 in iter_fields(v4)
                                     if f5 == 1 and w5 == 2]
    return name, elem, dims


@pytest.mark.parametrize("kind", ["det", "mbf"])
def test_exported_graph_io_carries_type_info(kind):
    """onnxruntime refuses graph IO without a TypeProto: the input and
    every output carry elem_type f32 and a shape."""
    _, _, _, module = jax_and_port(kind)
    vis = list(_value_infos(TE.export_model(module)))
    assert sum(1 for f, _ in vis if f == 11) == 1
    assert sum(1 for f, _ in vis if f == 12) == (9 if kind == "det" else 1)
    for _, buf in vis:
        name, elem, dims = _parse_value_info(buf)
        assert name and elem == 1, name
        assert len(dims) in ((3, 4) if kind == "det" else (2, 4)), name


def test_shared_head_weights_registered_once(tmp_path):
    """The head's tower and branch weights appear once and serve all three
    FPN levels, as in the released files."""
    _, _, _, module = jax_and_port("det")
    path = str(tmp_path / "det.onnx")
    TE.export_scrfd(module, path=path)
    g = load_onnx(path)
    for wname in ("tower0_w", "tower1_w", "cls_w", "box_w", "kps_w"):
        assert wname in g.initializers
        assert sum(wname in n.inputs for n in g.nodes) == 3, wname


# ---------------------------------------------------------------- the CLI


def test_export_model_dispatch():
    for kind, n_out in (("det", 9), ("mbf", 1)):
        _, _, _, module = jax_and_port(kind)
        outs = [f for f, _ in _value_infos(TE.export_model(module))
                if f == 12]
        assert len(outs) == n_out


def test_export_cli_verifies_a_tiny_model(tmp_path, monkeypatch, capsys):
    from scrfd_arcface_facerecognition_tpu_torch.tools import export_onnx

    monkeypatch.setitem(TA.ARCFACE_CONFIGS, "w600k_mbf",
                        TA.ArcFaceConfig(**MBF))
    out = str(tmp_path / "mbf.onnx")
    assert export_onnx.main(["--variant", "w600k_mbf", "--out", out,
                             "--verify", "--device", "cpu"]) == out
    said = capsys.readouterr().out
    cos = float(said.split("cosine(module, onnx) = ")[1].split()[0])
    assert cos >= 1 - 1e-4
    ref = TA.build_arcface("w600k_mbf")
    from scrfd_arcface_facerecognition_tpu_torch.models import seeded_init_
    assert open(out, "rb").read() == TE.export_model(seeded_init_(ref, 0))
