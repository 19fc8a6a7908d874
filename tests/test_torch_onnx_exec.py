"""The port's ONNX graph executor against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX executor (jitted, as the
JAX package's tests run it: its weights are traced values, so nodes on
them never fold) and the port's (``device="cpu"``). Tolerances:

- op cases (graphs written with ``tests/onnx_writer.py``, one or a few
  ops each; every name of ``SUPPORTED_OPS`` has one) and the small
  models at float32: rtol 1e-5 of each element plus 1e-6 of the output's
  largest magnitude (both sides compute in float32; only the sum order
  of convolutions and reductions differs);
- the 24 seeded ``RandomNet`` programs of ``tests/test_onnx_exec_fuzz.py``:
  against the torch module at that file's atol 3e-4, rtol 2e-3, and
  against the JAX executor at rtol 1e-5 plus 2e-6 of the largest
  magnitude;
- the pipeline, ``Detector`` / ``Embedder`` and the facade at float32:
  the f32 budget of root ``PERF.md`` §2 (valid, count and match_idx
  equal; boxes and kps within 1e-2 px; scores and match_sim within 1e-4;
  embedding cosine >= 0.9999);
- bfloat16: the bf16 budget (``tests/test_torch_bf16.py``), with JAX in a
  child process whose XLA rounds every bf16 op (``jax_reference``): head
  outputs within 2 bf16 ulps at their largest magnitude (scores through
  the sigmoid's slope), embedding cosine >= 0.9999; the pipeline's faces
  paired by IoU >= 0.9, a face on one side only a checked tie.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from onnx_writer import (encode_attr_float, encode_attr_int,  # noqa: E402
                         encode_attr_ints, encode_attr_string, encode_model,
                         encode_node, encode_tensor)
from scrfd_arcface_facerecognition_tpu.models import (  # noqa: E402
    onnx_exec as jexec)
from scrfd_arcface_facerecognition_tpu.models.onnx_write import (  # noqa: E402
    _len_field, _varint_field)
from scrfd_arcface_facerecognition_tpu_torch.models import (  # noqa: E402
    graph_models as tgm, onnx_exec as texec, preflight as tpre)
from torch_export import (STAND_INS, TorchIResNet, TorchSCRFD,  # noqa: E402
                          calibrate_detector, export_onnx, seeded)
from test_torch_bf16 import (bf16_ulp, jax_reference,  # noqa: E402
                             match_detections, score_tol)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

INT64_MAX = np.iinfo(np.int64).max


# ------------------------------------------------------------ the runners


def jax_run(path, x, dtype=jnp.float32):
    """The JAX executor, jitted, on an NCHW numpy input."""
    m = jexec.onnx_model(path, dtype=dtype)
    outs = jax.jit(m.apply)(m.variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    return [np.asarray(o, np.float32) for o in outs]


def port_run(path, x, dtype=torch.float32):
    m = texec.onnx_model(path, dtype=dtype, device="cpu")
    with torch.inference_mode():
        return [o.numpy() for o in m(torch.from_numpy(x))]


def assert_close(got, want, rtol=1e-5, scale=1e-6, what=""):
    """|got - want| <= rtol * |want| + scale * max |want|."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mag = float(np.abs(want[np.isfinite(want)]).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * mag + 1e-30,
                               err_msg=what)


# -------------------------------------------------------------- op cases


def attr(name, v):
    if isinstance(v, str):
        return encode_attr_string(name, v)
    if isinstance(v, float):
        return encode_attr_float(name, v)
    if isinstance(v, np.ndarray):       # a TENSOR attribute
        return (_len_field(1, name.encode()) + _len_field(5, encode_tensor(
            "", v)) + _varint_field(20, 4))
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
        return (_len_field(1, name.encode()) + _len_field(7, np.asarray(
            v, "<f4").tobytes()) + _varint_field(20, 6))
    if isinstance(v, (list, tuple)):
        return encode_attr_ints(name, v)
    return encode_attr_int(name, v)


def N(op, ins, outs, **attrs):
    return encode_node(op, list(ins), list(outs), name=f"{op}_{outs[0]}",
                       attrs=[attr(k, v) for k, v in attrs.items()])


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def i64(*v):
    return np.asarray(v, np.int64)


def c4(v):
    return np.asarray(v, np.float32).reshape(1, 4, 1, 1)


def _conv(rng):
    return {
        "conv_same_upper": ([N("Conv", ["x", "w"], ["y"], auto_pad="SAME_UPPER",
                               kernel_shape=[3, 3], strides=[2, 2])],
                            {"w": f32(rng, 6, 4, 3, 3, scale=0.2)}),
        "conv_same_lower": ([N("Conv", ["x", "w"], ["y"], auto_pad="SAME_LOWER",
                               kernel_shape=[4, 4])],
                            {"w": f32(rng, 6, 4, 4, 4, scale=0.2)}),
        "conv_asym_pads_strided_dilated_bias": (
            [N("Conv", ["x", "w", "b"], ["y"], kernel_shape=[3, 3],
               pads=[1, 2, 2, 1], strides=[2, 1], dilations=[2, 2])],
            {"w": f32(rng, 5, 4, 3, 3, scale=0.2), "b": f32(rng, 5)}),
        "conv_depthwise": ([N("Conv", ["x", "w", "b"], ["y"], group=4,
                              kernel_shape=[3, 3], pads=[1, 1, 1, 1])],
                           {"w": f32(rng, 8, 1, 3, 3), "b": f32(rng, 8)}),
        "conv_valid": ([N("Conv", ["x", "w"], ["y"], auto_pad="VALID",
                          kernel_shape=[3, 2])],
                       {"w": f32(rng, 3, 4, 3, 2, scale=0.2)}),
    }


def _pools(rng):
    return {
        "maxpool_asym_pads": ([N("MaxPool", ["x"], ["y"], kernel_shape=[3, 3],
                                 strides=[2, 2], pads=[0, 0, 1, 1])], {}),
        "avgpool_asym_pads_exclude": (
            [N("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
               strides=[2, 2], pads=[1, 0, 0, 1], count_include_pad=0)], {}),
        "avgpool_include_pad": (
            [N("AveragePool", ["x"], ["y"], kernel_shape=[2, 2],
               strides=[1, 1], pads=[1, 1, 1, 1], count_include_pad=1)], {}),
        "pool_ceil_mode_same_size": (
            [N("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
               strides=[2, 2], ceil_mode=1, count_include_pad=0)], {}),
        "pool_ceil_mode_refused": (
            [N("MaxPool", ["x"], ["y"], kernel_shape=[2, 2], strides=[2, 2],
               ceil_mode=1)], {}, texec.UnsupportedOp),
        "globalavgpool_flatten_gemm": (
            [N("GlobalAveragePool", ["x"], ["g"]),
             N("Flatten", ["g"], ["f"]),
             N("Gemm", ["f", "w", "b"], ["y"], transB=1)],
            {"w": f32(rng, 5, 4), "b": f32(rng, 5)}),
    }


def _resize(rng):
    return {
        "resize_scales": ([N("Resize", ["x", "", "s"], ["y"], mode="nearest")],
                          {"s": np.asarray([1, 1, 2, 3], np.float32)}),
        "resize_sizes": ([N("Resize", ["x", "", "", "s"], ["y"],
                            mode="nearest")], {"s": i64(2, 4, 18, 27)}),
        "upsample_input": ([N("Upsample", ["x", "s"], ["y"], mode="nearest")],
                           {"s": np.asarray([1, 1, 2, 2], np.float32)}),
        "upsample_attr": ([N("Upsample", ["x"], ["y"], mode="nearest",
                             scales=[1.0, 1.0, 3.0, 2.0])], {}),
        "resize_fractional_refused": (
            [N("Resize", ["x", "", "s"], ["y"], mode="nearest")],
            {"s": np.asarray([1, 1, 1.5, 1.5], np.float32)},
            texec.UnsupportedOp),
    }


def _shapes(rng):
    big = INT64_MAX
    return {
        "slice_steps_and_sentinels": (
            [N("Slice", ["x", "st", "en", "ax", "sp"], ["a"]),
             N("Slice", ["a", "st2", "en2"], ["y"])],
            {"st": i64(-1, 0, 1), "en": i64(-big, big, -1),
             "ax": i64(3, 2, 1), "sp": i64(-2, 3, 1),
             "st2": i64(0, 0, 0, 1), "en2": i64(2, 3, big, big)}),
        "slice_attrs_opset9": (
            [N("Slice", ["x"], ["y"], starts=[1, -4], ends=[3, 1000],
               axes=[1, 3])], {}, None, 9),
        "split_attr": ([N("Split", ["x"], ["a", "b"], axis=1, split=[1, 3]),
                        N("Concat", ["b", "a"], ["y"], axis=1)], {}),
        "split_input": ([N("Split", ["x", "s"], ["a", "b"], axis=1),
                         N("Concat", ["b", "a"], ["y"], axis=1)],
                        {"s": i64(3, 1)}, None, 13),
        "split_equal": ([N("Split", ["x"], ["a", "b"], axis=1),
                         N("Concat", ["b", "a", "b"], ["y"], axis=1)], {}),
        "expand": ([N("Slice", ["x", "z", "o", "one"], ["a"]),
                    N("Expand", ["a", "shp"], ["e"]),
                    N("Add", ["e", "x"], ["y"])],
                   {"z": i64(0), "o": i64(1), "one": i64(1),
                    "shp": i64(1, 4, 1, 1)}),
        "transpose_unsqueeze_squeeze_flatten": (
            [N("Transpose", ["x"], ["t"], perm=[0, 2, 3, 1]),
             N("Unsqueeze", ["t"], ["u"], axes=[1, -1]),
             N("Squeeze", ["u"], ["s"], axes=[1]),
             N("Flatten", ["s"], ["y"], axis=2)], {}),
        "unsqueeze_squeeze_axes_input": (
            [N("Unsqueeze", ["x", "a"], ["u"]),
             N("Squeeze", ["u", "a"], ["y"])], {"a": i64(0)}, None, 13),
        "transpose_default_perm": ([N("Transpose", ["x"], ["y"])], {}),
        "gather_scalar_and_vector": (
            [N("Gather", ["x", "i0"], ["g0"], axis=1),
             N("Gather", ["x", "iv"], ["g1"], axis=3),
             N("Constant", [], ["k"], value=i64(1, 0)),
             N("Gather", ["x", "k"], ["g2"], axis=-3)],
            {"i0": np.asarray(-2, np.int64), "iv": i64(2, -1, 0)},
            None, 11, ["g0", "g1", "g2"]),
        "shape_chain_reshape": (
            [N("Shape", ["x"], ["s"]),
             N("Constant", [], ["k0"], value=i64(0)),
             N("Gather", ["s", "k0"], ["b"], axis=0),
             N("Squeeze", ["b"], ["b0"], axes=[0]),
             N("Unsqueeze", ["b0"], ["bu"], axes=[0]),
             N("Constant", [], ["m1"], value=i64(-1)),
             N("Concat", ["bu", "m1"], ["t"], axis=0),
             N("Reshape", ["x", "t"], ["y"])], {}),
        "reshape_zero_copies_dim": (
            [N("Reshape", ["x", "t"], ["y"])], {"t": i64(0, 2, -1, 9)}),
    }


def _logic(rng):
    return {
        "where_equal_greater_less": (
            [N("Greater", ["x", "zero"], ["g"]),
             N("Less", ["x", "half"], ["l"]),
             N("Equal", ["g", "l"], ["e"]),
             N("Neg", ["x"], ["n"]),
             N("Where", ["e", "x", "n"], ["y"])],
            {"zero": np.zeros((1,), np.float32),
             "half": np.asarray(0.5, np.float32)}),
        "constantofshape_range_cast": (
            [N("Shape", ["x"], ["s"]),
             N("ConstantOfShape", ["s"], ["cs"],
               value=np.asarray([1.5], np.float32)),
             N("Constant", [], ["r0"], value=np.asarray(0.0, np.float32)),
             N("Constant", [], ["r1"], value=np.asarray(9.0, np.float32)),
             N("Constant", [], ["r2"], value=np.asarray(1.0, np.float32)),
             N("Range", ["r0", "r1", "r2"], ["r"]),
             N("Cast", ["r"], ["rc"], to=1),
             N("Reshape", ["rc", "rs"], ["rr"]),
             N("Mul", ["x", "cs"], ["m"]),
             N("Add", ["m", "rr"], ["y"]),
             N("Mul", ["x", "three"], ["x3"]),
             N("Cast", ["x3"], ["xi"], to=6),
             N("Cast", ["xi"], ["y2"], to=1)],
            {"rs": i64(1, 1, 1, 9), "three": np.asarray(3.0, np.float32)},
            None, 11, ["y", "y2"]),
        "constant_node_operand": (
            [N("Constant", [], ["c"], value=c4([0.5, -1.0, 2.0, 0.25])),
             N("Mul", ["x", "c"], ["y"])], {}),
    }


def _reductions(rng):
    return {
        "softmax_reduce_axes_attr": (
            [N("Softmax", ["x"], ["a"], axis=1),
             N("ReduceMean", ["x"], ["b"], axes=[2, 3], keepdims=1),
             N("ReduceSum", ["x"], ["c"], axes=[1], keepdims=0)], {},
            None, 11, ["a", "b", "c"]),
        "reduce_axes_input": (
            [N("ReduceSum", ["x", "ax"], ["a"], keepdims=0),
             N("ReduceMean", ["x", "ax"], ["b"])], {"ax": i64(2, 3)},
            None, 13, ["a", "b"]),
        "softmax_default_axis_reduce_all": (
            [N("Softmax", ["x"], ["a"]),
             N("ReduceMean", ["a"], ["b"], keepdims=1),
             N("Add", ["a", "b"], ["y"])], {}),
    }


def _dense(rng):
    return {
        "gemm_trans_alpha_beta": (
            [N("Flatten", ["x"], ["f"]),
             N("Transpose", ["f"], ["t"], perm=[1, 0]),
             N("Gemm", ["t", "w", "c"], ["y"], transA=1, transB=1,
               alpha=0.5, beta=2.0)],
            {"w": f32(rng, 5, 324, scale=0.1), "c": f32(rng, 5)}),
        "gemm_plain": ([N("Flatten", ["x"], ["f"]),
                        N("Gemm", ["f", "w", "c"], ["y"])],
                       {"w": f32(rng, 324, 5, scale=0.1),
                        "c": f32(rng, 1, 5)}),
        "matmul": ([N("Reshape", ["x", "t"], ["r"]),
                    N("MatMul", ["r", "w"], ["y"])],
                   {"t": i64(2, 4, 81), "w": f32(rng, 81, 3, scale=0.1)}),
    }


def _norms(rng):
    return {
        "gn_idiom": (
            [N("Reshape", ["x", "g"], ["r"]),
             N("InstanceNormalization", ["r", "s", "bb"], ["n"],
               epsilon=1e-5),
             N("Shape", ["x"], ["xs"]),
             N("Reshape", ["n", "xs"], ["nr"]),
             N("Mul", ["nr", "gamma"], ["m"]),
             N("Add", ["m", "beta"], ["y"])],
            {"g": i64(0, 2, -1), "s": np.ones(2, np.float32),
             "bb": np.zeros(2, np.float32),
             "gamma": f32(rng, 4, 1, 1), "beta": f32(rng, 4, 1, 1)}),
        "batchnorm_map_and_flat": (
            [N("BatchNormalization", ["x", "s", "b", "m", "v"], ["a"],
               epsilon=1e-3),
             N("GlobalAveragePool", ["a"], ["g"]),
             N("Flatten", ["g"], ["f"]),
             N("BatchNormalization", ["f", "s", "b", "m", "v"], ["y"])],
            {"s": f32(rng, 4), "b": f32(rng, 4), "m": f32(rng, 4),
             "v": np.abs(f32(rng, 4)) + 0.5}, None, 11, ["a", "y"]),
        "prelu": ([N("PRelu", ["x", "s"], ["y"])], {"s": f32(rng, 4, 1, 1)}),
    }


UNARY = {"Relu": {}, "LeakyRelu": {"alpha": 0.1}, "Sigmoid": {}, "Exp": {},
         "Tanh": {}, "Neg": {}, "Abs": {}, "Softplus": {}, "Erf": {},
         "HardSigmoid": {"alpha": 0.3, "beta": 0.4}, "HardSwish": {},
         "Identity": {}, "Dropout": {}}


def _activations(rng):
    cases = {f"unary_{op.lower()}": ([N(op, ["x"], ["y"], **a)], {})
             for op, a in UNARY.items()}
    cases["unary_sqrt"] = ([N("Abs", ["x"], ["a"]),
                            N("Sqrt", ["a"], ["y"])], {})
    cases["clip_attrs_opset6"] = ([N("Clip", ["x"], ["y"], min=-0.5,
                                     max=0.75)], {}, None, 6)
    cases["clip_inputs"] = ([N("Clip", ["x", "lo", "hi"], ["y"])],
                            {"lo": np.asarray(-0.25, np.float32),
                             "hi": np.asarray(1.0, np.float32)})
    cases["clip_max_only"] = ([N("Clip", ["x", "", "hi"], ["y"])],
                              {"hi": np.asarray(0.3, np.float32)})
    return cases


def _binary(rng):
    cases = {}
    for op in ("Add", "Sub", "Mul", "Div", "Pow", "Min", "Max"):
        base = "x"
        nodes = []
        if op == "Pow":
            nodes = [N("Abs", ["x"], ["ax"]), N("Add", ["ax", "h"], ["x1"])]
            base = "x1"
        nodes += [N(op, [base, "cc"], ["a"]),         # per channel, (1,C,1,1)
                  N(op, ["cr", base], ["b"]),         # (C, 1, 1): promoted
                  N(op, [base, "cs"], ["d"]),         # scalar
                  N("Relu", ["a"], ["ra"]),
                  N(op, ["ra", "d"], ["e"]),          # two maps
                  N("Concat", ["e", "b"], ["y"], axis=1)]
        cases[f"binary_{op.lower()}"] = (nodes, {
            "cc": c4([0.5, 1.5, 0.75, 2.0]),
            "cr": np.asarray([1.25, 0.6, 1.8, 0.9], np.float32).reshape(
                4, 1, 1),
            "cs": np.asarray(1.3, np.float32),
            "h": np.asarray(0.5, np.float32)})
    cases["concat_axes"] = ([N("Relu", ["x"], ["r"]),
                             N("Concat", ["x", "r"], ["a"], axis=1),
                             N("Concat", ["x", "x"], ["b"], axis=3)], {},
                            None, 11, ["a", "b"])
    return cases


def op_cases():
    """name -> (nodes, initializers, error or None, opset, outputs)."""
    rng = np.random.default_rng(0)
    out = {}
    for group in (_conv, _pools, _resize, _shapes, _logic, _reductions,
                  _dense, _norms, _activations, _binary):
        for name, case in group(rng).items():
            case = tuple(case) + (None, 11, ["y"])[len(case) - 2:]
            out[name] = case
    out["unknown_op_refused"] = ([N("Atan", ["x"], ["y"])], {},
                                 texec.UnsupportedOp, 11, ["y"])
    out["argmax_refused"] = ([N("ArgMax", ["x"], ["y"], axis=1)], {},
                             texec.UnsupportedOp, 11, ["y"])
    return out


OP_CASES = op_cases()
X_SHAPE = {"pool_ceil_mode_same_size": (2, 4, 9, 9)}


def case_graph(tmp_path, name):
    nodes, inits, _, opset, outs = OP_CASES[name]
    path = str(tmp_path / f"{name}.onnx")
    with open(path, "wb") as f:
        f.write(encode_model(nodes, inits, ["x"], outs, opset=opset))
    return path


def case_ops(name):
    from scrfd_arcface_facerecognition_tpu_torch.models.onnx_proto import (
        _parse_node)
    return {_parse_node(n).op_type for n in OP_CASES[name][0]}


def test_supported_ops_equal_jax():
    assert texec.SUPPORTED_OPS == jexec.SUPPORTED_OPS
    assert len(texec.SUPPORTED_OPS) == 55


def test_every_supported_op_has_a_case():
    covered = set()
    for name, case in OP_CASES.items():
        if case[2] is None:
            covered |= case_ops(name)
    assert not texec.SUPPORTED_OPS - covered, sorted(
        texec.SUPPORTED_OPS - covered)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_case_matches_jax(tmp_path, name):
    path = case_graph(tmp_path, name)
    x = f32(np.random.default_rng(zlib.crc32(name.encode())),
            *X_SHAPE.get(name, (2, 4, 9, 9)))
    error = OP_CASES[name][2]
    if error is not None:
        with pytest.raises(jexec.UnsupportedOp):
            jax_run(path, x)
        with pytest.raises(error):
            port_run(path, x)
        return
    want, got = jax_run(path, x), port_run(path, x)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        assert_close(g, w, what=f"{name} output {i}")


def test_seams_export_matches_jax(tmp_path):
    """The GroupNorm export idiom, nearest resize, the NCHW flatten and
    Gemm, as torch exports them (``tests/test_onnx_exec.py``'s Seams)."""
    import torch.nn as nn
    import torch.nn.functional as F

    class Seams(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(3, 16, 3, 2, 1)
            self.gn = nn.GroupNorm(4, 16)
            self.c2 = nn.Conv2d(16, 8, 1)
            self.fc = nn.Linear(8 * 16 * 16, 10)

        def forward(self, x):
            y = F.relu(self.gn(self.c1(x)))
            y = F.interpolate(y, scale_factor=2.0, mode="nearest")
            return self.fc(torch.flatten(self.c2(y), 1))

    m = seeded(Seams(), 1)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "seams.onnx")
    export_onnx(m, x, path)
    with torch.no_grad():
        ref = m(x).numpy()
    got = port_run(path, x.numpy())[0]
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    assert_close(got, jax_run(path, x.numpy())[0])


def test_warm_forward_copies_no_constant(tmp_path, monkeypatch):
    """A warm forward reuses the device copies of its numpy constants (on
    the card a copy from the host would make the forward wait): the
    second call of the same shape converts nothing from numpy."""
    path = case_graph(tmp_path, "constantofshape_range_cast")
    m = texec.onnx_model(path, device="cpu")
    x = torch.from_numpy(f32(np.random.default_rng(1), 2, 4, 9, 9))
    first = m(x)
    calls = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: calls.append(a.shape) or real(a))
    second = m(x)
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# --------------------------------------------------------------- fuzz


@pytest.mark.parametrize("seed", range(24))
def test_random_program_matches_torch_and_jax(tmp_path, seed):
    from test_onnx_exec_fuzz import RandomNet

    net = seeded(RandomNet(seed), seed + 100)
    x = torch.randn(2, 3, 16, 16,
                    generator=torch.Generator().manual_seed(seed + 200))
    path = str(tmp_path / f"fuzz_{seed}.onnx")
    export_onnx(net, x, path)
    with torch.no_grad():
        ref = net(x).numpy()
    got = port_run(path, x.numpy())[0]
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=2e-3)
    assert_close(got, jax_run(path, x.numpy())[0], scale=2e-6,
                 what=f"seed {seed} against the JAX executor")


# ----------------------------------------------------- the small models


SMALL_DET = dict(stem=8, blocks=(1, 1, 1, 1), planes=(8, 8, 16, 16), neck=8,
                 head_feat=16, head_stacks=1)
SMALL_REC = dict(blocks=(1, 1, 1, 1), planes=(8, 8, 16, 16))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small SCRFD and iResNet of ``tests/test_onnx_exec.py`` (the
    detector calibrated), the iResNet at 32 and at 512 embedding widths
    (the pipelines' galleries are 512 wide)."""
    d = tmp_path_factory.mktemp("small")
    out = {"det": str(d / "det.onnx"), "rec": str(d / "rec.onnx"),
           "rec512": str(d / "rec512.onnx")}
    export_onnx(calibrate_detector(seeded(TorchSCRFD(**SMALL_DET), 0)),
                torch.randn(1, 3, 640, 640), out["det"])
    export_onnx(seeded(TorchIResNet(emb=32, **SMALL_REC), 0),
                torch.randn(1, 3, 112, 112), out["rec"])
    export_onnx(seeded(TorchIResNet(emb=512, **SMALL_REC), 1),
                torch.randn(1, 3, 112, 112), out["rec512"])
    return out


def test_small_models_match_jax_at_f32(small):
    rng = np.random.default_rng(7)
    for key, shape in (("det", (2, 3, 96, 160)), ("rec", (3, 3, 112, 112))):
        x = f32(rng, *shape)
        want, got = jax_run(small[key], x), port_run(small[key], x)
        assert len(got) == len(want) == (9 if key == "det" else 1)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, what=f"{key} output {i}")


def test_trace_shapes_equal_jax(small):
    for key, shape in (("det", (2, 3, 96, 160)), ("rec", (1, 3, 112, 112))):
        nhwc = (shape[0], shape[2], shape[3], shape[1])
        want = {k: tuple(s) for k, (_, s) in
                jexec.onnx_model(small[key]).trace_shapes(nhwc).items()}
        got = texec.onnx_model(small[key], device="cpu").trace_shapes(shape)
        assert got == want


def test_graph_modules_match_jax(small):
    from scrfd_arcface_facerecognition_tpu.models import graph_models as jgm

    rng = np.random.default_rng(8)
    x = f32(rng, 2, 3, 64, 96)
    jd = jgm.scrfd_from_onnx(small["det"])
    want = jd.apply(jd.variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    td = tgm.scrfd_from_onnx(small["det"], device="cpu")
    with torch.inference_mode():
        got = td(torch.from_numpy(x))
    for key in ("scores", "bboxes", "kps"):
        for li in range(3):
            assert_close(got[key][li].numpy(), np.asarray(want[key][li]),
                         what=f"{key} {li}")
    with pytest.raises(ValueError, match="9-output contract"):
        td._classify([(2, 7, 1)] * 9, (64, 96))
    x = f32(rng, 4, 3, 112, 112)
    je = jgm.arcface_from_onnx(small["rec"])
    want = np.asarray(je.apply(je.variables,
                               jnp.asarray(x.transpose(0, 2, 3, 1))))
    te = tgm.arcface_from_onnx(small["rec"], device="cpu")
    with torch.inference_mode():
        got = te(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and te.emb_dim() == 32
    assert_close(got, want)


def _job_models_bf16(det, rec, xd, xr):
    res = {}
    for key, path, x in (("det", det, xd), ("rec", rec, xr)):
        for i, o in enumerate(jax_run(str(path), x, jnp.bfloat16)):
            res[f"{key}{i}"] = o
    return res


def test_small_models_match_jax_at_bf16(small):
    rng = np.random.default_rng(9)
    xd, xr = f32(rng, 2, 3, 96, 160), f32(rng, 4, 3, 112, 112)
    ref = jax_reference("test_torch_onnx_exec", "models_bf16",
                        det=np.asarray(small["det"]),
                        rec=np.asarray(small["rec"]), xd=xd, xr=xr)
    got = port_run(small["det"], xd, torch.bfloat16)
    for i, g in enumerate(got):
        w = ref[f"det{i}"]
        if i < 3:                                    # the scores
            ws = np.clip(w.astype(np.float64), 1e-12, 1 - 1e-12)
            tol = score_tol(w, np.abs(np.log(ws / (1 - ws))).max())
        else:
            tol = 2 * bf16_ulp(np.abs(w).max())
        assert (np.abs(g - w) <= tol).all(), (i, float(np.abs(g - w).max()))
    g = port_run(small["rec"], xr, torch.bfloat16)[0]
    w = ref["rec0"]
    cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1)
                            * np.linalg.norm(w, axis=1))
    assert cos.min() >= 0.9999, cos
    # and the port's bf16 is not its float32
    assert np.abs(g - port_run(small["rec"], xr)[0]).max() > 0


# ------------------------------------------- Detector, Embedder, pipeline


def test_detector_and_embedder_from_onnx_match_jax(small):
    from scrfd_arcface_facerecognition_tpu.pipeline import (
        Detector as JDetector, Embedder as JEmbedder)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector as TDetector, Embedder as TEmbedder)

    kw = dict(input_size=(320, 320), conf_thres=0.5, pre_nms=32, max_det=8)
    jd = JDetector(onnx_path=small["det"], **kw)
    td = TDetector(onnx_path=small["det"], device="cpu", **kw)
    assert isinstance(td.model, tgm.SCRFDGraphModule)
    img = np.random.default_rng(10).integers(0, 255, (240, 300, 3), np.uint8)
    (wd, wk), (gd, gk) = jd.detect(img), td.detect(img)
    assert len(gd) == len(wd) > 0
    np.testing.assert_allclose(gd[:, :4], wd[:, :4], atol=1e-2, rtol=0)
    np.testing.assert_allclose(gd[:, 4], wd[:, 4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(gk, wk, atol=1e-2, rtol=0)
    je = JEmbedder(onnx_path=small["rec"])
    te = TEmbedder(onnx_path=small["rec"], device="cpu")
    assert te.emb_dim == 32 and isinstance(te.model, tgm.ArcFaceGraphModule)
    w, g = je(img, wk[0]), te(img, gk[0])
    assert float(w @ g / np.linalg.norm(w) / np.linalg.norm(g)) >= 0.9999


def test_variables_and_onnx_path_together_raise(small):
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)

    with pytest.raises(ValueError, match="not both"):
        Detector(variables={}, onnx_path=small["det"], device="cpu")
    with pytest.raises(ValueError, match="not both"):
        Embedder(variables={}, onnx_path=small["rec"], device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        Detector(onnx_path=small["det"], dtype=torch.float16, device="cpu")


def _pipelines(small, jdtype, tdtype, **kw):
    from scrfd_arcface_facerecognition_tpu.pipeline import (
        FacePipeline as JPipeline)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        FacePipeline as TPipeline)

    kw = dict(conf_thres=0.5, max_det=6, pre_nms=32, gallery_capacity=8,
              similarity_thresh=0.3, **kw)
    return (JPipeline(det_onnx=small["det"], rec_onnx=small["rec512"],
                      dtype=jdtype, use_pallas_warp=False, **kw)
            if jdtype is not None else None,
            TPipeline(det_onnx=small["det"], rec_onnx=small["rec512"],
                      dtype=tdtype, device="cpu", **kw))


def pipeline_frames(n=3, h=240, w=320):
    return np.random.default_rng(11).integers(0, 255, (n, h, w, 3), np.uint8)


def test_face_pipeline_from_onnx_matches_jax_at_f32(small):
    jp, tp = _pipelines(small, jnp.float32, torch.float32)
    frames = pipeline_frames()
    first = tp(frames, max_num=4)
    gal = first.embeddings.numpy()[first.valid.numpy()][::3]
    assert len(gal) > 0
    for p in (jp, tp):
        p.set_gallery(gal, [f"g{i}" for i in range(len(gal))])
    want, got = jp(jnp.asarray(frames), max_num=4), tp(frames, max_num=4)
    for f in ("valid", "count", "match_idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f, tol in (("boxes", 1e-2), ("kps", 1e-2), ("scores", 1e-4),
                   ("match_sim", 1e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=tol,
                                   rtol=0, err_msg=f)
    v = got.valid.numpy()
    a, b = got.embeddings.numpy()[v], np.asarray(want.embeddings)[v]
    assert ((a * b).sum(1) >= 0.9999).all()
    assert int((got.match_idx >= 0).sum()) > 0
    # process_stream(depth) and the staging take the graph models too
    outs = list(tp.process_stream([frames, frames[::-1].copy()], max_num=4,
                                  depth=2))
    assert torch.equal(outs[0].valid, got.valid)
    assert torch.equal(outs[1].valid, got.valid.flip(0))


def _job_pipeline_bf16(det, rec512, frames, gallery):
    from scrfd_arcface_facerecognition_tpu.pipeline import (
        FacePipeline as JPipeline)
    from test_torch_bf16 import output_arrays, pipeline_cuts

    jp = JPipeline(det_onnx=str(det), rec_onnx=str(rec512),
                   dtype=jnp.bfloat16, use_pallas_warp=False,
                   conf_thres=0.5, max_det=6, pre_nms=32,
                   gallery_capacity=8, similarity_thresh=0.3)
    jp.set_gallery(gallery, [f"g{i}" for i in range(len(gallery))])
    return dict(output_arrays(jp(jnp.asarray(frames), max_num=4)),
                cut=pipeline_cuts(jp, frames))


def test_face_pipeline_from_onnx_matches_jax_at_bf16(small):
    from scrfd_arcface_facerecognition_tpu_torch.ops import (
        tight_letterbox_plan)

    _, tp = _pipelines(small, None, torch.bfloat16)
    frames = pipeline_frames()
    first = tp(frames, max_num=4)
    gal = first.embeddings.numpy()[first.valid.numpy()][::3]
    tp.set_gallery(gal, [f"g{i}" for i in range(len(gal))])
    ref = jax_reference("test_torch_onnx_exec", "pipeline_bf16",
                        det=np.asarray(small["det"]),
                        rec512=np.asarray(small["rec512"]), frames=frames,
                        gallery=gal)
    got = tp(frames, max_num=4)
    assert got.embeddings.dtype == torch.float32
    scale = tight_letterbox_plan(frames.shape[1:3], (640, 640)).det_scale
    lone, pairs = 0, 0
    for b in range(len(frames)):
        want = [(ref["boxes"][b, k], float(ref["scores"][b, k]),
                 ref["kps"][b, k]) for k in np.flatnonzero(ref["valid"][b])]
        gv = got.valid[b].numpy()
        have = [(got.boxes[b, k].numpy(), float(got.scores[b, k]),
                 got.kps[b, k].numpy()) for k in np.flatnonzero(gv)]
        pr, n = match_detections(want, have, conf=0.5,
                                 cut=float(ref["cut"][b]), iou_thres=0.4,
                                 det_scale=scale, where=b)
        lone, pairs = lone + n, pairs + len(pr)
        wk, gk = np.flatnonzero(ref["valid"][b]), np.flatnonzero(gv)
        for i, j in pr:
            x, y = ref["embeddings"][b, wk[i]], got.embeddings[b, gk[j]]
            y = y.numpy()
            assert float(x @ y / np.linalg.norm(x) / np.linalg.norm(y)
                         ) >= 0.999
    assert pairs > 0 and lone <= 2, (pairs, lone)


# --------------------------------------------- the importer, the facade


def test_executor_agrees_with_the_imported_native_models(tmp_path):
    """On the det_500m and w600k_mbf stand-ins, the graph through the
    executor and the native model loaded by ``variables_from_onnx`` give
    the same outputs (float32: rtol 1e-4 of the output's scale; the
    embedding cosine >= 0.99999)."""
    from scrfd_arcface_facerecognition_tpu_torch.models.arcface import (
        arcface_from_config)
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import SCRFDNet
    from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
        load_flax_variables)

    rng = np.random.default_rng(12)
    for name, side, shape in (("det_500m", 320, (2, 3, 160, 224)),
                              ("w600k_mbf", 112, (3, 3, 112, 112))):
        tm = seeded(STAND_INS[name](), zlib.crc32(name.encode()) % 1000)
        if name.startswith("det"):
            tm = calibrate_detector(tm)
        path = str(tmp_path / f"{name}.onnx")
        export_onnx(tm, torch.randn(1, 3, side, side), path)
        cfg, tree = variables_from_onnx(path, name=name,
                                        input_size=(side, side))
        native = (SCRFDNet(cfg) if name.startswith("det")
                  else arcface_from_config(cfg))
        native = load_flax_variables(native, tree).eval()
        x = torch.from_numpy(f32(rng, *shape))
        with torch.inference_mode():
            if name.startswith("det"):
                want = native(x)
                got = tgm.scrfd_from_onnx(path, device="cpu")(x)
                for key in ("scores", "bboxes", "kps"):
                    for g, w in zip(got[key], want[key]):
                        w = w.numpy()
                        np.testing.assert_allclose(
                            g.numpy(), w, rtol=0,
                            atol=1e-4 * np.abs(w).max(), err_msg=key)
            else:
                want = native(x).numpy()
                got = tgm.arcface_from_onnx(path, device="cpu")(x).numpy()
                cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                             * np.linalg.norm(want, axis=1))
                assert cos.min() >= 0.99999, cos


def facade_images():
    rng = np.random.default_rng(13)
    images = list(rng.integers(0, 255, (8, 120, 160, 3), np.uint8))
    images += [rng.integers(0, 255, (h, w, 3), np.uint8)
               for h, w in ((100, 140), (150, 110))]
    return images


def test_face_analysis_from_onnx_matches_jax(small):
    from scrfd_arcface_facerecognition_tpu.apps.face_analysis import (
        FaceAnalysis as JFaceAnalysis)
    from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
        FaceAnalysis as TFaceAnalysis)

    kw = dict(det_onnx=small["det"], rec_onnx=small["rec512"], max_det=4)
    ja = JFaceAnalysis(dtype=jnp.float32, **kw)
    ta = TFaceAnalysis(device="cpu", **kw)
    assert ta.dtype == torch.float32
    for a in (ja, ta):
        a.prepare(det_size=(256, 256), det_thresh=0.5)
    images = facade_images()
    want, got = ja.get_batch(images), ta.get_batch(images)
    assert sum(len(f) for f in got) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g), i
        for a, b in zip(w, g):
            np.testing.assert_allclose(b.bbox, a.bbox, atol=1e-2, rtol=0)
            np.testing.assert_allclose(b.kps, a.kps, atol=1e-2, rtol=0)
            assert abs(b.det_score - a.det_score) <= 1e-4
            assert float(np.asarray(a.normed_embedding)
                         @ b.normed_embedding) >= 0.9999


# --------------------------------------------------------- preflight


def test_preflight_classifies_like_jax(tmp_path):
    from scrfd_arcface_facerecognition_tpu.models.preflight import (
        ReleaseFileError as JError, preflight_graph as jpre)
    from test_verify_release_negative import CLASSES, _conv_graph, _make_bad

    cases = [(kind, _make_bad(kind, str(tmp_path / f"{kind}_det_500m.onnx")),
              CLASSES[kind][1]) for kind in sorted(CLASSES)]
    cases.append(("wrong_graph_kind", _conv_graph(
        str(tmp_path / "w600k_r50.onnx"), n_outputs=6), "rec"))
    cases.append(("config_inference_failed", _conv_graph(
        str(tmp_path / "mbf.onnx"), group=4), "rec"))
    kinds = set()
    for kind, path, expect in cases:
        with pytest.raises(JError) as je:
            jpre(path, expect)
        with pytest.raises(tpre.ReleaseFileError) as te:
            tpre.preflight_graph(path, expect)
        assert te.value.kind == je.value.kind == kind, (kind, str(te.value))
        assert kind in str(te.value)
        kinds.add(kind)
    assert len(kinds) == 8


def test_preflight_passes_a_stand_in(small):
    facts = tpre.preflight_graph(small["det"], "det")
    assert facts["family"] == "scrfd" and facts["n_outputs"] == 9
    assert tpre.preflight_graph(small["rec"], "rec")["n_outputs"] == 1


# ---------------------------------------------------------- full width


@pytest.mark.slow
def test_full_width_stand_ins_match_jax(tmp_path):
    """det_10g at 640 and w600k_r50 at 112, the stand-ins, at float32."""
    rng = np.random.default_rng(14)
    for name, side in (("det_10g", 640), ("w600k_r50", 112)):
        tm = seeded(STAND_INS[name](), zlib.crc32(name.encode()) % 1000)
        if name.startswith("det"):
            tm = calibrate_detector(tm)
        path = str(tmp_path / f"{name}.onnx")
        export_onnx(tm, torch.randn(1, 3, side, side), path)
        x = f32(rng, 2, 3, side, side, scale=0.5)
        for i, (g, w) in enumerate(zip(port_run(path, x), jax_run(path, x))):
            assert_close(g, w, rtol=1e-4, scale=1e-5,
                         what=f"{name} output {i}")
