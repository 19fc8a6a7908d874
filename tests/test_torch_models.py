"""Port models vs the Flax reference, weights carried across (CPU).

A Flax variables tree (a seeded Flax init, or a committed trained
checkpoint) is loaded into the JAX model and, through the port's weights
module, into the PyTorch model; both see the same seeded numpy input.
Tolerances: f32 outputs within rtol 1e-4 of the output scale, embedding
cosine >= 0.99999.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.models import arcface as jarc
from scrfd_arcface_facerecognition_tpu.models import scrfd as jscrfd
from scrfd_arcface_facerecognition_tpu.models.init_utils import cpu_init
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as tarc
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as tscrfd
from scrfd_arcface_facerecognition_tpu_torch.models import (
    load_flax_variables, seeded_init_, state_dict_from_flax)
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


def _np_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _check_detector(jmodel, jvars, tmodel, hw, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.eval()(_nchw(x))
    for key in ("scores", "bboxes", "kps"):
        assert len(got[key]) == len(want[key]) == 3
        for g, w in zip(got[key], want[key]):
            assert tuple(g.shape) == w.shape, key
            _close(g.numpy(), np.asarray(w))


def _check_embedder(jmodel, jvars, tmodel, seed=1):
    x = np.random.default_rng(seed).normal(size=(3, 112, 112, 3)
                                           ).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.eval()(_nchw(x)).numpy()
    assert got.shape == want.shape
    _close(got, want)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999, cos


def test_reduced_scrfd_seeded_flax_init():
    cfg = jscrfd.SCRFDConfig(**_TINY_DET)
    jm = jscrfd.SCRFDNet(cfg)
    jv = _np_tree(cpu_init(jm, 0, (1, 64, 96, 3)))
    tm = load_flax_variables(tscrfd.SCRFDNet(tscrfd.SCRFDConfig(**_TINY_DET)),
                             jv)
    _check_detector(jm, jv, tm, (64, 96))


def test_reduced_scrfd_s2d_stem_carried_to_plain_stem():
    """A space-to-depth stem tree (2, 2, 12, C) loads into the plain 3x3
    stem exactly: the JAX s2d model and the port agree."""
    plain = jscrfd.SCRFDNet(jscrfd.SCRFDConfig(**_TINY_DET))
    jv = _np_tree(cpu_init(plain, 3, (1, 64, 64, 3)))
    k = jv["params"]["backbone"]["stem1"]["conv"]["kernel"]
    jv["params"]["backbone"]["stem1"]["conv"]["kernel"] = (
        jscrfd.stem_kernel_to_s2d(k))
    s2d = jscrfd.SCRFDNet(jscrfd.SCRFDConfig(**_TINY_DET, s2d_stem=True))
    tm = load_flax_variables(tscrfd.SCRFDNet(tscrfd.SCRFDConfig(**_TINY_DET)),
                             jv)
    np.testing.assert_array_equal(
        tm.backbone.stem1.conv.weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    _check_detector(s2d, jv, tm, (64, 64), seed=4)


def test_s2d_stem_with_weight_outside_scatter_is_refused():
    w = np.zeros((2, 2, 12, 4), np.float32)
    w[0, 0, 0] = 1.0                      # a slot the 3x3 scatter never uses
    with pytest.raises(ValueError, match="no exact plain-stem"):
        tscrfd.s2d_kernel_to_stem(w)


def test_reduced_iresnet_seeded_flax_init():
    jm = jarc.IResNet(jarc.ArcFaceConfig(**_TINY_R))
    jv = _np_tree(cpu_init(jm, 1, (1, 112, 112, 3)))
    tm = load_flax_variables(tarc.IResNet(tarc.ArcFaceConfig(**_TINY_R)), jv)
    _check_embedder(jm, jv, tm)


def test_reduced_mobilefacenet_seeded_flax_init():
    jm = jarc.MobileFaceNet(jarc.ArcFaceConfig(**_TINY_MBF))
    jv = _np_tree(cpu_init(jm, 2, (1, 112, 112, 3)))
    # identity-BN random init shrinks activations to ~1e-6: give the BNs
    # random statistics so the comparison sees realistic magnitudes
    rng = np.random.default_rng(0)
    jv["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        jv["batch_stats"])
    tm = load_flax_variables(
        tarc.MobileFaceNet(tarc.ArcFaceConfig(**_TINY_MBF)), jv)
    _check_embedder(jm, jv, tm)


def _msgpack(name):
    from flax import serialization

    with open(os.path.join(_CKPT, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_trained_det_500m_checkpoint():
    jv = _msgpack("det_500m.msgpack")
    jm = jscrfd.build_scrfd("det_500m")
    tm = load_flax_variables(tscrfd.build_scrfd("det_500m"), jv)
    _check_detector(jm, jv, tm, (96, 128), seed=5)


def test_trained_w600k_mbf_checkpoint():
    jv = _msgpack("w600k_mbf.msgpack")
    jm = jarc.build_arcface("w600k_mbf")
    tm = load_flax_variables(tarc.build_arcface("w600k_mbf"), jv)
    _check_embedder(jm, jv, tm, seed=6)


def test_weights_module_layouts():
    """Conv HWIO -> OIHW (grouped too), Dense transpose, BN/GN names,
    PReLU alpha and head scales, checked key by key."""
    jv = _msgpack("w600k_mbf.msgpack")
    sd = state_dict_from_flax(jv)
    dw = jv["params"]["stem_dw"]["conv"]["kernel"]          # grouped (3,3,2,128)
    np.testing.assert_array_equal(sd["stem_dw.conv.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  jv["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(sd["features_bn.running_var"].numpy(),
                                  jv["batch_stats"]["features_bn"]["var"])
    np.testing.assert_array_equal(sd["stem.prelu.alpha"].numpy(),
                                  jv["params"]["stem"]["prelu"]["alpha"])
    dv = _msgpack("det_500m.msgpack")
    sd = state_dict_from_flax(dv)
    np.testing.assert_array_equal(sd["head.scale1"].numpy(),
                                  dv["params"]["head"]["scale1"])
    np.testing.assert_array_equal(sd["head.tower0.gn.weight"].numpy(),
                                  dv["params"]["head"]["tower0"]["gn"]["scale"])


def test_seeded_init_is_deterministic_with_reference_distributions():
    cfg = tarc.ArcFaceConfig(**_TINY_R)
    a = seeded_init_(tarc.IResNet(cfg), seed=7).state_dict()
    b = seeded_init_(tarc.IResNet(cfg), seed=7).state_dict()
    c = seeded_init_(tarc.IResNet(cfg), seed=8).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["stem_conv.weight"], c["stem_conv.weight"])
    assert torch.equal(a["stem_bn.running_var"], torch.ones(8))
    assert torch.equal(a["stem_bn.weight"], torch.ones(8))
    assert torch.equal(a["stem_prelu.alpha"], torch.full((8,), 0.25))
    assert torch.equal(a["fc.bias"], torch.zeros(32))
    w = a["layer4_block0.conv1.weight"]                     # (32, 16, 3, 3)
    assert abs(float(w.std()) - np.sqrt(2.0 / (32 * 9))) < 0.02
    det = seeded_init_(tscrfd.SCRFDNet(tscrfd.SCRFDConfig(**_TINY_DET)), 0)
    assert float(det.head.scale2.detach()) == 1.0
    assert torch.equal(det.head.tower0.gn.weight, torch.ones(16))


@pytest.mark.slow
def test_full_width_det_10g_and_w600k_r50():
    """Full-width det_10g + w600k_r50 with seeded Flax init carried across."""
    jm = jscrfd.build_scrfd("det_10g")
    jv = _np_tree(cpu_init(jm, 0, (1, 128, 160, 3)))
    tm = load_flax_variables(tscrfd.build_scrfd("det_10g"), jv)
    _check_detector(jm, jv, tm, (128, 160))
    jm = jarc.build_arcface("w600k_r50")
    jv = _np_tree(cpu_init(jm, 0, (1, 112, 112, 3)))
    tm = load_flax_variables(tarc.build_arcface("w600k_r50"), jv)
    _check_embedder(jm, jv, tm)
