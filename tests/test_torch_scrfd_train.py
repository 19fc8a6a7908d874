"""The port's SCRFD trainer against the JAX package's, on the CPU.

The tiny detector and the 64 x 64 loss configuration of
``tests/test_scrfd_train.py``; seeded batches of 2 images, up to 3 faces
each. Both trainers start from one state: the JAX ``init_state`` carried
across with ``scrfd_train_state_from_jax``; the JAX trainer runs on a
one-device mesh.

Held here: the box geometry and the three losses with their gradients,
ties included, within 1e-6 (1e-5 on gradients); the anchors and
``atss_assign`` equal, index for index; ``scrfd_loss`` and its metrics
within 1e-6 relative at float32 on the same head outputs;
``synthetic_detection_batch`` bit-equal; the JAX trainer's initializers;
the state carried from JAX; the float32 first step's loss within 1e-5;
a checkpoint that serves as the trained module; the overfit. The steps
in float64 are ``tests/test_torch_scrfd_steps.py``'s.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.models.scrfd import (
    SCRFDConfig as JConfig, SCRFDNet as JSCRFDNet)
from scrfd_arcface_facerecognition_tpu.parallel import make_mesh
from scrfd_arcface_facerecognition_tpu.train import scrfd_train as JS
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS
from scrfd_arcface_facerecognition_tpu_torch.models.checkpoints import (
    load_inference_variables)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    scrfd_train_state_from_jax, state_dict_from_flax)
from scrfd_arcface_facerecognition_tpu_torch import train as TT
from scrfd_arcface_facerecognition_tpu_torch.train import scrfd_train as TST
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

TINY = dict(name="tiny", stem_filters=8, stage_blocks=(1, 1, 1, 1),
            stage_filters=(8, 8, 16, 16), neck_filters=8, head_stacks=1,
            head_filters=16)
SIZE = (64, 64)
CFG_J = JS.SCRFDLossConfig(input_size=SIZE)
CFG_T = TST.SCRFDLossConfig(input_size=SIZE)

CASES = {
    "constant": dict(learning_rate=0.05),
    "warmup": dict(learning_rate=0.05, warmup_steps=2),
    "unlabeled": dict(learning_rate=0.05),
}


def _batch(case="constant", seed=0, dtype=np.float32):
    """(images NHWC, gt_boxes, gt_kps, gt_valid, gt_kps_valid or None): a
    seeded ``synthetic_detection_batch`` of 2 images; the "unlabeled" case
    marks some faces' landmarks as unlabeled."""
    images, boxes, kps, valid = JS.synthetic_detection_batch(
        np.random.default_rng(seed), 2, SIZE, max_gt=3)
    kvalid = None
    if case == "unlabeled":
        kvalid = valid.copy()
        kvalid[0, 0] = kvalid[1, :] = False
    return images.astype(dtype), boxes.astype(dtype), kps.astype(dtype), \
        valid, kvalid


def _nchw(images):
    return torch.from_numpy(np.ascontiguousarray(images)).permute(
        0, 3, 1, 2).contiguous()


def _port_model():
    return TS.SCRFDNet(TS.SCRFDConfig(**TINY))


# -------------------------------------------------------- geometry, losses


def _boxes(rng, n):
    xy = rng.uniform(0, 50, size=(n, 2))
    wh = rng.uniform(1, 30, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _tied_pairs(rng):
    """(pred, target) box pairs with ties at every clip and extreme:
    equal boxes, shared edges, touching boxes (zero overlap), one box
    inside the other, and seeded ones."""
    t = _boxes(rng, 6)
    p = _boxes(rng, 6)
    p[0] = t[0]                                   # identical
    p[1, :2] = t[1, :2]                           # shared corner
    p[2] = [t[2, 2], t[2, 1], t[2, 2] + 5, t[2, 3]]   # touching at x2
    p[3] = [t[3, 0] + 1, t[3, 1] + 1, t[3, 2] - 1, t[3, 3] - 1]  # inside
    p[4, 2:] = t[4, 2:]                           # shared far corner
    return p, t


def test_geometry_and_losses_match_jax_with_their_gradients():
    rng = np.random.default_rng(0)
    p, t = _tied_pairs(rng)
    jp, jt = jnp.asarray(p), jnp.asarray(t)
    tp = torch.from_numpy(p).requires_grad_(True)
    tt = torch.from_numpy(t)
    np.testing.assert_allclose(
        TT.pairwise_iou(tp.detach(), tt).numpy(),
        np.asarray(JS.pairwise_iou(jp, jt)), rtol=1e-6, atol=1e-7)
    want = np.asarray(JS.diou_loss(jp, jt))
    got = TT.diou_loss(tp, tt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    g_want = np.asarray(jax.grad(lambda a: JS.diou_loss(a, jt).sum())(jp))
    (g_got,) = torch.autograd.grad(got.sum(), tp)
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=1e-5, atol=1e-7)

    # QFL at the clip's bounds and in between; q at 0, between and 1
    pv = np.asarray([1e-6, 1 - 1e-6, 0.3, 1e-8, 0.999999999, 0.5, 0.01],
                    np.float32)
    qv = np.asarray([0.0, 1.0, 0.3, 0.2, 0.0, 1.0, 0.0], np.float32)
    want = np.asarray(JS.quality_focal_loss(jnp.asarray(pv), jnp.asarray(qv)))
    tpv = torch.from_numpy(pv).requires_grad_(True)
    got = TT.quality_focal_loss(tpv, torch.from_numpy(qv))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-12)
    g_want = np.asarray(jax.grad(lambda a: JS.quality_focal_loss(
        a, jnp.asarray(qv)).sum())(jnp.asarray(pv)))
    (g_got,) = torch.autograd.grad(got.sum(), tpv)
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=1e-5, atol=1e-6)

    # smooth-L1 at 0, at +-beta and beyond
    xv = np.asarray([0.0, 1 / 9, -1 / 9, 0.05, -0.3, 2.0], np.float32)
    want = np.asarray(JS.smooth_l1(jnp.asarray(xv)))
    txv = torch.from_numpy(xv).requires_grad_(True)
    got = TT.smooth_l1(txv)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    g_want = np.asarray(jax.grad(lambda a: JS.smooth_l1(a).sum())(
        jnp.asarray(xv)))
    (g_got,) = torch.autograd.grad(got.sum(), txv)
    np.testing.assert_array_equal(g_got.numpy(), g_want)


@pytest.mark.parametrize("size", [(64, 64), (640, 640), (96, 160)])
def test_anchor_boxes_equal_jax(size):
    want = JS._anchor_boxes(JS.SCRFDLossConfig(input_size=size))
    got = TST._anchor_boxes(TST.SCRFDLossConfig(input_size=size))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[2]) == list(want[2])


def _assign_inputs(case, size, rng):
    h, w = size
    b, m = 3, 6
    side = rng.uniform(0.05, 0.6, size=(b, m)) * min(h, w)
    x1 = rng.uniform(0, w - side)
    y1 = rng.uniform(0, h - side)
    gt = np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.float32)
    valid = np.ones((b, m), bool)
    if case == "tied":
        # faces centred on anchor centres and halfway between them: the
        # centre distances tie across locations as well as in pairs
        gt = (np.round(gt / 8) * 8).astype(np.float32)
        gt[0, 1] = [4.0, 4.0, 28.0, 28.0]
        gt[1, 2] = gt[1, 3] = [8.0, 8.0, 40.0, 40.0]   # a duplicate face
    elif case == "invalid":
        valid = rng.uniform(size=(b, m)) < 0.6
        valid[2] = False                                # an empty image
        gt[~valid] = 0.0
    return gt, valid


@pytest.mark.parametrize("size", [(64, 64), (640, 640)])
@pytest.mark.parametrize("case", ["seeded", "tied", "invalid"])
def test_atss_assign_matches_jax_index_for_index(case, size):
    centers, aboxes, levels = TST._anchor_boxes(TST.SCRFDLossConfig(
        input_size=size))
    rng = np.random.default_rng(hash(case) % 1000 + size[0])
    for _ in range(3):
        gt, valid = _assign_inputs(case, size, rng)
        want = jax.vmap(lambda g, v: JS.atss_assign(
            g, v, jnp.asarray(centers), jnp.asarray(aboxes), levels))(
                jnp.asarray(gt), jnp.asarray(valid))
        got = TT.atss_assign(torch.from_numpy(gt), torch.from_numpy(valid),
                             torch.from_numpy(centers),
                             torch.from_numpy(aboxes), levels)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assigned = got[0].numpy()
        assert (assigned >= 0).any()
        assert set(np.unique(assigned[assigned >= 0])) <= set(
            np.flatnonzero(valid.reshape(-1)) % valid.shape[1])
    if case == "invalid":
        assert (got[0][2] == -1).all()


def _head_outputs(rng, size, batch=2):
    h, w = size
    out = {"scores": [], "bboxes": [], "kps": []}
    for s in CFG_T.strides:
        n = (h // s) * (w // s) * CFG_T.num_anchors
        logits = rng.normal(-2, 2, (batch, n, 1))
        out["scores"].append(1 / (1 + np.exp(-logits)))
        out["bboxes"].append(rng.uniform(0.2, 4.0, (batch, n, 4)))
        out["kps"].append(rng.normal(0, 2, (batch, n, 10)))
    return {k: [a.astype(np.float32) for a in v] for k, v in out.items()}


@pytest.mark.parametrize("case", ["constant", "unlabeled"])
def test_scrfd_loss_and_its_gradient_match_jax(case):
    """The loss and its four metrics on the same head outputs within 1e-6
    relative at float32, with and without a ``gt_kps_valid`` mask; the
    gradient with respect to the head outputs alike."""
    rng = np.random.default_rng(5)
    outs = _head_outputs(rng, SIZE)
    _, boxes, kps, valid, kvalid = _batch(case)
    jargs = (jnp.asarray(boxes), jnp.asarray(kps), jnp.asarray(valid))
    jkv = None if kvalid is None else jnp.asarray(kvalid)

    def jloss(o):
        return JS.scrfd_loss(o, *jargs, CFG_J, gt_kps_valid=jkv)

    (want, wm), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, outs))
    touts = {k: [torch.from_numpy(a).requires_grad_(True) for a in v]
             for k, v in outs.items()}
    got, gm = TT.scrfd_loss(touts, torch.from_numpy(boxes),
                            torch.from_numpy(kps), torch.from_numpy(valid),
                            CFG_T, None if kvalid is None
                            else torch.from_numpy(kvalid))
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    for k in ("cls", "box", "kps"):
        w = float(wm[k])
        assert abs(float(gm[k].detach()) - w) <= 1e-6 * abs(w), k
    assert int(gm["n_pos"]) == int(wm["n_pos"]) > 0
    if case == "unlabeled":      # masked faces leave the landmark term
        _, full = TT.scrfd_loss({k: [a.detach() for a in v]
                                 for k, v in touts.items()},
                                torch.from_numpy(boxes),
                                torch.from_numpy(kps),
                                torch.from_numpy(valid), CFG_T)
        assert float(full["kps"]) != float(gm["kps"].detach())
        assert float(full["box"]) == float(gm["box"].detach())
    grads = torch.autograd.grad(got, [a for v in touts.values() for a in v])
    for g, w in zip(grads, [a for k in touts for a in wgrad[k]]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_synthetic_detection_batch_equals_jax():
    for seed, batch, size, max_gt in ((0, 2, (64, 64), 3),
                                      (7, 3, (96, 160), 8)):
        want = JS.synthetic_detection_batch(np.random.default_rng(seed),
                                            batch, size, max_gt)
        got = TT.synthetic_detection_batch(np.random.default_rng(seed),
                                           batch, size, max_gt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the state


def _jax_trainer(mesh, dtype=jnp.float32, **kw):
    return JS.SCRFDTrainer(model=JSCRFDNet(JConfig(**TINY), dtype=dtype),
                           mesh=mesh, loss_cfg=CFG_J, **kw)


@pytest.fixture(scope="module")
def jax32():
    """JAX's float32 trainer (one compile): its ``init_state`` and, from
    it, the first step of the "constant" and "unlabeled" cases (one
    learning rate): {"start": numpy state, case: (numpy state, loss,
    metrics)}."""
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    trainer = _jax_trainer(mesh, **CASES["constant"])
    start = trainer.init_state(jax.random.PRNGKey(0))
    out = {"start": jax.tree.map(np.asarray, start)}
    for case in ("constant", "unlabeled"):
        assert CASES[case] == CASES["constant"]
        state, loss, metrics = trainer.train_step(start, *_batch(case))
        out[case] = (jax.tree.map(np.asarray, state), float(loss),
                     {k: np.asarray(v) for k, v in metrics.items()})
    return out


def test_init_state_takes_the_jax_trainers_initializers(jax32):
    """A fresh port state has the JAX trainer's distributions (Flax's
    ``SCRFDNet.init``), not the serving side's ``seeded_init_``: the cls
    bias -4.595 (scores 0.01 everywhere), the head's kernels N(0, 0.01^2),
    the other kernels He normal on the fan-out, BN and GN the identity:
    every constant equal to JAX's ``init_state``'s, each kernel of 500 or
    more weights within 15 % of its spread."""
    trainer = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T,
                              device="cpu")
    state = trainer.init_state(0)
    sd = state.model.state_dict()
    head = state.model.head
    assert torch.equal(head.cls.bias, torch.full_like(head.cls.bias, -4.595))
    assert not head.box.bias.any() and not head.kps.bias.any()
    for conv in (head.cls, head.box, head.kps):
        assert abs(float(conv.weight.detach().std()) / 0.01 - 1) < 0.15
    want = state_dict_from_flax(jax32["start"].variables)
    assert set(want) | {k for k in sd if k.endswith("num_batches_tracked")} \
        == set(sd)
    spreads = 0
    for key, w in want.items():
        g = sd[key]
        if key.endswith(".bias") or "running" in key or w.dim() == 1:
            assert torch.equal(g, w), key       # constants: equal
        elif w.numel() >= 500:
            ratio = float(g.std()) / float(w.std())
            assert abs(ratio - 1) < 0.15, (key, ratio)
            spreads += 1
    assert spreads >= 6
    assert all(float(v.abs().max()) == 0 for v in state.trace.values())
    with torch.no_grad():
        out = state.model.eval()(torch.zeros(1, 3, 64, 64))
    s = torch.cat(out["scores"], 1)
    assert float((s - 0.01).abs().max()) < 2e-4     # the prior everywhere
    # the serving side's seeded init scores 0.5 everywhere instead
    from scrfd_arcface_facerecognition_tpu_torch.models import seeded_init_
    served = seeded_init_(_port_model()).eval()
    with torch.no_grad():
        s = torch.cat(served(torch.zeros(1, 3, 64, 64))["scores"], 1)
    assert float((s - 0.5).abs().max()) < 1e-6


def test_scrfd_train_state_from_jax_carries_weights_momentum_and_step(
        jax32):
    npstate = jax32["constant"][0]
    parts = scrfd_train_state_from_jax(npstate)
    assert parts["step"] == 1
    port = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T, device="cpu")
    st = port.state_from(parts)
    names = [n for n, _ in st.model.named_parameters()]
    assert sorted(parts["trace"]) == sorted(names)
    assert float(max(v.abs().max() for v in parts["trace"].values())) > 0
    w = npstate.variables["params"]["head"]["cls"]["kernel"]
    np.testing.assert_array_equal(
        st.model.head.cls.weight.detach().numpy(), w.transpose(3, 2, 0, 1))
    assert parts["trace"]["head.cls.weight"].shape == \
        st.model.head.cls.weight.shape
    back = TT.state_parts(st)
    for k, v in parts["model"].items():
        assert torch.equal(back["model"][k], v), k
    with pytest.raises(ValueError, match="momentum"):
        port.state_from(dict(parts, trace={}))
    with pytest.raises(ValueError, match="momentum trace"):
        scrfd_train_state_from_jax(npstate._replace(opt_state=()))


def test_the_trainer_refuses_what_it_cannot_train():
    bf16 = TS.SCRFDNet(TS.SCRFDConfig(**TINY), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        TT.SCRFDTrainer(model=bf16, device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        TT.SCRFDTrainer(model=_port_model(), device="cpu",
                        dtype=torch.float16)


@pytest.mark.parametrize("case", ["constant", "unlabeled"])
def test_float32_first_loss_and_statistics_match_jax(jax32, case):
    """At float32 the first step's loss (before any update) and the batch
    statistics it moves are well conditioned: held to JAX's float32 step
    within 1e-5 relative and 1e-6 + 1e-5 relative (the neck's last
    statistics sit up to 3.1e-6 relative from JAX's: the two float32
    forwards sum their convolutions in other orders)."""
    state, loss, metrics = jax32[case]
    want = scrfd_train_state_from_jax(state)
    port = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T, device="cpu",
                           **CASES[case])
    images, boxes, kps, valid, kvalid = _batch(case)
    got, got_loss, got_m = port.train_step(
        port.state_from(scrfd_train_state_from_jax(jax32["start"])),
        _nchw(images), torch.from_numpy(boxes), torch.from_numpy(kps),
        torch.from_numpy(valid),
        None if kvalid is None else torch.from_numpy(kvalid))
    assert abs(float(got_loss) - loss) <= 1e-5 * abs(loss)
    assert int(got_m["n_pos"]) == int(metrics["n_pos"])
    stats = got.model.state_dict()
    for k, v in want["model"].items():
        if "running" in k:
            np.testing.assert_allclose(stats[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_serves_the_trained_detector(tmp_path):
    """A checkpoint -> ``load_inference_variables`` -> ``Detector`` detects
    as the trained module does: the head outputs bit-equal on one canvas,
    and the same faces."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Detector
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.detector import (
        decode_outputs)

    trainer = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T,
                              learning_rate=0.05, device="cpu")
    state = trainer.init_state(3)
    images, boxes, kps, valid, _ = _batch(seed=4)
    for _ in range(3):
        state, _, _ = trainer.train_step(state, _nchw(images), boxes, kps,
                                         valid)
    path = str(tmp_path / "step_3.pt")
    trainer.save_checkpoint(state, path)
    v = load_inference_variables(path)
    assert set(v) == {"params", "batch_stats"}
    det = Detector(config=TS.SCRFDConfig(**TINY), variables=v,
                   input_size=SIZE, conf_thres=0.0, pre_nms=32, max_det=8,
                   device="cpu")
    module = state.model.eval()
    x = _nchw(images)
    with torch.no_grad():
        got, want = det.model(x), module(x)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert torch.equal(g, w), k
    frame = np.random.default_rng(6).integers(0, 255, (48, 80, 3), np.uint8)
    d, kp = det.detect(frame)
    twin = Detector(config=TS.SCRFDConfig(**TINY), input_size=SIZE,
                    conf_thres=0.0, pre_nms=32, max_det=8, device="cpu")
    twin.model.load_state_dict(module.state_dict())
    d2, kp2 = twin.detect(frame)
    assert len(d) > 0
    np.testing.assert_array_equal(d, d2)
    np.testing.assert_array_equal(kp, kp2)
    s, _, _ = decode_outputs(want, SIZE)
    assert float(s.max()) > 0


def test_loss_decreases_on_overfit():
    """A few SGD steps on one tiny batch reduce the loss (the whole
    assignment / loss / gradient chain is differentiable and sane), as
    ``tests/test_scrfd_train.py::test_loss_decreases_on_overfit``."""
    trainer = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T,
                              learning_rate=0.01, device="cpu")
    state = trainer.init_state(0)
    images, boxes, kps, valid = TT.synthetic_detection_batch(
        np.random.default_rng(0), 2, SIZE, max_gt=3)
    losses = []
    for _ in range(8):
        state, loss, metrics = trainer.train_step(state, _nchw(images),
                                                  boxes, kps, valid)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert int(metrics["n_pos"]) > 0
    assert losses[-1] < losses[0], f"no learning: {losses}"
    assert state.step == 8
