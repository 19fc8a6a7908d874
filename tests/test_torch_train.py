"""The port's ArcFace trainer against the JAX package's, on the CPU.

The tiny MobileFaceNet of ``tests/test_train.py`` (``mbf_blocks=(1, 1, 1,
1)``, ``emb_dim=64``, 16 classes), 8 seeded images (112 x 112; 64 x 64
for the steps in double). Both trainers start from one state: the JAX
``init_state`` carried across with ``train_state_from_jax``; the JAX
trainer runs on a (1, 1) mesh. Partial FC's scores are JAX's own draws,
given to the port.

The steps are compared in float64 on both sides (JAX under x64 in a child
process, the port with ``dtype=torch.float64``). In float32 they cannot
be: training-mode BatchNorm makes the gradients of tensors such as the
BN shifts inside the trunk small sums of large terms, so the rounding of
one float32 step moves JAX's own first momentum by up to a few percent of
a tensor's largest magnitude (one-ulp changes of its images and weights),
and the next steps amplify that. The JAX package pins its embedding
output, its l2 norm and its margin head to float32; the child takes that
pin to float64 too, so every operation of both steps runs in double.

Tolerances. After each of three steps, every tensor (weights, batch
statistics, class matrix, momentum) within ``ATOL + RTOL * max |JAX's|``
= 1e-12 + 1e-10 * max, and the loss within 1e-11 relative: the port's
float32 step is 2.6e4 times past that bound
(``test_the_bound_tells_float64_from_float32``). At float32 the loss of
the first step (computed before any update) is held within 1e-5 relative
and the batch statistics it moves within 1e-6 + 1e-6 relative. Measured
(``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_train.py``,
its ``parity_report``): every tensor within 0.00092 of its float64 bound
after each step (the largest gap 4e-14, 2.7e-13 of a tensor's largest
magnitude), the float64 losses within 1.5e-14 relative; at float32 the
first loss within 5.1e-7 relative and the batch statistics within
1.7e-6.
"""

import importlib
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.models.arcface import (
    ArcFaceConfig as JConfig, MobileFaceNet as JMobileFaceNet)
from scrfd_arcface_facerecognition_tpu.parallel import make_mesh
from scrfd_arcface_facerecognition_tpu import train as JT
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as TA
from scrfd_arcface_facerecognition_tpu_torch.models.checkpoints import (
    load_inference_variables)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    load_flax_variables, state_dict_from_flax, train_state_from_jax,
    variables_from_module)
from scrfd_arcface_facerecognition_tpu_torch import train as TT
from test_torch_bf16 import jax_reference
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

TINY = dict(name="tiny", arch="mobilefacenet", mbf_blocks=(1, 1, 1, 1),
            mbf_scale=1, emb_dim=64)
# the double-precision steps at 64 x 64 (the smallest side the GDC head
# takes is 16): XLA's float64 convolutions on the CPU are slow
SIDE64 = 64
TINY64 = dict(TINY, input_size=(SIDE64, SIDE64))
STEPS = 3
ATOL, RTOL, LOSS_RTOL = 1e-12, 1e-10, 1e-11


def _images(seed=3, n=8, dtype=np.float32, side=112):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, side, side, 3)).astype(dtype),
            rng.integers(0, 16, size=n).astype(np.int32))


def _nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()


# ----------------------------------------------------------- margin and loss


def test_margin_logits_and_xent_match_jax_past_pi_minus_m():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(6, 32)).astype(np.float32)
    w = rng.normal(size=(32, 11)).astype(np.float32)
    labels = np.asarray([0, 3, 5, 7, 10, 2], np.int32)
    # rows 0 and 1: the target class points almost opposite the embedding,
    # theta + m > pi, the fallback branch
    w[:, 0] = -emb[0] + 0.01 * rng.normal(size=32)
    w[:, 3] = -emb[1] + 0.01 * rng.normal(size=32)
    for s, m in ((64.0, 0.5), (30.0, 0.3)):
        want = np.asarray(JT.arcface_margin_logits(
            jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), s, m))
        got = TT.arcface_margin_logits(torch.from_numpy(emb),
                                       torch.from_numpy(w),
                                       torch.from_numpy(labels), s, m)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
        cos0 = want[0, 0] / s
        assert np.arccos(np.clip(cos0 + m * np.sin(m), -1, 1)) + m > np.pi
        xent_w = np.asarray(JT.softmax_xent(jnp.asarray(want),
                                            jnp.asarray(labels)))
        xent = TT.softmax_xent(torch.from_numpy(want),
                               torch.from_numpy(labels))
        np.testing.assert_allclose(xent.numpy(), xent_w, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------- Partial FC


@pytest.mark.parametrize("case", ["uniform", "ties", "overflow",
                                  "duplicates"])
def test_partial_fc_from_scores_matches_jax(monkeypatch, case):
    rng = np.random.default_rng(4)
    c, s = 100, 24
    labels = rng.integers(0, c, size=16).astype(np.int32)
    scores = rng.uniform(size=c).astype(np.float32)
    if case == "ties":
        scores = (rng.integers(0, 3, size=c) / 4).astype(np.float32)
    elif case == "overflow":
        labels = np.arange(30, dtype=np.int32) * 3
    elif case == "duplicates":
        labels = np.asarray([5, 5, 5, 9, 9, 1], np.int32)
        scores[[5, 9, 1]] = [0.0, 0.99, 0.5]
    # JAX's sampler on these scores: its uniform draw replaced by them
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(scores))
    want = [np.asarray(a) for a in JT.partial_fc_sample(
        jnp.asarray(labels), c, s, jax.random.PRNGKey(0))]
    got = TT.partial_fc_from_scores(torch.from_numpy(scores),
                                    torch.from_numpy(labels), s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].dtype == got[1].dtype == torch.int32
    if case == "overflow":
        assert int(got[2].sum()) == s < len(labels)


def test_partial_fc_sampler_contract():
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1000, size=32))
    idx, new_labels, matched = TT.partial_fc_sample(labels, 1000, 128, 7, 3)
    assert idx.shape == (128,) and new_labels.shape == (32,)
    assert bool(matched.all())                  # 32 positives <= 128
    assert len(torch.unique(idx)) == 128
    for i, y in enumerate(labels.tolist()):
        assert int(idx[new_labels[i]]) == y
    again = TT.partial_fc_sample(labels, 1000, 128, 7, 3)
    assert all(torch.equal(a, b) for a, b in
               zip((idx, new_labels, matched), again))
    other = TT.partial_fc_sample(labels, 1000, 128, 7, 4)[0]
    assert not torch.equal(torch.sort(other)[0], torch.sort(idx)[0])
    over = TT.partial_fc_sample(torch.arange(12), 100, 8, 0, 0)
    assert int(over[2].sum()) == 8              # 4 rows overflow, flagged
    for i in range(12):
        if over[2][i]:
            assert int(over[0][over[1][i]]) == i


def test_partial_fc_drawn_in_the_step_on_random_labels(monkeypatch):
    """Without injected scores the trainer draws Partial FC's sample
    itself (``partial_fc_sample``, seeded by (seed, step)). On a fresh
    random batch each step nothing can be learned: every loss stays above
    ln(S) (near ln(S) + s * sin(m)); every positive is in its step's
    sample, and consecutive steps sample different classes (an overlap
    near S^2 / C)."""
    from scrfd_arcface_facerecognition_tpu_torch.train import arcface_train

    drawn = []
    sample = arcface_train.partial_fc_sample

    def spy(*args):
        drawn.append(sample(*args))
        return drawn[-1]
    monkeypatch.setattr(arcface_train, "partial_fc_sample", spy)
    c, rate = 400, 0.1
    trainer = TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY64)), num_classes=c, emb_dim=64, sample_rate=rate,
        device="cpu")
    s = trainer.num_sample
    state = trainer.init_state(0)
    rng = np.random.default_rng(30)
    losses = []
    for _ in range(6):
        images, _ = _images(seed=int(rng.integers(1 << 30)), side=SIDE64)
        labels = torch.from_numpy(rng.integers(0, c, size=8))
        state, loss = trainer.train_step(state, _nchw(images), labels)
        losses.append(float(loss))
        idx, new_labels, matched = drawn[-1]
        assert bool(matched.all())
        assert torch.equal(idx[new_labels.long()].long(), labels)
    assert len(drawn) == 6 and s == 40
    assert min(losses) > math.log(s), losses
    for a, b in zip(drawn, drawn[1:]):
        assert len(set(a[0].tolist()) & set(b[0].tolist())) < s // 2


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("kw", [
    dict(), dict(warmup_steps=10), dict(decay_steps=40, decay="poly"),
    dict(decay_steps=40, decay="cosine"),
    dict(warmup_steps=10, decay_steps=90, decay="poly"),
    dict(warmup_steps=7, decay_steps=30, decay="cosine", end_lr=0.01)],
    ids=["constant", "warmup", "poly", "cosine", "warmup_poly",
         "warmup_cosine"])
def test_lr_schedule_matches_optax(kw):
    want = JT.make_lr_schedule(0.1, **kw)
    got = TT.make_lr_schedule(0.1, **kw)
    if not kw:
        assert got == want == 0.1
        return
    for step in range(0, 130):
        w = float(np.asarray(want(jnp.asarray(step, jnp.int32))))
        assert abs(got(step) - w) <= 1e-6 * abs(w) + 1e-9, (step, got(step), w)
    assert got(0) == 0.0 if kw.get("warmup_steps") else got(0) == \
        pytest.approx(0.1)
    with pytest.raises(ValueError):
        TT.make_lr_schedule(0.1, decay_steps=10, decay="step")


# -------------------------------------------------------------- BN repair


def test_train_mode_batchnorm_moves_the_statistics_as_flax():
    """One train-mode forward of a carried MobileFaceNet moves its running
    statistics as Flax's (biased batch variance, momentum 0.9): PyTorch's
    own update (unbiased) is 1/7 off on the 8-sample ``features_bn``."""
    jm = JMobileFaceNet(JConfig(**TINY))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 112, 112, 3))))
    images, _ = _images()
    _, mutated = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(images),
                          train=True, mutable=["batch_stats"])
    want = state_dict_from_flax(
        {"batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])})
    module = load_flax_variables(TA.MobileFaceNet(TA.ArcFaceConfig(**TINY)),
                                 v).train()
    with torch.no_grad():
        module(_nchw(images))
    got = module.state_dict()
    assert len(want) == 2 * 23
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------- train_step parity

CASES = {
    "full": dict(),
    "no_clip": dict(scale=1.0),
    "partial_fc": dict(sample_rate=0.5),
    "warmup": dict(warmup_steps=2),
}


def _kw(case):
    return dict(num_classes=16, emb_dim=64, learning_rate=0.1, **CASES[case])


class _Float64Jnp:
    """``jax.numpy`` whose ``float32`` is ``float64``: put in place of the
    ``jnp`` of the JAX modules that pin the embedding, its l2 norm and
    the margin head to float32, it runs them in double."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_PINNED = ("scrfd_arcface_facerecognition_tpu.train.arcface_train",
           "scrfd_arcface_facerecognition_tpu.models.arcface",
           "scrfd_arcface_facerecognition_tpu.ops.similarity")


def _put_parts(out, prefix, state):
    parts = train_state_from_jax(jax.tree.map(np.asarray, state))
    for name, t in TT.state_tensors(parts).items():
        out[f"{prefix}/{name}"] = t.numpy()
    out[f"{prefix}/step"] = np.asarray(parts["step"])


def _job_steps64():
    """In the child (``JAX_ENABLE_X64=1``): JAX's trainer in double, every
    case from its float32 ``init_state``: the start, the state after each
    step, the losses and the Partial FC draws."""
    assert jax.config.jax_enable_x64
    images, labels = _images(dtype=np.float64, side=SIDE64)
    mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    runs = {}
    for case in CASES:          # the float32 trainer's start, in double
        trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(
            JConfig(**TINY64), dtype=jnp.float64), mesh=mesh, **_kw(case))
        runs[case] = trainer, jax.tree.map(
            lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
            trainer.init_state(jax.random.PRNGKey(0), (SIDE64, SIDE64)))
    for name in _PINNED:
        importlib.import_module(name).jnp = _Float64Jnp()
    out = {}
    for case, (trainer, state) in runs.items():
        _put_parts(out, f"{case}/start", state)
        for step in range(STEPS):
            state, loss = trainer.train_step(state, jnp.asarray(images),
                                             jnp.asarray(labels))
            _put_parts(out, f"{case}/{step}", state)
            out[f"{case}/{step}/loss"] = np.asarray(loss)
        out[f"{case}/scores"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(0), step), (16,)))
            for step in range(STEPS)])
    return out


@pytest.fixture(scope="module")
def jax64():
    ref = jax_reference("test_torch_train", "steps64",
                        extra_env={"JAX_ENABLE_X64": "1"})
    assert ref["full/0/head_w"].dtype == np.float64
    return ref


def _parts(ref, prefix):
    """The port trainer's parts of JAX's state at ``prefix``."""
    parts = {"backbone": {}, "trace": {},
             "step": int(ref[f"{prefix}/step"])}
    for key, arr in ref.items():
        if not key.startswith(prefix + "/") or key.endswith("/step") or \
                key.endswith("/loss"):
            continue
        name = key[len(prefix) + 1:]
        kind, _, rest = name.partition(".")
        if name == "head_w":
            parts["head_w"] = torch.from_numpy(arr)
        else:
            parts[kind][rest] = torch.from_numpy(arr)
    return parts


def _port_run(ref, case, remat=False, dtype=torch.float64):
    """The port's ``STEPS`` steps from JAX's start: (trainer, state, [(the
    state's parts, loss, global gradient norm) a step])."""
    trainer = TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY64)), device="cpu", remat=remat, dtype=dtype, **_kw(case))
    state = trainer.state_from(_parts(ref, f"{case}/start"))
    images, labels = _images(dtype=np.float64, side=SIDE64)
    out = []
    for step in range(STEPS):
        scores = (torch.from_numpy(ref[f"{case}/scores"][step])
                  if trainer.num_sample < 16 else None)
        state, loss = trainer.train_step(state, _nchw(images),
                                         torch.from_numpy(labels), scores)
        out.append((TT.state_parts(state), float(loss),
                    float(trainer.last_grad_norm)))
    return trainer, state, out


def _worst(port_parts, ref, prefix):
    gaps = TT.state_gaps(port_parts, _parts(ref, prefix), ATOL, RTOL)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(jax64, case):
    _, _, port = _port_run(jax64, case)
    for step in range(STEPS):
        parts, loss, _ = port[step]
        want = float(jax64[f"{case}/{step}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (step, loss, want)
        share, name = _worst(parts, jax64, f"{case}/{step}")
        assert share <= 1.0, (f"step {step + 1} {name}: {share:.3g} x "
                              f"{ATOL} + {RTOL} x max")
    norms = [p[2] for p in port]
    if case == "no_clip":        # clipped on the first step, not the last
        assert norms[0] > 5.0 and norms[-1] < 5.0
    else:
        assert min(norms) > 5.0
    if case == "warmup":         # lr(0) = 0: the first update moves nothing
        first, start = port[0][0], _parts(jax64, "warmup/start")
        for name, p in start["backbone"].items():
            if "running" not in name:
                assert torch.equal(first["backbone"][name], p), name
        assert torch.equal(first["head_w"], start["head_w"])
        assert float(first["trace"]["head_w"].abs().max()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_float32_first_loss_and_statistics_match_jax(case):
    """At float32 the first step's loss (before any update) and the batch
    statistics it moves are well conditioned: held to JAX's float32 step
    within 1e-5 relative and 1e-6 + 1e-6 relative."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(JConfig(**TINY)),
                                mesh=mesh, **_kw(case))
    start = trainer.init_state(jax.random.PRNGKey(0))
    images, labels = _images()
    state, loss = trainer.train_step(start, jnp.asarray(images),
                                     jnp.asarray(labels))
    want = train_state_from_jax(jax.tree.map(np.asarray, state))
    port = TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY)), device="cpu", **_kw(case))
    scores = torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), (16,))))
    got, got_loss = port.train_step(
        port.state_from(train_state_from_jax(jax.tree.map(np.asarray,
                                                          start))),
        _nchw(images), torch.from_numpy(labels),
        scores if port.num_sample < 16 else None)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    stats = got.backbone.state_dict()
    for k, v in want["backbone"].items():
        if "running" in k:
            np.testing.assert_allclose(stats[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_the_bound_tells_float64_from_float32(jax64):
    """The port's float32 step from the same start is far past the float64
    bound: the bound catches a step that loses precision."""
    _, _, port = _port_run(jax64, "full", dtype=torch.float32)
    share, _ = _worst(port[0][0], jax64, "full/0")
    assert share > 1e3
    want = float(jax64["full/0/loss"])
    assert abs(port[0][1] - want) > LOSS_RTOL * abs(want)


def test_remat_equals_no_remat_and_moves_the_statistics_once(jax64,
                                                             monkeypatch):
    calls = []
    recompute = TA.remat_call
    monkeypatch.setattr(TA, "remat_call",
                        lambda block, x: calls.append(1) or recompute(
                            block, x))
    _, _, plain = _port_run(jax64, "full")
    assert not calls
    _, _, remat = _port_run(jax64, "full", remat=True)
    assert len(calls) == STEPS * len(TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY)).blocks)
    for (a, la, _), (b, lb, _) in zip(plain, remat):
        assert la == lb
        ta, tb = TT.state_tensors(a), TT.state_tensors(b)
        for name, x in ta.items():
            assert torch.equal(x, tb[name]), name
    # and the statistics moved once a step: as JAX's after three steps
    share, name = _worst(remat[-1][0], jax64, f"full/{STEPS - 1}")
    assert share <= 1.0, name


def test_recomputation_leaves_the_statistics_alone():
    from scrfd_arcface_facerecognition_tpu_torch.models import seeded_init_

    module = seeded_init_(TA.MobileFaceNet(TA.ArcFaceConfig(**TINY))).train()
    x = _nchw(_images(n=4)[0])
    module(x, remat=True).sum().backward()
    once = {k: v.clone() for k, v in module.state_dict().items()}
    fresh = seeded_init_(TA.MobileFaceNet(TA.ArcFaceConfig(**TINY))).train()
    with torch.no_grad():
        fresh(x)
    for k, v in fresh.state_dict().items():
        assert torch.equal(once[k], v), k
    assert not any(getattr(m, "hold_stats", False)
                   for m in module.modules())


def test_the_trainer_refuses_what_it_cannot_train():
    from scrfd_arcface_facerecognition_tpu_torch.models.layers import (
        set_compute_dtype)

    model = TA.MobileFaceNet(TA.ArcFaceConfig(**TINY), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        TT.ArcFaceTrainer(model=model, num_classes=16, emb_dim=64,
                          device="cpu")
    model = TA.MobileFaceNet(TA.ArcFaceConfig(**TINY))
    with pytest.raises(ValueError, match="float64 for a model"):
        set_compute_dtype(model, torch.float64)   # its parameters: float32
    with pytest.raises(ValueError, match="sample_rate"):
        TT.ArcFaceTrainer(model=model, num_classes=16, emb_dim=64,
                          sample_rate=0.0, device="cpu")
    trainer = TT.ArcFaceTrainer(model=model, num_classes=16, emb_dim=64,
                                device="cpu")
    parts = dict(backbone=trainer.init_state(0).backbone.state_dict(),
                 head_w=torch.zeros(64, 15), step=0,
                 trace=dict(trainer.init_state(0).trace))
    with pytest.raises(ValueError, match="head_w"):
        trainer.state_from(parts)
    parts["trace"].pop("head_w")
    with pytest.raises(ValueError, match="momentum"):
        trainer.state_from(parts)


def test_a_trained_module_serves_at_bf16_from_its_new_weights():
    """The trainer updates the f32 weights in place; rounding the trained
    module for bf16 serving (``set_compute_dtype``) copies those weights,
    not the ones it started from."""
    from scrfd_arcface_facerecognition_tpu_torch.models.layers import (
        set_compute_dtype)

    trainer = TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY)), num_classes=16, emb_dim=64, learning_rate=0.1,
        device="cpu")
    state = trainer.init_state(0)
    before = state.backbone.stem.conv.weight.detach().clone()
    images, labels = _images(n=4)
    state, _ = trainer.train_step(state, _nchw(images),
                                  torch.from_numpy(labels))
    module = set_compute_dtype(state.backbone.eval(), torch.bfloat16)
    conv = module.stem.conv
    assert not torch.equal(conv.weight.detach(), before)
    assert torch.equal(conv.weight_c, conv.weight.detach().bfloat16())
    with torch.no_grad():
        assert module(_nchw(images)).dtype == torch.float32


# ------------------------------------------------------------ checkpoints


def test_checkpoint_round_trip_and_inference_variables(tmp_path, jax64):
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Embedder

    trainer, state, _ = _port_run(jax64, "partial_fc", dtype=torch.float32)
    path = str(tmp_path / "step_3.pt")
    trainer.save_checkpoint(state, path)
    back = trainer.restore_checkpoint(path)
    assert back.step == state.step == 3
    live, restored = (TT.state_tensors(TT.state_parts(st))
                      for st in (state, back))
    for name, x in live.items():
        assert torch.equal(x, restored[name]), name
    # training goes on from the restored state as from the live one
    images, labels = _images(seed=8, side=SIDE64)
    scores = torch.from_numpy(np.random.default_rng(1).uniform(
        size=16).astype(np.float32))
    _, l1 = trainer.train_step(state, _nchw(images), torch.from_numpy(labels),
                               scores)
    _, l2 = trainer.train_step(back, _nchw(images), torch.from_numpy(labels),
                               scores)
    assert float(l1) == float(l2)
    # the inference variables serve the trained module's embeddings
    v = load_inference_variables(path)
    assert set(v) == {"params", "batch_stats"}
    assert "head_w" not in v["params"]
    emb = Embedder(config=TA.ArcFaceConfig(**TINY64), variables=v,
                   device="cpu")
    x = _nchw(_images(seed=2, n=3, side=SIDE64)[0])
    module = trainer.restore_checkpoint(path).backbone.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(emb.model(x).numpy(),
                                      module(x).numpy())
    # a raw variables file loads too; anything else is refused
    raw = str(tmp_path / "raw.pt")
    torch.save(_tensor_tree(variables_from_module(module)), raw)
    assert load_inference_variables(raw).keys() == v.keys()
    junk = str(tmp_path / "junk.pt")
    torch.save({"weights": torch.zeros(3)}, junk)
    with pytest.raises(ValueError, match="not a variables checkpoint"):
        load_inference_variables(junk)


def _tensor_tree(tree):
    return {k: _tensor_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


# -------------------------------------------------------------- evaluation


def test_verification_metrics_and_evaluate_embedder_match_jax():
    rng = np.random.default_rng(12)
    e1 = rng.normal(size=(200, 16)).astype(np.float32)
    e1_before = e1.copy()
    e2 = e1 + rng.normal(size=(200, 16)).astype(np.float32) * np.where(
        np.arange(200) % 2 == 0, 0.3, 3.0)[:, None].astype(np.float32)
    same = np.arange(200) % 2 == 0
    for args in ((e1, e2, same), (e1, e2, np.zeros(200, bool)),
                 (e1, e2, np.ones(200, bool)), (e1[:0], e2[:0], same[:0])):
        got = TT.verification_metrics(*args, far_targets=(0.1, 0.01))
        want = JT.verification_metrics(*[np.copy(a) for a in args],
                                       far_targets=(0.1, 0.01))
        assert got == want
    np.testing.assert_array_equal(e1, e1_before)   # the port copies
    jm = JMobileFaceNet(JConfig(**TINY))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                         jnp.zeros((1, 112, 112, 3))))
    module = load_flax_variables(TA.MobileFaceNet(TA.ArcFaceConfig(**TINY)),
                                 v)
    imgs = _images(seed=5, n=10)[0]
    pairs = [(imgs[i], imgs[(i + 1) % 10] if i % 3 else imgs[i] * 0.9,
              i % 3 == 0) for i in range(10)]
    got = TT.evaluate_embedder(module, pairs, batch=4)
    want = JT.evaluate_embedder(
        lambda vv, x: jm.apply(vv, x, train=False),
        jax.tree.map(jnp.asarray, v), pairs, batch=4)
    assert got["n_pairs"] == want["n_pairs"] == 10
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-6
    assert abs(got["threshold"] - want["threshold"]) <= 1e-4
    assert module.training                      # its mode is given back


def parity_report():
    """The numbers the module docstring states: for each case and step,
    the float64 port's largest share of its bound, its largest gap
    (absolute, and as a share of the tensor's largest magnitude among the
    tensors above 1e-9, not the ~1e-17 of analytic zeros) and the
    loss's relative difference; the float32 step's share of the bound;
    the float32 first loss and batch statistics against JAX's float32."""
    ref = jax_reference("test_torch_train", "steps64",
                        extra_env={"JAX_ENABLE_X64": "1"})
    for case in CASES:
        _, _, port = _port_run(ref, case)
        line = [case]
        for step in range(STEPS):
            parts, loss, _ = port[step]
            want = _parts(ref, f"{case}/{step}")
            share, _ = _worst(parts, ref, f"{case}/{step}")
            gap = max(TT.state_gaps(parts, want, 1.0, 0.0).values())
            wt = TT.state_tensors(want)
            rel = max(v for k, v in TT.state_gaps(parts, want, 1e-300,
                                                  1.0).items()
                      if float(wt[k].abs().max()) > 1e-9)
            w = float(ref[f"{case}/{step}/loss"])
            line.append(f"step {step + 1}: {share:.3g} of the bound, gap "
                        f"{gap:.3g} ({rel:.3g} of max), loss "
                        f"{abs(loss - w) / abs(w):.3g}")
        print("; ".join(line))
    _, _, f32 = _port_run(ref, "full", dtype=torch.float32)
    print(f"float32 step 1: {_worst(f32[0][0], ref, 'full/0')[0]:.3g} x the "
          f"float64 bound")
    mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    for case in CASES:
        trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(JConfig(**TINY)),
                                    mesh=mesh, **_kw(case))
        start = trainer.init_state(jax.random.PRNGKey(0))
        images, labels = _images()
        state, loss = trainer.train_step(start, jnp.asarray(images),
                                         jnp.asarray(labels))
        want = train_state_from_jax(jax.tree.map(np.asarray, state))
        port = TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
            **TINY)), device="cpu", **_kw(case))
        scores = torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(0), 0), (16,))))
        got, got_loss = port.train_step(
            port.state_from(train_state_from_jax(
                jax.tree.map(np.asarray, start))),
            _nchw(images), torch.from_numpy(labels),
            scores if port.num_sample < 16 else None)
        stats = max(float((got.backbone.state_dict()[k] - v).abs().max())
                    for k, v in want["backbone"].items() if "running" in k)
        print(f"float32 {case}: first loss "
              f"{abs(float(got_loss) - float(loss)) / abs(float(loss)):.3g}"
              f" relative, batch statistics within {stats:.3g}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_train.py
    parity_report()
