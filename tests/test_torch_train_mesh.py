"""The port's meshed ArcFace trainer against the JAX package's, on the CPU.

JAX's ``ArcFaceTrainer`` on ``make_mesh((2, 4), ("data", "model"))`` over
conftest's virtual CPU devices; the port's on ``make_mesh((2, 4), ...,
device_slots("cpu", 8))``: the batch split over 'data', the class matrix
padded to a multiple of 4 and split into column shards over 'model', the
backbone's BatchNorm over the global batch (``parallel.collectives``).
The tiny MobileFaceNet of ``tests/test_torch_train.py`` at 32 x 32, 8
images; both trainers start from JAX's ``init_state`` carried across with
``train_state_from_jax`` (its padded class matrix as it is).

JAX's own (2, 4)-mesh step is not its global-batch step on this JAX (0.9,
CPU): the gradient of each grouped (depthwise) conv kernel comes out 4
times (the 'model' axis) its one-device gradient, every other gradient
equal (``test_jax_mesh_overcounts_grouped_conv_gradients``, float64; the
(1, 4), (2, 1) and (8, 1) meshes give the one-device numbers). GSPMD
keeps a program's meaning, so that is a defect of the partitioner. The
reference therefore runs JAX's (2, 4)-mesh program as it is (the sharded
forward and backward, BatchNorm's global statistics, the class-sharded
softmax, Partial FC's gather) and divides those gradients by 4 before
JAX's own optimizer update (``_corrected``).

The steps are compared in float64 on both sides, as in
``tests/test_torch_train.py`` (JAX under x64 in a child process whose
``XLA_FLAGS`` keep the 8 virtual devices, its float32 pins taken to
float64; the port with ``dtype=torch.float64``): after each of three
steps every tensor within 1e-12 + 1e-10 x max |JAX's|, the loss within
1e-11 relative. Cases: the full softmax over 16 classes and over 13
(padded to 16: the pad columns masked, decayed, never labelled), and
Partial FC on JAX's own draws. The port's meshed step is also held to its
one-device step at the same bound (Partial FC drawn by the trainer, and
with remat), and at float32 the first step's loss and batch statistics to
JAX's float32 meshed step (1e-5 relative; 1e-6 + 1e-6 relative), in this
process on conftest's 8 devices.

Measured (``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_train_mesh.py`` prints each case's worst share of the
bound; root ``PERF.md`` §6 records it).
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.models.arcface import (
    ArcFaceConfig as JConfig, MobileFaceNet as JMobileFaceNet)
from scrfd_arcface_facerecognition_tpu.parallel import make_mesh as jmesh
from scrfd_arcface_facerecognition_tpu import train as JT
from scrfd_arcface_facerecognition_tpu_torch import parallel
from scrfd_arcface_facerecognition_tpu_torch import train as TT
from scrfd_arcface_facerecognition_tpu_torch.models import arcface as TA
from scrfd_arcface_facerecognition_tpu_torch.models.checkpoints import (
    load_inference_variables)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    train_state_from_jax)
from scrfd_arcface_facerecognition_tpu_torch.parallel import collectives
from test_torch_bf16 import jax_reference
from test_torch_train import (ATOL, LOSS_RTOL, RTOL, STEPS, TINY,
                              _Float64Jnp, _PINNED, _images, _nchw, _parts,
                              _put_parts)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

# 32 x 32 (the GDC head's kernel 2 x 2): XLA's float64 step on the (2, 4)
# mesh runs the backbone once for each 'model' slot, about 10 s a step at
# 64 x 64 on this CPU against 2 s here
SIDE = 32
TINY32 = dict(TINY, input_size=(SIDE, SIDE))
MESH = (2, 4)
# the child's XLA: every bf16 op rounded (jax_reference's default) and the
# 8 virtual devices of conftest
CHILD_ENV = {"JAX_ENABLE_X64": "1",
             "XLA_FLAGS": "--xla_allow_excess_precision=false "
                          "--xla_force_host_platform_device_count=8"}

CASES = {
    "full16": dict(num_classes=16),
    "full13": dict(num_classes=13),
    "partial_fc": dict(num_classes=16, sample_rate=0.5),
}


def _kw(case):
    return dict(emb_dim=64, learning_rate=0.1, **CASES[case])


def _batch(case, dtype=np.float64):
    images, labels = _images(dtype=dtype, side=SIDE)
    return images, labels % CASES[case]["num_classes"]


def _grouped_kernel(path, leaf) -> bool:
    """A grouped (depthwise) conv's kernel: (kh, kw, 1, C) in Flax."""
    return (jax.tree_util.keystr(path).endswith("['kernel']")
            and leaf.ndim == 4 and leaf.shape[2] == 1 and leaf.shape[3] > 1)


def _corrected(optimizer, tp):
    """``optimizer`` whose update first divides the gradient of every
    grouped conv's kernel by ``tp``: on this JAX (0.9, CPU) the
    partitioner's gradient of such a kernel on a mesh with 'data' and
    'model' both above 1 is ``tp`` times the global-batch gradient
    (``test_jax_mesh_overcounts_grouped_conv_gradients``)."""
    import optax

    def fix(grads):
        return jax.tree_util.tree_map_with_path(
            lambda p, g: g / tp if _grouped_kernel(p, g) else g, grads)

    return optax.GradientTransformation(
        optimizer.init, lambda g, s, p=None: optimizer.update(fix(g), s, p))


def _job_mesh64():
    """In the child (x64, 8 virtual devices): JAX's trainer on the (2, 4)
    mesh in double, its grouped-conv gradients corrected (``_corrected``),
    every case from its float32 ``init_state`` (one draw: 13 classes pad
    to 16): the start, the state after each step, the losses and the
    Partial FC draws; and the first step's uncorrected gradients on the
    (2, 4) mesh and on one device."""
    assert jax.config.jax_enable_x64 and len(jax.devices()) == 8
    mesh = jmesh(MESH, ("data", "model"))
    runs, start = {}, None
    for case in CASES:
        trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(
            JConfig(**TINY32), dtype=jnp.float64), mesh=mesh, **_kw(case))
        if start is None:
            start = jax.tree.map(
                lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32
                else a, trainer.init_state(jax.random.PRNGKey(0),
                                           (SIDE, SIDE)))
        assert trainer.padded_classes == 16
        runs[case] = trainer
    for name in _PINNED:
        importlib.import_module(name).jnp = _Float64Jnp()
    out = {}
    images, labels = _batch("full16")
    one = jmesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    for name, m in (("mesh", mesh), ("one", one)):
        trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(
            JConfig(**TINY32), dtype=jnp.float64), mesh=m, **_kw("full16"))
        state = trainer.shard_state(start)
        params = {"backbone": state.backbone["params"],
                  "head_w": state.head_w}
        grads = jax.jit(jax.grad(lambda *a: trainer._loss_fn(*a)[0]))(
            params, state.backbone["batch_stats"], jnp.asarray(images),
            jnp.asarray(labels), state.step)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            key = ("grouped" if _grouped_kernel(path, g) else "other")
            out[f"grad/{name}/{key}/{jax.tree_util.keystr(path)}"] = \
                np.asarray(g)
    for case, trainer in runs.items():
        trainer.optimizer = _corrected(trainer.optimizer, MESH[1])
        state = start
        images, labels = _batch(case)
        _put_parts(out, f"{case}/start", state)
        for step in range(STEPS):
            state, loss = trainer.train_step(state, jnp.asarray(images),
                                             jnp.asarray(labels))
            _put_parts(out, f"{case}/{step}", state)
            out[f"{case}/{step}/loss"] = np.asarray(loss)
        c = CASES[case]["num_classes"]
        out[f"{case}/scores"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(0), step), (c,)))
            for step in range(STEPS)])
    return out


@pytest.fixture(scope="module")
def jax64():
    ref = jax_reference("test_torch_train_mesh", "mesh64",
                        extra_env=CHILD_ENV)
    assert ref["full13/0/head_w"].shape == (64, 16)
    assert ref["full13/0/head_w"].dtype == np.float64
    return ref


def _mesh(shape=MESH):
    return parallel.make_mesh(shape, ("data", "model"),
                              parallel.device_slots("cpu", 8))


def _trainer(case, mesh=None, dtype=torch.float64, **kw):
    return TT.ArcFaceTrainer(model=TA.MobileFaceNet(TA.ArcFaceConfig(
        **TINY32)), dtype=dtype, mesh=mesh,
        device="cpu" if mesh is None else None, **_kw(case), **kw)


def _run(trainer, state, case, steps=STEPS, scores=None, images=None):
    """``steps`` updates: [(the state's parts, loss, global norm)] a
    step."""
    if images is None:
        images, labels = _batch(case)
    else:
        labels = _batch(case)[1]
    out = []
    for step in range(steps):
        s = None if scores is None else torch.from_numpy(scores[step])
        state, loss = trainer.train_step(state, _nchw(images),
                                         torch.from_numpy(labels), s)
        out.append((TT.state_parts(state), float(loss),
                    float(trainer.last_grad_norm)))
    return state, out


def _worst(got, want):
    gaps = TT.state_gaps(got, want, ATOL, RTOL)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def _unpadded(parts, c):
    """A meshed state's parts cut to the ``c`` real classes."""
    out = dict(parts, trace=dict(parts["trace"]))
    out["head_w"] = parts["head_w"][:, :c]
    out["trace"]["head_w"] = parts["trace"]["head_w"][:, :c]
    return out


def _padded(parts, width, seed=5):
    """One-device parts with seeded pad columns (zero momentum) up to
    ``width``."""
    d, c = parts["head_w"].shape
    gen = torch.Generator().manual_seed(seed)
    pad = torch.randn((d, width - c), generator=gen,
                      dtype=parts["head_w"].dtype) * 0.01
    out = dict(parts, trace=dict(parts["trace"]))
    out["head_w"] = torch.cat([parts["head_w"], pad], 1)
    out["trace"]["head_w"] = torch.cat(
        [parts["trace"]["head_w"], torch.zeros_like(pad)], 1)
    return out


# ------------------------------------------------------ against JAX's mesh


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_jax(jax64, case):
    trainer = _trainer(case, _mesh())
    assert trainer.padded_classes == 16
    state = trainer.state_from(_parts(jax64, f"{case}/start"))
    assert [tuple(c.shape) for c in state.head_w.cols] == [(64, 4)] * 4
    scores = (jax64[f"{case}/scores"] if trainer.num_sample <
              trainer.num_classes else None)
    _, port = _run(trainer, state, case, scores=scores)
    for step in range(STEPS):
        parts, loss, _ = port[step]
        want = float(jax64[f"{case}/{step}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (step, loss, want)
        share, name = _worst(parts, _parts(jax64, f"{case}/{step}"))
        assert share <= 1.0, (f"step {step + 1} {name}: {share:.3g} x "
                              f"{ATOL} + {RTOL} x max")
    if case == "full13":
        # the pad columns: no gradient, so the momentum is weight decay's
        start = _parts(jax64, "full13/start")["head_w"][:, 13:]
        first = port[0][0]["trace"]["head_w"][:, 13:]
        torch.testing.assert_close(first, 5e-4 * start, rtol=1e-12,
                                   atol=0.0)


def test_jax_mesh_overcounts_grouped_conv_gradients(jax64):
    """Why the reference's gradients are corrected: JAX's first-step
    gradient on the (2, 4) mesh is, for each grouped (depthwise) conv
    kernel, 4 times its gradient on one device, and for every other
    tensor equal to it, in float64. GSPMD keeps a program's meaning, so
    the one-device numbers are the sharded step's; the port's meshed
    step holds them (the tests above and below)."""
    grads = {k: v for k, v in jax64.items() if k.startswith("grad/")}
    grouped = [k for k in grads if k.startswith("grad/mesh/grouped/")]
    other = [k for k in grads if k.startswith("grad/mesh/other/")]
    assert len(grouped) == 8 and len(other) > 40
    for k in grouped + other:
        want = grads[k.replace("/mesh/", "/one/")]
        factor = MESH[1] if k in grouped else 1
        # atol: the analytic zeros (the project BN's shift) are 1e-15 noise
        np.testing.assert_allclose(grads[k], factor * want, rtol=1e-9,
                                   atol=1e-12, err_msg=k)


# --------------------------------------------- BatchNorm over the global batch


def _shifted_batch():
    """The 8 images with the second data shard's 4 brightened: the shards'
    means differ, so per-shard statistics are not the batch's."""
    images, _ = _batch("full13")
    images[4:] += 1.5
    return images


def test_global_batchnorm_is_what_matches_one_device(monkeypatch):
    one = _trainer("full13")
    start = TT.state_parts(one.init_state(0))
    images = _shifted_batch()
    _, want = _run(one, one.state_from(start), "full13", steps=1,
                   images=images)
    meshed = _trainer("full13", _mesh())
    padded = _padded(start, meshed.padded_classes)
    _, got = _run(meshed, meshed.state_from(padded), "full13", steps=1,
                  images=images)
    stats = {k for k in want[0][0]["backbone"] if "running" in k}
    assert len(stats) == 2 * 23
    share, name = _worst(_unpadded(got[0][0], 13), want[0][0])
    assert share <= 1.0, name
    # BatchNorm on each slot's own statistics (each slot's sum taken as
    # the whole batch's) lies far outside that bound
    monkeypatch.setattr(collectives.SlotContext, "all_sum",
                        lambda self, part: part * self.size)
    _, alone = _run(meshed, meshed.state_from(padded), "full13", steps=1,
                    images=images)
    gaps = TT.state_gaps(_unpadded(alone[0][0], 13), want[0][0], ATOL, RTOL)
    assert gaps["backbone.stem.bn.running_mean"] > 1e6
    assert sum(gaps[f"backbone.{k}"] > 1e3 for k in stats) > len(stats) / 2
    assert abs(alone[0][1] - want[0][1]) > LOSS_RTOL * abs(want[0][1])


# ------------------------------------------------- the mesh against one device


@pytest.mark.parametrize("case", ["full13", "partial_fc"])
def test_mesh_step_equals_the_one_device_step(case):
    """Partial FC drawn by the trainers themselves: one draw a step, the
    same on the mesh as on one device for the same (seed, step)."""
    one = _trainer(case)
    start = TT.state_parts(one.init_state(0))
    _, want = _run(one, one.state_from(start), case)
    meshed = _trainer(case, _mesh())
    _, got = _run(meshed, meshed.state_from(
        _padded(start, meshed.padded_classes)), case)
    c = CASES[case]["num_classes"]
    for step in range(STEPS):
        assert abs(got[step][1] - want[step][1]) <= LOSS_RTOL * abs(
            want[step][1])
        share, name = _worst(_unpadded(got[step][0], c), want[step][0])
        assert share <= 1.0, (step, name, share)


def test_remat_on_the_mesh_equals_no_remat(monkeypatch):
    """Recomputing each block in the backward pass exchanges nothing a
    second time: it takes the forward's sums. The steps are bit-equal to
    the mesh's without remat, and the statistics move once a step."""
    calls = []
    exchange = collectives.SlotGroup.all_sum
    monkeypatch.setattr(collectives.SlotGroup, "all_sum",
                        lambda self, *a: calls.append(1) or exchange(
                            self, *a))
    trainer = _trainer("full13", _mesh())
    start = TT.state_parts(trainer.init_state(0))
    _, plain = _run(trainer, trainer.state_from(start), "full13")
    n_plain = len(calls)
    trainer.remat = True
    _, remat = _run(trainer, trainer.state_from(start), "full13")
    assert len(calls) == 2 * n_plain == 2 * STEPS * MESH[0] * 2 * 23
    for (a, la, _), (b, lb, _) in zip(plain, remat):
        assert la == lb
        ta, tb = TT.state_tensors(a), TT.state_tensors(b)
        for name, x in ta.items():
            assert torch.equal(x, tb[name]), name


# --------------------------------------------------------- float32, in-process


@pytest.mark.parametrize("case", ["full13", "partial_fc"])
def test_float32_first_step_matches_jax_mesh(case):
    mesh = jmesh(MESH, ("data", "model"))
    trainer = JT.ArcFaceTrainer(model=JMobileFaceNet(JConfig(**TINY32)),
                                mesh=mesh, **_kw(case))
    start = trainer.init_state(jax.random.PRNGKey(0), (SIDE, SIDE))
    images, labels = _batch(case, np.float32)
    state, loss = trainer.train_step(start, jnp.asarray(images),
                                     jnp.asarray(labels))
    want = train_state_from_jax(jax.tree.map(np.asarray, state))
    port = _trainer(case, _mesh(), dtype=torch.float32)
    scores = torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 0),
        (CASES[case]["num_classes"],))))
    got, got_loss = port.train_step(
        port.state_from(train_state_from_jax(jax.tree.map(np.asarray,
                                                          start))),
        _nchw(images), torch.from_numpy(labels),
        scores if port.num_sample < port.num_classes else None)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    stats = got.backbone.state_dict()
    for k, v in want["backbone"].items():
        if "running" in k:
            np.testing.assert_allclose(stats[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------------------- checkpoints


def test_checkpoints_round_trip_and_restore_by_width(tmp_path):
    trainer = _trainer("full13", _mesh(), dtype=torch.float32)
    state, _ = _run(trainer, trainer.init_state(0), "full13", steps=1)
    path = str(tmp_path / "step_1.pt")
    trainer.save_checkpoint(state, path)
    back = trainer.restore_checkpoint(path)
    assert back.step == 1
    live, restored = (TT.state_tensors(TT.state_parts(s))
                      for s in (state, back))
    assert live["head_w"].shape == (64, 16)
    for name, x in live.items():
        assert torch.equal(x, restored[name]), name
    # another mesh that pads 13 classes to 16: (1, 8)
    other = _trainer("full13", parallel.make_mesh(
        (1, 8), ("data", "model"), parallel.device_slots("cpu", 8)),
        dtype=torch.float32)
    moved = other.restore_checkpoint(path)
    assert [tuple(c.shape) for c in moved.head_w.cols] == [(64, 2)] * 8
    assert torch.equal(TT.state_parts(moved)["head_w"], live["head_w"])
    # training goes on alike on both meshes
    _, a = _run(trainer, back, "full13", steps=1)
    _, b = _run(other, moved, "full13", steps=1)
    assert abs(a[0][1] - b[0][1]) <= 1e-5 * abs(a[0][1])
    # one device, and a mesh that pads to 14: other widths, refused
    for refuse in (_trainer("full13", dtype=torch.float32),
                   _trainer("full13", _mesh((4, 2)), dtype=torch.float32)):
        with pytest.raises(ValueError, match=r"\(64, 16\).*\(64, 1[34]\)"):
            refuse.restore_checkpoint(path)
    # without a pad the one-device trainer loads a meshed checkpoint
    sixteen = _trainer("full16", _mesh(), dtype=torch.float32)
    state16, _ = _run(sixteen, sixteen.init_state(0), "full16", steps=1)
    sixteen.save_checkpoint(state16, path)
    alone = _trainer("full16", dtype=torch.float32).restore_checkpoint(path)
    assert torch.equal(TT.state_parts(alone)["head_w"],
                       TT.state_parts(state16)["head_w"])
    assert set(load_inference_variables(path)) == {"params", "batch_stats"}


# ------------------------------------------------------------------ the CLIs


def test_train_arcface_cli_on_cpu_slots(tmp_path, capsys):
    from scrfd_arcface_facerecognition_tpu_torch.tools import train_arcface

    path = train_arcface.main([
        "--synthetic", "1", "--batch", "8", "--num-classes", "13",
        "--device", "cpu", "--slots", "8", "--model-shards", "2",
        "--out", str(tmp_path / "ckpt")])
    said = capsys.readouterr().out
    assert "mesh=data:4xmodel:2" in said and "classes=13" in said
    data = torch.load(path, weights_only=True)
    assert data["head_w"].shape == (512, 14) and data["step"] == 1
    with pytest.raises(SystemExit, match="--model-shards 3 does not divide "
                                         "the 8 slots"):
        train_arcface.main(["--synthetic", "1", "--device", "cpu",
                            "--slots", "8", "--model-shards", "3",
                            "--out", str(tmp_path / "no")])


# ------------------------------------------------------------ failure paths


def test_a_slot_failure_reaches_the_caller():
    """Rank 2 raises before its first exchange: the others are released
    from the barrier, and the caller gets rank 2's exception, not a
    timeout."""
    group = collectives.SlotGroup([torch.device("cpu")] * 4, timeout_s=60)

    def fn(rank):
        if rank == 2:
            raise KeyError("rank 2 failed")
        return collectives.current().all_sum(torch.ones(3))

    with pytest.raises(KeyError, match="rank 2 failed"):
        collectives.run_slots(fn, group)
    ok = collectives.run_slots(
        lambda r: collectives.current().all_sum(torch.full((2,), r + 1.0)),
        collectives.SlotGroup([torch.device("cpu")] * 4))
    assert all(torch.equal(o, torch.full((2,), 10.0)) for o in ok)
    assert collectives.current() is None


def test_a_barrier_that_waits_too_long_raises():
    group = collectives.SlotGroup([torch.device("cpu")] * 2, timeout_s=0.5)

    def fn(rank):
        if rank == 0:
            return collectives.current().all_sum(torch.ones(1))
        return None                        # never reaches the exchange

    with pytest.raises(TimeoutError, match="0.5 s"):
        collectives.run_slots(fn, group)


def test_a_batch_that_does_not_divide_the_data_axis_raises():
    trainer = _trainer("full16", _mesh(), dtype=torch.float32)
    state = trainer.init_state(0)
    images, labels = _batch("full16", np.float32)
    with pytest.raises(ValueError, match="not divisible by the 2 slots"):
        trainer.train_step(state, _nchw(images[:7]),
                           torch.from_numpy(labels[:7]))
    with pytest.raises(ValueError, match="mesh axes"):
        _trainer("full16", parallel.make_mesh(
            (2, 4), ("model", "data"), parallel.device_slots("cpu", 8)))


def parity_report():
    """For each case and step: the meshed port's largest share of the
    float64 bound against JAX's mesh, and the loss's relative gap."""
    ref = jax_reference("test_torch_train_mesh", "mesh64",
                        extra_env=CHILD_ENV)
    for case in CASES:
        trainer = _trainer(case, _mesh())
        scores = (ref[f"{case}/scores"] if trainer.num_sample <
                  trainer.num_classes else None)
        _, port = _run(trainer, trainer.state_from(
            _parts(ref, f"{case}/start")), case, scores=scores)
        line = [case]
        for step in range(STEPS):
            parts, loss, _ = port[step]
            share, name = _worst(parts, _parts(ref, f"{case}/{step}"))
            w = float(ref[f"{case}/{step}/loss"])
            line.append(f"step {step + 1}: {share:.3g} of the bound "
                        f"({name}), loss {abs(loss - w) / abs(w):.3g}")
        print("; ".join(line))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_train_mesh.py
    parity_report()
