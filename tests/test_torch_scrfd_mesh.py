"""The port's meshed SCRFD trainer against the JAX package's, on the CPU.

JAX's ``SCRFDTrainer`` on a (4,) 'data' mesh over conftest's virtual CPU
devices; the port's on ``make_mesh((4,), ("data",), device_slots("cpu",
4))``: one image a slot, each slot's detector in a thread of its own, its
BatchNorm over the global batch, ATSS on each slot's own images, and the
three loss terms divided by the whole batch's ``n_pos`` / ``n_kps``. The
tiny detector and the 64 x 64 loss configuration of
``tests/test_torch_scrfd_train.py``; a seeded batch of 4 images whose
shards hold 1, 3, 3 and 3 faces. Both trainers start from JAX's
``init_state`` carried across with ``scrfd_train_state_from_jax``.

The steps are compared in float64 on both sides, as in
``tests/test_torch_scrfd_steps.py`` (JAX under x64 in a child process whose
``XLA_FLAGS`` keep the virtual devices, the head's float32 pins taken to
float64): after each of three steps every tensor within 1e-12 + 1e-10 x
max |JAX's|, the loss and its metrics within 1e-11 relative, ``n_pos``
equal. Cases: a constant learning rate, and faces partly unlabeled (the
first shard's only face among them: that slot counts no landmark). The
port's meshed step is also held to its one-device step at the same bound,
and at float32 the first step's loss and batch statistics to JAX's
float32 meshed step (1e-5 relative; 1e-6 + 1e-6 relative), in this
process on conftest's devices. JAX's (4,)-mesh gradients are its
one-device gradients (held here in float64), so its steps need no
correction, unlike the (2, 4) ArcFace mesh of
``tests/test_torch_train_mesh.py``.

Measured: ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_scrfd_mesh.py`` prints each case's worst share of the
bound (root ``PERF.md`` §6 records it).
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.parallel import make_mesh as jmesh
from scrfd_arcface_facerecognition_tpu.train import scrfd_train as JS
from scrfd_arcface_facerecognition_tpu_torch import parallel
from scrfd_arcface_facerecognition_tpu_torch import train as TT
from scrfd_arcface_facerecognition_tpu_torch.models.checkpoints import (
    load_inference_variables)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    scrfd_train_state_from_jax)
from test_torch_bf16 import jax_reference
from test_torch_scrfd_steps import (ATOL, LOSS_RTOL, RTOL, STEPS,
                                    _Float64Jnp, _parts, _put_parts)
from test_torch_scrfd_train import (CFG_T, SIZE, _jax_trainer, _nchw,
                                    _port_model)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

SLOTS = 4
CHILD_ENV = {"JAX_ENABLE_X64": "1",
             "XLA_FLAGS": "--xla_allow_excess_precision=false "
                          "--xla_force_host_platform_device_count=8"}
CASES = ("constant", "unlabeled")
LR = 0.05


def _batch(case="constant", dtype=np.float64):
    """(images NHWC, gt_boxes, gt_kps, gt_valid, gt_kps_valid or None): 4
    seeded images of 1, 3, 3 and 3 faces; "unlabeled" takes the landmarks
    of the first image's face and of the second image's faces away."""
    images, boxes, kps, valid = JS.synthetic_detection_batch(
        np.random.default_rng(0), SLOTS, SIZE, max_gt=3)
    assert valid.sum(1).tolist() == [1, 3, 3, 3]
    kvalid = None
    if case == "unlabeled":
        kvalid = valid.copy()
        kvalid[0, 0] = kvalid[1, :] = False
    return images.astype(dtype), boxes.astype(dtype), kps.astype(dtype), \
        valid, kvalid


def _job_mesh64():
    """In the child (x64, virtual devices): JAX's trainer on the (4,) mesh
    in double from its float32 ``init_state``: the start, the state after
    each step, the loss, its metrics and n_pos; the first step's gradients
    on the mesh and on one device."""
    assert jax.config.jax_enable_x64
    mesh = jmesh((SLOTS,), ("data",), devices=jax.devices()[:SLOTS])
    trainer = _jax_trainer(mesh, jnp.float64, learning_rate=LR)
    start = jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        trainer.init_state(jax.random.PRNGKey(0)))
    importlib.import_module(
        "scrfd_arcface_facerecognition_tpu.models.scrfd").jnp = _Float64Jnp()
    out = {}
    images, boxes, kps, valid, _ = _batch()
    one = jmesh((1,), ("data",), devices=jax.devices()[:1])
    for name, m in (("mesh", mesh), ("one", one)):
        t = _jax_trainer(m, jnp.float64, learning_rate=LR)
        grads = jax.jit(jax.grad(lambda *a: t._loss_fn(*a)[0]))(
            start.variables["params"], start.variables["batch_stats"],
            *(jnp.asarray(a) for a in (images, boxes, kps, valid, valid)))
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"grad/{name}/{jax.tree_util.keystr(path)}"] = np.asarray(g)
    for case in CASES:
        images, boxes, kps, valid, kvalid = _batch(case)
        state = start
        _put_parts(out, f"{case}/start", state)
        for step in range(STEPS):
            state, loss, metrics = trainer.train_step(
                state, jnp.asarray(images), jnp.asarray(boxes),
                jnp.asarray(kps), jnp.asarray(valid),
                None if kvalid is None else jnp.asarray(kvalid))
            _put_parts(out, f"{case}/{step}", state)
            out[f"{case}/{step}/loss"] = np.asarray(loss)
            for k in ("cls", "box", "kps", "n_pos"):
                out[f"{case}/{step}/{k}"] = np.asarray(metrics[k])
    return out


@pytest.fixture(scope="module")
def jax64():
    ref = jax_reference("test_torch_scrfd_mesh", "mesh64",
                        extra_env=CHILD_ENV)
    assert ref["constant/0/model.head.cls.weight"].dtype == np.float64
    return ref


def _mesh():
    return parallel.make_mesh((SLOTS,), ("data",),
                              parallel.device_slots("cpu", SLOTS))


def _trainer(mesh=None, dtype=torch.float64):
    return TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T, dtype=dtype,
                           learning_rate=LR, mesh=mesh,
                           device="cpu" if mesh is None else None)


def _run(trainer, state, case, steps=STEPS, dtype=np.float64):
    """``steps`` updates: [(the state's parts, loss, metrics)] a step."""
    images, boxes, kps, valid, kvalid = _batch(case, dtype)
    out = []
    for _ in range(steps):
        state, loss, metrics = trainer.train_step(
            state, _nchw(images), torch.from_numpy(boxes),
            torch.from_numpy(kps), torch.from_numpy(valid),
            None if kvalid is None else torch.from_numpy(kvalid))
        out.append((TT.state_parts(state), float(loss), metrics))
    return state, out


def _worst(got, want):
    gaps = TT.state_gaps(got, want, ATOL, RTOL)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


@pytest.mark.parametrize("case", CASES)
def test_mesh_steps_match_jax(jax64, case):
    trainer = _trainer(_mesh())
    _, port = _run(trainer, trainer.state_from(_parts(jax64,
                                                      f"{case}/start")), case)
    for step in range(STEPS):
        parts, loss, metrics = port[step]
        want = float(jax64[f"{case}/{step}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (step, loss, want)
        assert int(metrics["n_pos"]) == int(jax64[f"{case}/{step}/n_pos"])
        for k in ("cls", "box", "kps"):
            w = float(jax64[f"{case}/{step}/{k}"])
            assert abs(float(metrics[k]) - w) <= LOSS_RTOL * abs(w), k
        share, name = _worst(parts, _parts(jax64, f"{case}/{step}"))
        assert share <= 1.0, (f"step {step + 1} {name}: {share:.3g} x "
                              f"{ATOL} + {RTOL} x max")


def test_jax_data_mesh_keeps_the_global_step(jax64):
    grads = {k: v for k, v in jax64.items() if k.startswith("grad/mesh/")}
    assert len(grads) > 50
    for k, g in grads.items():
        np.testing.assert_allclose(g, jax64[k.replace("/mesh/", "/one/")],
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_equals_the_one_device_step(case):
    """The meshed step is the one-device step; a step that averaged the
    slots' own losses (each over its own counts) would not be."""
    one = _trainer()
    start = TT.state_parts(one.init_state(0))
    _, want = _run(one, one.state_from(start), case)
    meshed = _trainer(_mesh())
    _, got = _run(meshed, meshed.state_from(start), case)
    for step in range(STEPS):
        assert abs(got[step][1] - want[step][1]) <= LOSS_RTOL * abs(
            want[step][1])
        assert int(got[step][2]["n_pos"]) == int(want[step][2]["n_pos"])
        share, name = _worst(got[step][0], want[step][0])
        assert share <= 1.0, (step, name, share)
    # the slots' own losses, averaged: far from the global loss
    model = one.state_from(start).model.train()
    images, boxes, kps, valid, kvalid = _batch(case)
    kvalid = valid if kvalid is None else kvalid
    with torch.no_grad():
        mean = sum(float(TT.scrfd_loss(
            model(_nchw(images[i:i + 1])), torch.from_numpy(boxes[i:i + 1]),
            torch.from_numpy(kps[i:i + 1]), torch.from_numpy(valid[i:i + 1]),
            CFG_T, torch.from_numpy(kvalid[i:i + 1]))[0])
            for i in range(SLOTS)) / SLOTS
    assert abs(mean - want[0][1]) > 1e-3 * abs(want[0][1])


def test_float32_first_step_matches_jax_mesh():
    mesh = jmesh((SLOTS,), ("data",), devices=jax.devices()[:SLOTS])
    trainer = _jax_trainer(mesh, learning_rate=LR)
    start = trainer.init_state(jax.random.PRNGKey(0))
    images, boxes, kps, valid, kvalid = _batch("unlabeled", np.float32)
    state, loss, metrics = trainer.train_step(
        start, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(kps),
        jnp.asarray(valid), jnp.asarray(kvalid))
    want = scrfd_train_state_from_jax(jax.tree.map(np.asarray, state))
    port = _trainer(_mesh(), dtype=torch.float32)
    got, got_loss, got_metrics = port.train_step(
        port.state_from(scrfd_train_state_from_jax(
            jax.tree.map(np.asarray, start))), _nchw(images),
        torch.from_numpy(boxes), torch.from_numpy(kps),
        torch.from_numpy(valid), torch.from_numpy(kvalid))
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert int(got_metrics["n_pos"]) == int(metrics["n_pos"])
    stats = got.model.state_dict()
    for k, v in want["model"].items():
        if "running" in k:
            np.testing.assert_allclose(stats[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_train_scrfd_cli_on_cpu_slots(tmp_path, capsys):
    from scrfd_arcface_facerecognition_tpu_torch.tools import train_scrfd

    path = train_scrfd.main([
        "--synthetic", "1", "--batch", "8", "--input-size", "64",
        "--max-gt", "3", "--device", "cpu", "--slots", "8",
        "--out", str(tmp_path / "ckpt")])
    said = capsys.readouterr().out
    assert "mesh=data:8" in said and "n_pos" in said
    assert set(load_inference_variables(path)) == {"params", "batch_stats"}
    with pytest.raises(ValueError, match="not divisible by the 8 slots"):
        train_scrfd.main(["--synthetic", "1", "--batch", "4",
                          "--input-size", "64", "--device", "cpu",
                          "--slots", "8", "--out", str(tmp_path / "no")])


def parity_report():
    """For each case and step: the meshed port's largest share of the
    float64 bound against JAX's (4,) mesh, and the loss's relative gap."""
    ref = jax_reference("test_torch_scrfd_mesh", "mesh64",
                        extra_env=CHILD_ENV)
    for case in CASES:
        trainer = _trainer(_mesh())
        _, port = _run(trainer, trainer.state_from(
            _parts(ref, f"{case}/start")), case)
        line = [case]
        for step in range(STEPS):
            parts, loss, _ = port[step]
            share, name = _worst(parts, _parts(ref, f"{case}/{step}"))
            w = float(ref[f"{case}/{step}/loss"])
            line.append(f"step {step + 1}: {share:.3g} of the bound "
                        f"({name}), loss {abs(loss - w) / abs(w):.3g}")
        print("; ".join(line))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_scrfd_mesh.py
    parity_report()
