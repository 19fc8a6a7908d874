"""The port's SCRFD trainer steps against the JAX package's, on the CPU, in
float64 (the setting and the batches of ``tests/test_torch_scrfd_train.py``).

Both trainers start from one state: the JAX ``init_state`` carried across
with ``scrfd_train_state_from_jax``. The steps are compared in float64 on
both sides (JAX under x64 in a child process, its head's float32 pins on
the outputs taken to float64; the port with ``dtype=torch.float64``), as
the ArcFace trainer's are (``tests/test_torch_train.py``): training-mode
BatchNorm in the backbone and the neck and GroupNorm in the head make some
gradients small sums of large terms, which float32 rounding moves by
percents. After each of three steps every tensor (weights, batch
statistics, momentum) is held within ``ATOL + RTOL * max |JAX's|`` =
1e-12 + 1e-10 * max, the loss and its metrics within 1e-11 relative and
``n_pos`` equal; the port's float32 step lies far past that bound
(``test_the_bound_tells_float64_from_float32``). Cases: a constant
learning rate, a warmup (the first update moves nothing), and a batch
whose faces are partly unlabeled (``gt_kps_valid``).

Measured: ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_scrfd_steps.py`` prints each case's worst share of the
bound (root ``PERF.md`` §6 records it).
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.parallel import make_mesh
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    scrfd_train_state_from_jax)
from scrfd_arcface_facerecognition_tpu_torch import train as TT
from test_torch_bf16 import jax_reference
from test_torch_scrfd_train import (CASES, CFG_T, _batch, _jax_trainer,
                                    _nchw, _port_model)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

STEPS = 3
ATOL, RTOL, LOSS_RTOL = 1e-12, 1e-10, 1e-11


class _Float64Jnp:
    """``jax.numpy`` whose ``float32`` is ``float64``: put in place of the
    ``jnp`` of the JAX detector, whose head pins its outputs to float32, it
    runs them in double."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _put_parts(out, prefix, state):
    parts = scrfd_train_state_from_jax(jax.tree.map(np.asarray, state))
    for name, t in TT.state_tensors(parts).items():
        out[f"{prefix}/{name}"] = t.numpy()
    out[f"{prefix}/step"] = np.asarray(parts["step"])


def _job_steps64():
    """In the child (``JAX_ENABLE_X64=1``): JAX's trainer in double, every
    case from its float32 ``init_state``: the start, the state after each
    step, the losses and n_pos."""
    assert jax.config.jax_enable_x64
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    runs, made = {}, {}
    for case, kw in CASES.items():   # the float32 trainer's start, in double
        key = tuple(sorted(kw.items()))
        if key not in made:          # one trainer (one compile) a schedule
            trainer = _jax_trainer(mesh, jnp.float64, **kw)
            made[key] = trainer, jax.tree.map(
                lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32
                else a, trainer.init_state(jax.random.PRNGKey(0)))
        runs[case] = made[key]
    importlib.import_module(
        "scrfd_arcface_facerecognition_tpu.models.scrfd").jnp = _Float64Jnp()
    out = {}
    for case, (trainer, state) in runs.items():
        images, boxes, kps, valid, kvalid = _batch(case, dtype=np.float64)
        _put_parts(out, f"{case}/start", state)
        for step in range(STEPS):
            state, loss, metrics = trainer.train_step(
                state, jnp.asarray(images), jnp.asarray(boxes),
                jnp.asarray(kps), jnp.asarray(valid),
                None if kvalid is None else jnp.asarray(kvalid))
            _put_parts(out, f"{case}/{step}", state)
            out[f"{case}/{step}/loss"] = np.asarray(loss)
            out[f"{case}/{step}/n_pos"] = np.asarray(metrics["n_pos"])
            for k in ("cls", "box", "kps"):
                out[f"{case}/{step}/{k}"] = np.asarray(metrics[k])
    return out


@pytest.fixture(scope="module")
def jax64():
    ref = jax_reference("test_torch_scrfd_steps", "steps64",
                        extra_env={"JAX_ENABLE_X64": "1"})
    assert ref["constant/0/model.head.cls.weight"].dtype == np.float64
    return ref


def _parts(ref, prefix):
    """The port trainer's parts of JAX's state at ``prefix``."""
    parts = {"model": {}, "trace": {}, "step": int(ref[f"{prefix}/step"])}
    for key, arr in ref.items():
        if not key.startswith(prefix + "/"):
            continue
        name = key[len(prefix) + 1:]
        kind, _, rest = name.partition(".")
        if kind in parts and rest:
            parts[kind][rest] = torch.from_numpy(arr)
    return parts


def _port_run(ref, case, dtype=torch.float64):
    """The port's ``STEPS`` steps from JAX's start: (trainer, [(the state's
    parts, loss, metrics) a step])."""
    trainer = TT.SCRFDTrainer(model=_port_model(), loss_cfg=CFG_T,
                              device="cpu", dtype=dtype, **CASES[case])
    state = trainer.state_from(_parts(ref, f"{case}/start"))
    images, boxes, kps, valid, kvalid = _batch(case, dtype=np.float64)
    out = []
    for _ in range(STEPS):
        state, loss, metrics = trainer.train_step(
            state, _nchw(images), torch.from_numpy(boxes),
            torch.from_numpy(kps), torch.from_numpy(valid),
            None if kvalid is None else torch.from_numpy(kvalid))
        out.append((TT.state_parts(state), float(loss), metrics))
    return trainer, out


def _worst(port_parts, ref, prefix):
    gaps = TT.state_gaps(port_parts, _parts(ref, prefix), ATOL, RTOL)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(jax64, case):
    _, port = _port_run(jax64, case)
    for step in range(STEPS):
        parts, loss, metrics = port[step]
        want = float(jax64[f"{case}/{step}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (step, loss, want)
        assert int(metrics["n_pos"]) == int(jax64[f"{case}/{step}/n_pos"])
        for k in ("cls", "box", "kps"):
            w = float(jax64[f"{case}/{step}/{k}"])
            assert abs(float(metrics[k]) - w) <= LOSS_RTOL * abs(w), k
        share, name = _worst(parts, jax64, f"{case}/{step}")
        assert share <= 1.0, (f"step {step + 1} {name}: {share:.3g} x "
                              f"{ATOL} + {RTOL} x max")
    if case == "warmup":         # lr(0) = 0: the first update moves nothing
        first, start = port[0][0], _parts(jax64, "warmup/start")
        for name, p in start["model"].items():
            if "running" not in name:
                assert torch.equal(first["model"][name], p), name
        assert max(float(v.abs().max())
                   for v in first["trace"].values()) > 0


def test_the_bound_tells_float64_from_float32(jax64):
    """The port's float32 step from the same start is far past the float64
    bound: the bound catches a step that loses precision."""
    _, port = _port_run(jax64, "constant", dtype=torch.float32)
    share, _ = _worst(port[0][0], jax64, "constant/0")
    assert share > 1e3
    want = float(jax64["constant/0/loss"])
    assert abs(port[0][1] - want) > LOSS_RTOL * abs(want)


def parity_report():
    """The numbers the module docstring points to: for each case and step,
    the float64 port's largest share of its bound, its largest gap and the
    loss's relative difference; the float32 step's share of the bound."""
    ref = jax_reference("test_torch_scrfd_steps", "steps64",
                        extra_env={"JAX_ENABLE_X64": "1"})
    for case in CASES:
        _, port = _port_run(ref, case)
        line = [case]
        for step in range(STEPS):
            parts, loss, _ = port[step]
            want = _parts(ref, f"{case}/{step}")
            share, name = _worst(parts, ref, f"{case}/{step}")
            gap = max(TT.state_gaps(parts, want, 1.0, 0.0).values())
            w = float(ref[f"{case}/{step}/loss"])
            line.append(f"step {step + 1}: {share:.3g} of the bound "
                        f"({name}), gap {gap:.3g}, loss "
                        f"{abs(loss - w) / abs(w):.3g}")
        print("; ".join(line))
    _, f32 = _port_run(ref, "constant", dtype=torch.float32)
    print(f"float32 step 1: {_worst(f32[0][0], ref, 'constant/0')[0]:.3g} x "
          f"the float64 bound")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests \
    #     python tests/test_torch_scrfd_steps.py
    parity_report()
