"""The port's multi-device serving (8 ``cpu`` slots) against the JAX
package's (conftest's 8 virtual CPU devices), on the same seeded inputs.

The counterparts of ``tests/test_parallel.py``'s multi-device tests, each
holding the port to the JAX function on the same mesh shape and data:

- meshes: shapes, axis names and the hybrid layout equal;
- the sharded dense gallery: ids equal, scores within 1e-5 (also on the
  hybrid mesh, and against the numpy cosine top-k); ties across a shard
  boundary go to the lower global row;
- frame DP and disaggregation on the committed trained det_500m +
  w600k_mbf checkpoints (both packages load the same Flax trees), at the
  port's single-device pipeline tolerances (``tests/test_torch_pipeline``):
  valid, count and match_idx equal; boxes and kps within 1e-2 px; scores
  and match_sim within 1e-4; embeddings cosine >= 0.9999. Against the
  port's own unsharded call: valid, count and match_idx equal, boxes and
  kps within 1e-3 px, scores, embeddings and match_sim within 1e-5;
- the placement caches: set_gallery and an in-place weight swap reach
  every replica;
- ``realtime --disagg`` on CPU slots writes the frames ``--disagg 0``
  writes; ``initialize_distributed`` is graceful in one process and two
  gloo processes come up.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import parallel as jpar
from scrfd_arcface_facerecognition_tpu.pipeline import (
    Detector as JDetector, Embedder as JEmbedder, FacePipeline as JPipeline)
from scrfd_arcface_facerecognition_tpu_torch import parallel as tpar
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as twa
from scrfd_arcface_facerecognition_tpu_torch.parallel.sharded_gallery import (
    RowShards)
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector as TDetector, Embedder as TEmbedder, FacePipeline as TPipeline)
from test_torch_pipeline import _DET_KW, _assert_outputs_agree, _msgpack
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slots(n=8):
    return tpar.device_slots("cpu", n)


def _dense_top_k(g, q, k):
    gn = g / np.linalg.norm(g, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    sims = qn @ gn.T
    idx = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(sims, idx, 1), idx


# ---------------------------------------------------------------- meshes


def test_slots_stand_for_the_virtual_devices():
    assert jpar.local_device_count() == 8 == len(_slots())
    assert tpar.local_device_count() == torch.cuda.device_count()
    assert [s.id for s in _slots()] == list(range(8))
    assert {s.device for s in _slots()} == {torch.device("cpu")}


def test_make_mesh_shapes_match_jax():
    assert tpar.make_mesh(devices=_slots()).shape == dict(
        jpar.make_mesh().shape)
    t = tpar.make_mesh((2, 4), ("data", "model"), devices=_slots())
    j = jpar.make_mesh((2, 4), ("data", "model"))
    assert t.shape == dict(j.shape) == {"data": 2, "model": 4}
    assert t.axis_names == j.axis_names
    ids = np.vectorize(lambda s: s.id)(t.devices)
    np.testing.assert_array_equal(
        ids, np.vectorize(lambda d: d.id)(j.devices))
    assert [s.id for s in t.axis_slots("model")] == [0, 1, 2, 3]
    assert [s.id for s in t.axis_slots("data")] == [0, 4]
    with pytest.raises(ValueError, match="needs 16 devices"):
        tpar.make_mesh((16,), devices=_slots())


def test_hybrid_mesh_axes_and_layout_match_jax():
    t = tpar.make_hybrid_mesh((2, 2), ("data", "model"), num_slices=2,
                              devices=_slots())
    j = jpar.make_hybrid_mesh((2, 2), ("data", "model"), num_slices=2)
    assert t.axis_names == j.axis_names == ("replica", "data", "model")
    assert t.shape == dict(j.shape) == {"replica": 2, "data": 2, "model": 2}
    ids = np.vectorize(lambda s: s.id)(t.devices)
    np.testing.assert_array_equal(
        ids, np.vectorize(lambda d: d.id)(j.devices))
    assert ids[0].max() < ids[1].min()


# --------------------------------------------------- the sharded gallery


@pytest.mark.parametrize("g_rows,q_rows,hybrid", [(100, 7, False),
                                                  (5, 2, False),
                                                  (32, 3, True)])
def test_sharded_gallery_matches_jax_and_dense(g_rows, q_rows, hybrid):
    """ids equal to JAX's ShardedGallery and to the numpy cosine top-k,
    scores within 1e-5; 5 rows over 8 shards: padding never matches."""
    rng = np.random.default_rng(g_rows)
    g = rng.normal(size=(g_rows, 512)).astype(np.float32)
    q = rng.normal(size=(q_rows, 512)).astype(np.float32)
    if hybrid:
        tm = tpar.make_hybrid_mesh((4,), ("model",), num_slices=2,
                                   devices=_slots())
        jm = jpar.make_hybrid_mesh((4,), ("model",), num_slices=2)
    else:
        tm = tpar.make_mesh((8,), ("model",), devices=_slots())
        jm = jpar.make_mesh((8,), ("model",))
    ts, ti = tpar.ShardedGallery(g, tm, axis="model").search(q, k=5)
    js, ji = jpar.ShardedGallery(g, jm, axis="model").search(q, k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    k = min(5, g_rows)
    want_s, want_i = _dense_top_k(g, q, k)
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_allclose(ts, want_s, atol=1e-5)
    assert (ti < g_rows).all() and np.isfinite(ts).all()


def test_sharded_top_k_ties_across_shards_go_to_the_lower_row():
    """The same row at global rows 3, 9 and 14 (shards 0, 1 and 3 of 4 at
    4 rows a shard): the top-3 are 3, 9, 14 in that order, in both
    packages; ``RowShards.best`` gives row 3, as the unsharded argmax."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(16, 64)).astype(np.float32)
    g[[9, 14]] = g[3]
    q = g[3:4] + 0.01 * rng.normal(size=(1, 64)).astype(np.float32)
    tm = tpar.make_mesh((4,), ("model",), devices=_slots(4))
    jm = jpar.make_mesh((4,), ("model",), devices=jax.devices()[:4])
    ts, ti = tpar.ShardedGallery(g, tm).search(q, k=3)
    js, ji = jpar.ShardedGallery(g, jm).search(q, k=3)
    assert ti.tolist() == ji.tolist() == [[3, 9, 14]]
    assert ts[0, 0] == ts[0, 1] == ts[0, 2]
    rows = RowShards.split(torch.from_numpy(g), torch.ones(16, dtype=bool),
                           tm.axis_slots("model"))
    _, best = rows.best(torch.from_numpy(q))
    assert best.tolist() == [3]


# ------------------------------------------------------ frames over slots


def test_shard_frames_and_replicate():
    mesh = tpar.make_mesh(devices=_slots())
    frames = np.arange(8 * 4 * 4 * 3, dtype=np.uint8).reshape(8, 4, 4, 3)
    sharded = tpar.shard_frames(frames, mesh)
    assert sharded.shape == frames.shape
    assert [p.shape[0] for p in sharded.parts] == [1] * 8
    np.testing.assert_array_equal(
        torch.cat(sharded.parts).numpy(), frames)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_frames(frames[:6], mesh)
    tree = {"w": torch.ones((4, 4))}
    rep = tpar.replicate(tree, mesh)
    assert list(rep) == [torch.device("cpu")]      # one copy a device
    assert rep[torch.device("cpu")]["w"] is not tree["w"]
    torch.testing.assert_close(rep[torch.device("cpu")]["w"], tree["w"])


def test_dp_batch_math_partitioned():
    """A per-frame reduction over the parts equals the unsharded one (and
    the JAX package's jitted one over its sharded batch)."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 255, size=(8, 64, 64, 3), dtype=np.uint8)
    parts = tpar.shard_frames(frames, tpar.make_mesh(devices=_slots())).parts
    got = torch.cat([p.float().mean(dim=(1, 2, 3)) for p in parts]).numpy()
    want = np.asarray(jax.jit(
        lambda x: jnp.mean(x.astype(jnp.float32), axis=(1, 2, 3)))(
            jpar.shard_frames(frames, jpar.make_mesh())))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, frames.reshape(8, -1).mean(axis=1),
                               rtol=1e-5)


# -------------------------------------------- the pipeline over the mesh


@pytest.fixture(scope="module")
def weights():
    return _msgpack("det_500m.msgpack"), _msgpack("w600k_mbf.msgpack")


def _frames(n=8, seed=2):
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (n, 9, 16, 3)).astype(np.float32)
    return np.stack([cv2.resize(b, (320, 180)) for b in base]
                    ).clip(0, 255).astype(np.uint8)


def _pipes(weights, gallery_rows=6, seed=0):
    det_v, emb_v = weights
    jp = JPipeline(detector=JDetector("det_500m", variables=det_v, **_DET_KW),
                   embedder=JEmbedder("w600k_mbf", variables=emb_v),
                   use_pallas_warp="off", tight_canvas=True,
                   gallery_capacity=16)
    tp = TPipeline(detector=TDetector("det_500m", variables=det_v,
                                      device="cpu", **_DET_KW),
                   embedder=TEmbedder("w600k_mbf", variables=emb_v,
                                      device="cpu"),
                   tight_canvas=True, gallery_capacity=16, device="cpu")
    # the gallery: random rows, then faces of the frames, so matches happen
    first = tp(_frames())
    rng = np.random.default_rng(seed)
    gal = np.concatenate([
        rng.normal(size=(gallery_rows, 512)).astype(np.float32),
        first.embeddings[first.valid].numpy()[:6]])
    names = [f"p{i}" for i in range(len(gal))]
    jp.set_gallery(gal, names)
    tp.set_gallery(gal, names)
    return jp, tp


@pytest.fixture(scope="module")
def pipes(weights):
    return _pipes(weights)


def _same_as_unsharded(got, want):
    """The port's sharded call against its unsharded one: valid, count and
    match_idx equal; boxes and kps within 1e-3 px; scores, embeddings and
    match_sim within 1e-5 (the CPU's convolutions round a batch of one
    frame a little differently from a batch of eight)."""
    for name in ("valid", "count", "match_idx"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=0, msg=name)
    for name, tol in (("boxes", 1e-3), ("kps", 1e-3), ("scores", 1e-5),
                      ("embeddings", 1e-5), ("match_sim", 1e-5)):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=tol, msg=name)


def test_dp_pipeline_on_the_mesh_matches_jax(pipes):
    """8 frames over 8 slots, against the JAX pipeline over its 8 virtual
    devices, and against the port's unsharded call; __call__ and
    process_stream both; every part warped through K1's wrapper."""
    jp, tp = pipes
    frames = _frames()
    mesh = tpar.make_mesh(devices=_slots())
    want = jp(jpar.shard_frames(jnp.asarray(frames), jpar.make_mesh()))
    calls = []
    crops = twa.warp_align_crops

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return crops(*a, **k)

    from scrfd_arcface_facerecognition_tpu_torch.pipeline import embedder
    orig = embedder.ops.warp_align_crops
    embedder.ops.warp_align_crops = counted
    try:
        got = tp(tpar.shard_frames(frames, mesh))
    finally:
        embedder.ops.warp_align_crops = orig
    assert calls == [1] * 8          # one K1 call a slot, a frame each
    assert (got.match_idx.numpy() >= 6).sum() > 0       # real matches
    _assert_outputs_agree(want, got)
    _same_as_unsharded(got, tp(frames))
    assert tp.match_names(got) == jp.match_names(want)
    # the stream keeps its order; unbucketed gives the same outputs
    batches = [frames, frames[::-1].copy()]
    streamed = list(tp.process_stream(
        (tpar.shard_frames(b, mesh) for b in batches), depth=2))
    for out, b in zip(streamed, batches):
        _same_as_unsharded(out, tp(b))
    _same_as_unsharded(tp(tpar.shard_frames(frames, mesh), bucketed=False),
                       tp(frames))


def test_dp_call_dynamic_on_the_mesh(pipes):
    """call_dynamic over sharded frames: the per-image letterbox arrays
    split with the frames; equal to the unsharded call."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    _, tp = pipes
    frames = _frames(4, seed=5)
    b, h, w = frames.shape[:3]
    wy, wx, scale = ops.letterbox_matrices((h, w), (h, w),
                                           tp.detector.input_size)
    args = (np.stack([wy] * b), np.stack([wx] * b),
            np.full(b, scale, np.float32), np.tile([h, w], (b, 1)))
    mesh = tpar.make_mesh((4,), devices=_slots(4))
    got = tp.call_dynamic(tpar.shard_frames(frames, mesh), *args)
    _same_as_unsharded(got, tp.call_dynamic(frames, *args))


def test_set_gallery_invalidates_dp_placement_cache(weights):
    """set_gallery after a multi-slot run drops the cached copies, and the
    next run matches against the new gallery."""
    _, tp = _pipes(weights)
    frames = _frames()
    mesh = tpar.make_mesh(devices=_slots())
    tp(tpar.shard_frames(frames, mesh))
    assert tp._replicas["gallery"].copies, "expected a cached placement"
    rng = np.random.default_rng(0)
    out0 = tp(frames)
    new_g = np.concatenate([out0.embeddings[out0.valid].numpy()[:2],
                            rng.normal(size=(1, 512)).astype(np.float32)])
    tp.set_gallery(new_g, ["a", "b", "c"])
    assert not any(r.copies for r in tp._replicas.values())
    got = tp(tpar.shard_frames(frames, mesh))
    _same_as_unsharded(got, tp(frames))
    assert set(got.match_idx[got.valid].tolist()) >= {0, 1}


def test_in_place_weight_swap_reaches_every_replica(weights):
    """load_state_dict into the live detector and embedder (the train ->
    serve swap) after a DP and a disaggregated run: both re-place and
    equal the unsharded call on the new weights."""
    _, tp = _pipes(weights)
    frames = _frames()
    mesh = tpar.make_mesh(devices=_slots())
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(
        devices=_slots()), shard_gallery=True)
    tp(tpar.shard_frames(frames, mesh))
    server(frames)
    before = tp(frames)
    torch.manual_seed(0)
    with torch.no_grad():
        for model in (tp.detector.model, tp.embedder.model):
            state = {k: (v * 1.05 if v.is_floating_point() else v)
                     for k, v in model.state_dict().items()}
            model.load_state_dict(state)
    after = tp(frames)
    assert not torch.equal(after.embeddings, before.embeddings)
    _same_as_unsharded(tp(tpar.shard_frames(frames, mesh)), after)
    _same_as_unsharded(server(frames), after)


# ------------------------------------------------------- disaggregation


def test_disagg_matches_colocated(pipes):
    """Detect on slots 0-3, embed on 4-7, the gallery replicated: equal to
    JAX's DisaggPipeline and to the port's co-located call; the weights
    are copies, the detector's on the detect slots' devices only and the
    embedder's on the embed slots'."""
    jp, tp = pipes
    frames = _frames()
    det_g, emb_g = tpar.split_devices(devices=_slots())
    assert [s.id for s in det_g] == [0, 1, 2, 3]
    assert [s.id for s in emb_g] == [4, 5, 6, 7]
    server = tpar.DisaggPipeline(tp, det_g, emb_g)
    got = server(frames)
    want = jpar.DisaggPipeline(jp, *jpar.split_devices())(frames)
    _assert_outputs_agree(want, got)
    _same_as_unsharded(got, tp(frames))
    assert [s.id for s in server.det_mesh.devices.flat] == [0, 1, 2, 3]
    assert [s.id for s in server.emb_mesh.devices.flat] == [4, 5, 6, 7]
    det_copy = server._det.copies[torch.device("cpu")]
    emb_copy = server._emb.copies[torch.device("cpu")]
    assert det_copy is not tp.detector.model
    assert emb_copy is not tp.embedder.model
    assert set(server._det.copies) == {s.device for s in det_g}
    assert set(server._emb.copies) == {s.device for s in emb_g}


def test_disagg_sharded_gallery_matches_colocated(weights):
    """The gallery row-sharded over the embed group: match_idx equal,
    match_sim within 1e-5 of the co-located call and of JAX's; each embed
    slot holds 1 / 4 of the (padded) rows."""
    jp, tp = _pipes(weights, gallery_rows=8, seed=11)
    frames = _frames()
    det_g, emb_g = tpar.split_devices(devices=_slots())
    server = tpar.DisaggPipeline(tp, det_g, emb_g, shard_gallery=True)
    got = server(frames)
    want = jpar.DisaggPipeline(jp, *jpar.split_devices(),
                               shard_gallery=True)(frames)
    _assert_outputs_agree(want, got)
    _same_as_unsharded(got, tp(frames))
    placed = server._gallery_placed()
    assert isinstance(placed, RowShards)
    assert [s.id for s in placed.slots] == [s.id for s in emb_g]
    assert {r.shape[0] for r in placed.rows} == {16 // 4}


def test_disagg_shard_auto_thresholds_on_bytes(pipes, monkeypatch):
    _, tp = pipes
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(devices=_slots()),
                                 shard_gallery="auto")
    assert isinstance(server._gallery_placed(), dict)    # replicated
    monkeypatch.setattr(tpar.DisaggPipeline, "SHARD_AUTO_BYTES", 1024)
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(devices=_slots()),
                                 shard_gallery="auto")
    assert isinstance(server._gallery_placed(), RowShards)


def test_disagg_stream_pipelines_batches(pipes):
    """2 detect slots, 6 embed slots, 4 batches of 6 frames at depth 2:
    each output equals JAX's DisaggPipeline stream and the port's
    co-located call on its batch."""
    jp, tp = pipes
    rng = np.random.default_rng(8)
    batches = [_frames(6, seed=int(s)) for s in rng.integers(0, 99, 4)]
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(
        n_det=2, devices=_slots()))
    jserver = jpar.DisaggPipeline(jp, *jpar.split_devices(n_det=2))
    outs = list(server.process_stream(iter(batches), depth=2))
    wants = list(jserver.process_stream(iter(batches), depth=2))
    assert len(outs) == 4
    for o, w, b in zip(outs, wants, batches):
        _assert_outputs_agree(w, o)
        _same_as_unsharded(o, tp(b))


def test_disagg_set_gallery_repicks_placement(weights):
    _, tp = _pipes(weights)
    frames = _frames()
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(devices=_slots()))
    server(frames)
    first = server._gallery_placed()
    rng = np.random.default_rng(9)
    tp.set_gallery(rng.normal(size=(3, 512)).astype(np.float32),
                   ["a", "b", "c"])
    _same_as_unsharded(server(frames), tp(frames))
    placed = server._gallery_placed()
    assert placed is not first
    torch.testing.assert_close(placed[torch.device("cpu")][0][:3],
                               tp._gallery[:3], rtol=0, atol=0)


def test_disagg_rejects_bad_configs(pipes):
    _, tp = pipes
    slots = _slots()
    with pytest.raises(ValueError, match="overlap"):
        tpar.DisaggPipeline(tp, slots[:5], slots[4:])
    with pytest.raises(ValueError, match="non-empty"):
        tpar.split_devices(n_det=8, devices=slots)
    with pytest.raises(ValueError, match="at least 2 devices"):
        tpar.split_devices(devices=slots[:1])
    with pytest.raises(ValueError, match="shard_gallery"):
        tpar.DisaggPipeline(tp, slots[:4], slots[4:], shard_gallery="x")
    server = tpar.DisaggPipeline(tp, *tpar.split_devices(devices=slots))
    with pytest.raises(ValueError, match="not divisible"):
        server(_frames(6))


# ------------------------------------------------------ realtime --disagg


def test_realtime_disagg_writes_the_frames_disagg_0_writes(weights, tmp_path,
                                                           monkeypatch):
    """The app on a 7-frame clip at --batch 3 (the last batch partial):
    --disagg 2 over 4 CPU slots (batches padded to 2 and cut back) writes
    every frame as --disagg 0 does; one slot raises the JAX message."""
    import cv2
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime as trt
    from test_torch_realtime import write_clip

    _, tp = _pipes(weights)
    clip = _frames(7, seed=4)
    video = write_clip(tmp_path / "in.mp4", list(clip))
    faces = tmp_path / "faces"
    faces.mkdir()
    cv2.imwrite(str(faces / "ann.png"), clip[0])
    monkeypatch.setattr(trt, "app_pipeline", lambda params, device: tp)
    written = []

    class Writer:
        def __init__(self, *a):
            written.append([])

        def write(self, frame):
            written[-1].append(frame.copy())

        def release(self):
            pass

    monkeypatch.setattr(trt, "open_writer", Writer)
    args = ["--source", video, "--faces-dir", str(faces), "--batch", "3",
            "--output", str(tmp_path / "o.mp4")]
    for extra, devices in (([], None), (["--disagg", "2"], _slots(4))):
        random.seed(0)                       # the names' drawing colours
        res = trt.run(trt.parse_args(args + extra), device="cpu",
                      devices=devices)
        assert res == {"frames": 7, "targets": 1}
    assert len(written[0]) == len(written[1]) == 7
    for a, b in zip(*written):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="at least 2 devices"):
        trt.run(trt.parse_args(args + ["--disagg", "1"]), device="cpu",
                devices=_slots(1))


# ---------------------------------------------------------- the bootstrap


def test_initialize_distributed_single_process_is_graceful(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tpar.initialize_distributed() is False
    assert jpar.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


_CHILD = """
import sys, torch
from scrfd_arcface_facerecognition_tpu_torch.parallel import (
    initialize_distributed)
up = initialize_distributed(sys.argv[1], 2, int(sys.argv[2]),
                            backend="gloo", timeout_s=30)
x = torch.tensor([float(sys.argv[2]) + 1.0])
torch.distributed.all_reduce(x)
print(up, float(x))
torch.distributed.destroy_process_group()
"""


def test_two_gloo_processes_come_up():
    """Two CPU processes join one group through ``initialize_distributed``
    (gloo, a free localhost port) and all-reduce within 60 s."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, f"localhost:{port}", str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "3.0"], out
