"""The port's DecodePool (``runtime/decode_pool.py``) against the JAX
package's.

- On the same cv2-written clips the two pools give the same rounds, bit
  for bit: 3 streams over 2 workers, 4 streams over one worker, a source
  that does not open, streams of two sizes one of which ends early
  (``stream_dims`` and ``stream_fps`` too). Each stream's frames arrive
  complete and in order.
- The behaviours of ``tests/test_decode_pool.py`` on both pools: release
  mid-stream, several stalled streams sharing one timeout, the startup
  grace, a dead worker not waited on.
- Where the port differs on purpose: a stream that is still connecting
  (its worker alive, no frame yet) does not hold a healthy stream's
  rounds once the pool's first ``timeout_ms`` has passed. The JAX pool
  waits out ``timeout_ms`` on every round while it connects.
- The ``opener`` seam: the port's workers call it in their own process,
  and a worker has not imported torch.

Every wait is bounded: a pool's rounds are read under a deadline and its
workers are joined with a timeout.
"""
import os
import queue
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pool_openers  # noqa: E402
from scrfd_arcface_facerecognition_tpu.runtime import decode_pool as jdp
from scrfd_arcface_facerecognition_tpu_torch.runtime import decode_pool as tdp
from scrfd_arcface_facerecognition_tpu_torch.runtime.video import (
    open_capture)

N, W, H = 48, 320, 240          # the long clip
N2, W2, H2 = 20, 256, 192       # the short clip, another size


def _write(path, n, w, h, fps, base):
    import cv2

    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not wr.isOpened():
        pytest.skip("cv2.VideoWriter cannot write mp4v here")
    for i in range(n):
        # each frame's index in its pixel values: the mean maps it back
        wr.write(np.full((h, w, 3), (base + i * 4) % 251, np.uint8))
    wr.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    return (_write(str(d / "long.mp4"), N, W, H, 24, 0),
            _write(str(d / "short.mp4"), N2, W2, H2, 30, 2))


def ref_frames(path):
    cap = open_capture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def frame_index(frame, frames):
    means = np.array([f.mean() for f in frames])
    return int(np.abs(means - float(frame.mean())).argmin())


def read_rounds(pool, limit_s=60.0, stop_after=None):
    """The pool's rounds as (batch, ids, seconds the round took), read
    under a deadline; the pool is released afterwards."""
    rounds = []
    deadline = time.monotonic() + limit_s
    try:
        it = iter(pool)
        while time.monotonic() < deadline:
            t = time.monotonic()
            try:
                batch, ids = next(it)
            except StopIteration:
                break
            rounds.append((batch.copy(), list(ids), time.monotonic() - t))
            if stop_after and len(rounds) >= stop_after:
                break
        else:
            pytest.fail(f"the pool's rounds ran past {limit_s} s")
    finally:
        pool.release(join_timeout=1.0)
    assert not any(p.is_alive() for p in pool._procs)
    return rounds


POOLS = {"jax": jdp.DecodePool, "port": tdp.DecodePool}


@pytest.fixture(params=["jax", "port"])
def impl(request):
    return POOLS[request.param]


# ----------------------------------------------- same rounds, bit for bit


CASES = {
    "3 streams, 2 workers": (lambda a, b: [a, a, a], 2),
    "4 streams, 1 worker": (lambda a, b: [a, a, a, a], 1),
    "a source that does not open": (lambda a, b: [a, "/nonexistent/no.mp4"],
                                    1),
    "two sizes, one ends early": (lambda a, b: [a, b, a], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_rounds_as_the_jax_pool(clips, case):
    make, workers = CASES[case]
    sources = make(*clips)
    long_ref, short_ref = ref_frames(clips[0]), ref_frames(clips[1])
    assert len(long_ref) == N and len(short_ref) == N2
    got = {}
    for name, cls in POOLS.items():
        pool = cls(sources, workers=workers, slot_bytes=W * H * 3,
                   timeout_ms=8000)
        got[name] = (read_rounds(pool), dict(pool.stream_dims),
                     dict(pool.stream_fps))
    (jr, jdims, jfps), (tr, tdims, tfps) = got["jax"], got["port"]
    assert [ids for _, ids, _ in tr] == [ids for _, ids, _ in jr]
    for (jb, _, _), (tb, _, _) in zip(jr, tr):
        np.testing.assert_array_equal(tb, jb)
    assert tdims == jdims and tfps == jfps
    # every stream's every frame, in order, at the stream's own size
    seq = {}
    for batch, ids, _ in tr:
        for bi, sid in enumerate(ids):
            ref = short_ref if sources[sid] == clips[1] else long_ref
            fh, fw = ref[0].shape[:2]
            assert not batch[bi, fh:].any() and not batch[bi, :, fw:].any()
            seq.setdefault(sid, []).append(frame_index(batch[bi, :fh, :fw],
                                                       ref))
    for sid, src in enumerate(sources):
        if src.startswith("/nonexistent"):
            assert sid not in seq and sid not in tdims
            continue
        n = N2 if src == clips[1] else N
        assert seq[sid] == list(range(n)), (case, sid)
        h, w = (H2, W2) if src == clips[1] else (H, W)
        assert tdims[sid] == (h, w)
        assert abs(tfps[sid] - (30.0 if src == clips[1] else 24.0)) < 1.0
    assert tr[0][1] == [s for s, src in enumerate(sources)
                        if not src.startswith("/nonexistent")]


# ------------------------------------------------- behaviours of both


def test_release_mid_stream(clips, impl):
    pool = impl([clips[0]] * 2, workers=2, slot_bytes=W * H * 3)
    it = iter(pool)
    next(it)
    next(it)
    pool.release()
    assert all(not p.is_alive() for p in pool._procs)


class _Proc:
    def __init__(self, alive):
        self.alive = alive

    def is_alive(self):
        return self.alive


def queue_pool(cls, n, timeout_ms, alive=True, t0=None):
    """A pool with no processes: its queues are filled by the test."""
    pool = cls.__new__(cls)
    pool.n_streams = n
    pool.timeout_ms = timeout_ms
    pool.startup_timeout_ms = 60000
    pool._proc_of = {i: _Proc(alive) for i in range(n)}
    pool.slot_bytes = 16 * 16 * 3
    pool._buf = np.zeros(n * pool.slot_bytes, np.uint8)
    pool._free_qs = {i: queue.Queue() for i in range(n)}
    pool._filled_qs = {i: queue.Queue() for i in range(n)}
    pool.frames_out = 0
    pool.first_round_s = None
    pool.stream_dims = {}
    pool.stream_fps = {}
    pool._t0 = time.monotonic() if t0 is None else t0
    pool._closed = True                  # release() does nothing
    return pool


def test_stalled_streams_share_one_timeout(impl):
    """Three streams that delivered and then stall cost one timeout_ms
    together in the next round, not one each."""
    pool = queue_pool(impl, 4, 400)
    for s in range(4):
        pool._filled_qs[s].put((s, 16, 16, 24.0))
    it = iter(pool)
    assert next(it)[1] == [0, 1, 2, 3]
    pool._filled_qs[0].put((0, 16, 16, 24.0))
    t = time.monotonic()
    batch, ids = next(it)
    dt = time.monotonic() - t
    assert ids == [0] and batch.shape == (1, 16, 16, 3)
    assert 0.35 <= dt < 0.8, dt
    assert pool._free_qs[0].qsize() == 2      # each slot back to its stream


def test_a_connecting_stream_holds_only_the_first_window():
    """A stream that has not delivered holds a round while the pool is
    within timeout_ms of its start (so cameras that open together fill
    the first round), and holds none after; the JAX pool waits on it in
    every round."""
    for cls, want_slow in ((jdp.DecodePool, True), (tdp.DecodePool, False)):
        pool = queue_pool(cls, 2, 300, t0=time.monotonic() - 10)
        it = iter(pool)
        for r in range(2):
            pool._filled_qs[0].put((0, 16, 16, 24.0))
            t = time.monotonic()
            assert next(it)[1] == [0]
            dt = time.monotonic() - t
            assert (dt >= 0.28) if want_slow else (dt < 0.1), (cls, r, dt)
        pool._filled_qs[1].put((1, 16, 16, 24.0))    # it connects
        pool._filled_qs[0].put((0, 16, 16, 24.0))
        assert next(it)[1] == [0, 1]
    pool = queue_pool(tdp.DecodePool, 2, 300)        # within the window
    it = iter(pool)
    pool._filled_qs[0].put((0, 16, 16, 24.0))
    t = time.monotonic()
    assert next(it)[1] == [0]
    assert time.monotonic() - t >= 0.2


def test_startup_grace_under_a_tiny_timeout(clips, impl):
    """timeout_ms far below the workers' start: both streams still
    deliver (a stream that has not delivered is not stalled)."""
    pool = impl([clips[0]] * 2, workers=1, slot_bytes=W * H * 3,
                timeout_ms=1, startup_timeout_ms=60000)
    counts = {}
    for _, ids, _ in read_rounds(pool):
        for sid in ids:
            counts[sid] = counts.get(sid, 0) + 1
    assert counts.get(0, 0) > 0 and counts.get(1, 0) > 0
    assert max(counts.values()) <= N


def test_a_source_that_does_not_open_is_not_waited_on(clips, impl):
    pool = impl([clips[0], "/nonexistent/no.mp4"], workers=2,
                slot_bytes=W * H * 3, timeout_ms=4000,
                startup_timeout_ms=600000)
    t = time.monotonic()
    counts = {}
    for _, ids, _ in read_rounds(pool):
        for sid in ids:
            counts[sid] = counts.get(sid, 0) + 1
    assert time.monotonic() - t < 30
    assert counts == {0: N}


# ------------------------------------------------ where the port differs


def test_a_connecting_camera_does_not_throttle_a_healthy_one(clips,
                                                             tmp_path):
    """One camera connecting (a FIFO no one writes: its worker stays in
    the open) beside a healthy one, timeout_ms 1000. Once the workers are
    up and the pool's first timeout has passed, the JAX pool's rounds each
    take >= the timeout; the port's are served as soon as the healthy
    frame is there, each in under half the timeout (a margin for a
    scheduler shared with other test processes)."""
    timeout_ms = 1000
    fifo = str(tmp_path / "camera")
    os.mkfifo(fifo)
    times = {}
    for name, cls in POOLS.items():
        pool = cls([clips[0], fifo], workers=2, slot_bytes=W * H * 3,
                   timeout_ms=timeout_ms)
        # the workers start and frames wait in slots; the port holds a
        # round for a connecting camera only within the first timeout
        time.sleep(timeout_ms / 1000 + 0.5)
        rounds = read_rounds(pool, limit_s=30, stop_after=3)
        assert [ids for _, ids, _ in rounds] == [[0]] * 3, name
        assert all(p.is_alive() is False for p in pool._procs)
        times[name] = [dt for _, _, dt in rounds]
    assert min(times["jax"]) >= timeout_ms / 1000, times
    assert max(times["port"]) < timeout_ms / 2000, times


def test_a_dead_worker_ends_its_streams_at_once():
    """A worker that dies (its opener exits the process) never puts an
    end of stream; the port drops its streams as soon as it is gone."""
    ok = "6:24:32:1:24"
    pool = tdp.DecodePool([ok, "exit"], workers=2, slot_bytes=32 * 24 * 3,
                          timeout_ms=20000, startup_timeout_ms=600000,
                          opener=pool_openers.seeded_opener)
    t = time.monotonic()
    rounds = read_rounds(pool)
    assert time.monotonic() - t < 10
    assert [ids for _, ids, _ in rounds] == [[0]] * 6


def test_opener_runs_in_the_worker_and_frames_match_it():
    """The opener's captures, decoded by the workers: the rounds hold its
    frames in order, each stream at its own size and rate."""
    srcs = ["5:24:32:1:30", "3:40:20:2:12.5", "5:24:32:3:24"]
    pool = tdp.DecodePool(srcs, workers=2, slot_bytes=40 * 32 * 3,
                          timeout_ms=8000, opener=pool_openers.seeded_opener)
    rounds = read_rounds(pool)
    want = [pool_openers.seeded_frames(int(n), int(h), int(w), int(s))
            for n, h, w, s, _ in (x.split(":") for x in srcs)]
    assert [ids for _, ids, _ in rounds] == [[0, 1, 2]] * 3 + [[0, 2]] * 2
    assert [b.shape[1:3] for b, _, _ in rounds] == [(40, 32)] * 3 + [
        (24, 32)] * 2
    for r, (batch, ids, _) in enumerate(rounds):
        for bi, sid in enumerate(ids):
            f = want[sid][r]
            np.testing.assert_array_equal(
                batch[bi, :f.shape[0], :f.shape[1]], f)
    assert pool.stream_dims == {0: (24, 32), 1: (40, 20), 2: (24, 32)}
    assert pool.stream_fps == {0: 30.0, 1: 12.5, 2: 24.0}
    assert pool.first_round_s is not None and pool.first_round_s > 0


def test_a_worker_imports_no_torch():
    """Checked from inside a worker, through the opener: another process
    than this one (which has imported torch), the port's pool imported
    there, and no torch."""
    import torch  # noqa: F401

    pool = tdp.DecodePool([str(os.getpid())], workers=1,
                          slot_bytes=8 * 8 * 3, timeout_ms=8000,
                          opener=pool_openers.probe_opener)
    rounds = read_rounds(pool)
    assert len(rounds) == 3
    torch_there, elsewhere, pool_there = rounds[0][0][0, 0, 0]
    assert (int(torch_there), int(elsewhere), int(pool_there)) == (0, 1, 1)


def test_fork_is_refused():
    with pytest.raises(ValueError, match="does not fork"):
        tdp.DecodePool(["x"], start_method="fork")
