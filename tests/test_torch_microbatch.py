"""The port's MicroBatcher (``runtime/microbatch.py``, a copy of the JAX
package's) and the facade's micro-batching, through the behaviours of
``tests/test_microbatch.py``.

Every batcher behaviour runs on both copies (``impl``: the JAX package's
module and the port's), so the copy is shown to behave as the original.
The facade tests run the port's FaceAnalysis; the integration test holds
16 concurrent ``get()`` calls to the direct ``get_batch`` results on the
committed trained checkpoints, at the original's tolerances (bbox atol
1e-2 px, embeddings atol 1e-3).
"""
import os
import threading
import time

import numpy as np
import pytest

from scrfd_arcface_facerecognition_tpu.runtime import microbatch as jmb
from scrfd_arcface_facerecognition_tpu_torch.apps.face_analysis import (
    FaceAnalysis)
from scrfd_arcface_facerecognition_tpu_torch.runtime import microbatch as tmb
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


@pytest.fixture(params=["jax", "port"])
def impl(request):
    return jmb if request.param == "jax" else tmb


def test_the_copy_has_the_originals_surface():
    for name in ("MicroBatcher", "MicroBatcherClosed"):
        assert hasattr(tmb, name)
    for meth in ("submit", "submit_async", "close", "_loop", "_run"):
        assert hasattr(tmb.MicroBatcher, meth)


def test_single_submit_roundtrip(impl):
    mb = impl.MicroBatcher(lambda xs: [x * 2 for x in xs], max_wait_ms=1.0)
    try:
        assert mb.submit(21) == 42
        assert mb.n_items == 1 and mb.n_batches == 1
    finally:
        mb.close()


def test_concurrent_submits_coalesce_and_order_correctly(impl):
    calls = []

    def fn(xs):
        calls.append(len(xs))
        time.sleep(0.01)          # make the batch window meaningful
        return [x + 1000 for x in xs]

    mb = impl.MicroBatcher(fn, max_batch=64, max_wait_ms=30.0)
    results = {}

    def worker(i):
        results[i] = mb.submit(i)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == {i: i + 1000 for i in range(32)}
        # 32 items arriving together must share far fewer device calls
        assert mb.n_items == 32
        assert mb.n_batches < 32 / 2, calls
        assert mb.max_batch_seen > 1
    finally:
        mb.close()


def test_keys_never_mix_and_kwargs_flow(impl):
    seen = []

    def fn(xs, scale=1):
        seen.append((tuple(xs), scale))
        return [x * scale for x in xs]

    mb = impl.MicroBatcher(fn, max_batch=16, max_wait_ms=20.0)
    results = {}

    def worker(i, scale):
        results[(i, scale)] = mb.submit(
            i, key=("scale", scale), key_kwargs={"scale": scale})

    try:
        threads = [threading.Thread(target=worker, args=(i, 2 + (i % 2)))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(results[(i, s)] == i * s for (i, s) in results)
        for xs, scale in seen:
            # a batch only ever contains its own key's items
            assert all((x % 2 == 0) == (scale == 2) for x in xs)
    finally:
        mb.close()


def test_exception_propagates_to_every_waiter(impl):
    def fn(xs):
        raise RuntimeError("device on fire")

    mb = impl.MicroBatcher(fn, max_batch=8, max_wait_ms=10.0)
    errs = []

    def worker(i):
        try:
            mb.submit(i)
        except RuntimeError as e:
            errs.append(str(e))

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == ["device on fire"] * 4
        assert mb.n_batches == 0      # failed batches don't count as served
    finally:
        mb.close()


def test_wrong_result_count_is_an_error_not_a_hang(impl):
    mb = impl.MicroBatcher(lambda xs: [0], max_batch=4, max_wait_ms=20.0)
    try:
        out = []

        def worker(i):
            try:
                out.append(mb.submit(i))
            except RuntimeError as e:
                out.append(str(e))

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
        # either a lone early batch returned its single 0, or the
        # grouped batches error — nobody hangs
        assert all(o == 0 or "results for" in str(o) for o in out)
    finally:
        mb.close()


def test_close_serves_pending_then_rejects(impl):
    MicroBatcherClosed = impl.MicroBatcherClosed

    mb = impl.MicroBatcher(lambda xs: list(xs), max_wait_ms=1.0)
    assert mb.submit("a") == "a"
    assert mb.close()
    with pytest.raises(MicroBatcherClosed):
        mb.submit("b")


def test_close_during_slow_batch_drops_nothing(impl):
    """close() while batch_fn is mid-call: the collector finishes serving
    everything already queued (close reports the timeout with False),
    nobody hangs or errors."""
    release, started = threading.Event(), threading.Event()

    def fn(xs):
        started.set()
        release.wait(5)                 # the "slow compile" in flight
        return [x * 2 for x in xs]

    mb = impl.MicroBatcher(fn, max_batch=1, max_wait_ms=0.0)  # one item per call
    results = {}

    def worker(i):
        results[i] = mb.submit(i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    # one batch in flight (the collector is inside fn), two queued; on a
    # loaded host the queue can hold 2 before the collector takes the first
    started.wait(5)
    while mb._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)               # all three enqueued (1 in flight)
    assert mb.close(join_timeout=0.05) is False   # still draining
    release.set()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert results == {0: 0, 1: 2, 2: 4}
    mb._thread.join(timeout=5)
    assert not mb._thread.is_alive()


def test_enable_microbatch_param_mismatch_raises():

    app = FaceAnalysis.__new__(FaceAnalysis)   # no model build needed
    app._microbatcher = None
    app.get_batch = lambda imgs, max_num=0: [[] for _ in imgs]
    mb = app.enable_microbatch(max_batch=8, max_wait_ms=2.0)
    assert app.enable_microbatch(max_batch=8, max_wait_ms=2.0) is mb
    with pytest.raises(ValueError, match="different parameters"):
        app.enable_microbatch(max_batch=4, max_wait_ms=2.0)
    app.disable_microbatch()


# ------------------------------------------------- FaceAnalysis integration


def test_face_analysis_microbatch_matches_direct():
    """16 threads each get() one image of its own shape (every group is
    one image, so the route is the dynamic one however the collector
    groups them): the faces equal the direct get_batch of all 16 at
    bbox atol 1e-2 px and embeddings atol 1e-3."""
    from flax import serialization

    ckpt = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "checkpoints", "decisions")
    trees = []
    for name in ("det_500m.msgpack", "w600k_mbf.msgpack"):
        with open(os.path.join(ckpt, name), "rb") as f:
            trees.append(serialization.msgpack_restore(f.read()))
    app = FaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                       det_variables=trees[0], rec_variables=trees[1],
                       max_det=4, device="cpu")
    app.prepare(det_size=(160, 160), det_thresh=0.1)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 255, (96 + 8 * i, 128 + 4 * i, 3), np.uint8)
              for i in range(16)]
    direct = app.get_batch(images, max_num=2)

    mb = app.enable_microbatch(max_batch=16, max_wait_ms=50.0)
    got = [None] * len(images)

    def worker(i):
        got[i] = app.get(images[i], max_num=2)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    app.disable_microbatch()

    assert mb.n_items == len(images)
    assert mb.n_batches < len(images)     # coalescing happened
    assert sum(len(f) for f in direct) > 0
    for want, batched in zip(direct, got):
        assert len(want) == len(batched)
        for a, b in zip(want, batched):
            np.testing.assert_allclose(a.bbox, b.bbox, atol=1e-2)
            np.testing.assert_allclose(
                a.normed_embedding, b.normed_embedding, atol=1e-3)




def test_submit_timeout_releases_waiter(impl):
    """A waiter with a timeout must never hang on a stuck batch_fn
    (ADVICE r4): submit(timeout=) raises TimeoutError promptly while the
    collector is blocked inside the batch."""
    from concurrent.futures import TimeoutError as FutTimeout

    release = threading.Event()

    def fn(xs):
        release.wait(5)
        return list(xs)

    mb = impl.MicroBatcher(fn, max_wait_ms=0.0)
    t0 = time.monotonic()
    with pytest.raises(FutTimeout):
        mb.submit(1, timeout=0.1)
    assert time.monotonic() - t0 < 2.0
    release.set()
    mb.close()


def test_close_abort_fails_queued_waiters(impl):
    """close(abort=True) releases every QUEUED waiter with
    MicroBatcherClosed instead of leaving them blocked behind a stuck
    in-flight batch; the in-flight item still gets its real result."""
    MicroBatcherClosed = impl.MicroBatcherClosed

    release, started = threading.Event(), threading.Event()

    def fn(xs):
        started.set()
        release.wait(5)
        return [x * 2 for x in xs]

    mb = impl.MicroBatcher(fn, max_batch=1, max_wait_ms=0.0)
    results, errors = {}, {}

    def worker(i):
        try:
            results[i] = mb.submit(i)
        except BaseException as ex:   # noqa: BLE001
            errors[i] = ex

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    # one batch in flight (the collector is inside fn), two queued; on a
    # loaded host the queue can hold 2 before the collector takes the first
    started.wait(5)
    while mb._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)             # 1 in flight, 2 queued
    mb.close(join_timeout=0.05, abort=True)
    release.set()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == 1 and len(errors) == 2
    (i, r), = results.items()
    assert r == i * 2                  # in-flight item served for real
    assert all(isinstance(e, MicroBatcherClosed) for e in errors.values())


def test_enable_microbatch_same_args_reenable_is_idempotent():
    """Same-argument re-enable must return the existing batcher, even for
    ms values that don't survive the /1000*1000 float round-trip or that
    the ctor clamps (negative) — ADVICE r4."""

    app = FaceAnalysis.__new__(FaceAnalysis)   # no model build needed
    app._microbatcher = None
    app.get_batch = lambda imgs, max_num=0: [[] for _ in imgs]
    for ms in (0.3, 4, -1.0):
        mb = app.enable_microbatch(max_batch=8, max_wait_ms=ms)
        assert app.enable_microbatch(max_batch=8, max_wait_ms=ms) is mb
        app.disable_microbatch()
