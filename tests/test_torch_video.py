"""The port's video runtime against the JAX package's: the frame ring
(``FramePipe``, native and its Python fallback), ``BatchedFrameReader``
(both producers, ``close()`` joining the decode thread), ``open_capture``,
``MultiStreamReader`` and ``NativeVideoReader``, on clips written here by
cv2. The behaviours of ``tests/test_runtime_native.py`` on the port's
copies, without its two cases that read ``/root/reference``; the same
frames through both packages' readers give equal batches (exact); the
native decoder's frames are within 2 of cv2's on average (both decode
with ffmpeg; colour conversion may differ by a step).
"""
import os
import sys
import threading

import numpy as np
import pytest

from scrfd_arcface_facerecognition_tpu.runtime import video as jvideo
from scrfd_arcface_facerecognition_tpu_torch.runtime import (
    BatchedFrameReader, FramePipe, MultiStreamReader, NativeVideoReader,
    build_native, native_available, open_capture)
from scrfd_arcface_facerecognition_tpu_torch.runtime import native as tnative


def write_clip(path, frames, fps=10.0):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    return str(path)


class FakeCapture:
    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)


def seeded_frames(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(params=["native", "python"])
def pipe_kind(request, monkeypatch):
    """Each FramePipe test on the native ring and on the fallback."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert build_native() and native_available()
    return request.param


def test_framepipe_roundtrip(pipe_kind):
    pipe = FramePipe(slot_bytes=16, n_slots=4)
    assert pipe.zero_copy == (pipe_kind == "native")
    assert pipe.push(b"x" * 16)
    assert pipe.push(b"y" * 16)
    assert pipe.size() == 2
    assert pipe.pop() == b"x" * 16
    assert pipe.pop() == b"y" * 16
    pipe.close()
    assert pipe.pop() is None  # closed + drained


def test_framepipe_threaded_ordering(pipe_kind):
    pipe = FramePipe(slot_bytes=8, n_slots=4)  # small ring forces blocking
    n = 200
    push_ok = []

    def producer():
        try:
            for i in range(n):
                push_ok.append(pipe.push(i.to_bytes(8, "little")))
        finally:
            pipe.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while True:
        data = pipe.pop()
        if data is None:
            break
        got.append(int.from_bytes(data, "little"))
    t.join()
    assert push_ok == [True] * n
    assert got == list(range(n))


def test_framepipe_rejects_oversize(pipe_kind):
    pipe = FramePipe(slot_bytes=4, n_slots=2)
    assert not pipe.push(b"too large for slot")


def test_framepipe_pop_times_out_on_an_open_empty_pipe(pipe_kind):
    pipe = FramePipe(slot_bytes=4, n_slots=2)
    with pytest.raises(TimeoutError):
        pipe.pop(timeout_ms=50)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_batched_frame_reader(zero_copy):
    frames = seeded_frames(2, 10, 32, 48)
    reader = BatchedFrameReader(FakeCapture(frames), batch=4,
                                zero_copy=zero_copy)
    assert reader._zero_copy == (zero_copy and native_available())
    batches = list(reader)
    assert [len(b) for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(batches), np.stack(frames))
    assert reader.close() is True


def test_batched_frame_reader_empty():
    reader = BatchedFrameReader(FakeCapture([]), batch=4)
    assert list(reader) == []
    assert reader.close() is True


def test_batched_frame_reader_stops_at_a_shape_change():
    frames = seeded_frames(4, 5, 16, 16) + seeded_frames(5, 3, 16, 24)
    batches = list(BatchedFrameReader(FakeCapture(frames), batch=2))
    np.testing.assert_array_equal(np.concatenate(batches),
                                  np.stack(frames[:5]))


@pytest.mark.parametrize("zero_copy", [True, False])
def test_batched_frame_reader_close_joins_producer(zero_copy):
    """close() stops and joins the decode thread, even one blocked on a
    full ring, so the caller may release the capture afterwards."""
    frames = seeded_frames(3, 64, 16, 16)
    reader = BatchedFrameReader(FakeCapture(frames), batch=4, ring_slots=2,
                                zero_copy=zero_copy)
    next(iter(reader))            # consume one batch, then abandon
    assert reader.close() is True
    assert not reader._thread.is_alive()
    assert reader.close() is True  # idempotent


@pytest.mark.parametrize("zero_copy", [True, False])
def test_same_frames_through_both_packages_give_equal_batches(zero_copy):
    frames = seeded_frames(6, 11, 24, 40)
    want = list(jvideo.BatchedFrameReader(FakeCapture(frames), batch=3,
                                          zero_copy=zero_copy))
    got = list(BatchedFrameReader(FakeCapture(frames), batch=3,
                                  zero_copy=zero_copy))
    assert [b.shape for b in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_clip_through_both_packages_gives_equal_batches(tmp_path):
    path = write_clip(tmp_path / "c.mp4", seeded_frames(7, 7, 48, 64))
    caps = (jvideo.open_capture(path), open_capture(path))
    assert type(caps[1]).__name__ == type(caps[0]).__name__
    want = list(jvideo.BatchedFrameReader(caps[0], batch=3))
    got = list(BatchedFrameReader(caps[1], batch=3))
    assert [len(b) for b in got] == [len(b) for b in want] == [3, 3, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for c in caps:
        c.release()


def _native_video_or_skip():
    if tnative._load_video() is None:
        pytest.skip("libsafr_video.so did not build here (needs ffmpeg's "
                    "development files)")


def test_native_video_decoder_matches_cv2_on_a_clip(tmp_path):
    import cv2

    _native_video_or_skip()
    base = seeded_frames(8, 6, 6, 8)
    frames = [cv2.resize(b, (128, 96), interpolation=cv2.INTER_LINEAR)
              for b in base]                 # smooth: codec-friendly
    path = write_clip(tmp_path / "d.mp4", frames)
    nat, ref = NativeVideoReader(path), cv2.VideoCapture(path)
    assert (nat.width, nat.height) == (int(ref.get(cv2.CAP_PROP_FRAME_WIDTH)),
                                       int(ref.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    n = 0
    while True:
        ok_n, f_n = nat.read()
        ok_r, f_r = ref.read()
        assert ok_n == ok_r
        if not ok_n:
            break
        diff = np.abs(f_n.astype(int) - f_r.astype(int))
        assert diff.mean() < 2.0 and np.percentile(diff, 99) <= 4
        n += 1
    assert n == 6
    buf = np.empty((96, 128, 3), np.uint8)
    assert nat.read_into(buf) is False       # at the end
    nat.release()
    assert nat.read() == (False, None) and not nat.isOpened()
    ref.release()


def test_native_reader_leaves_room_for_widths_off_16(tmp_path):
    """The decoder writes whole 16-pixel groups: at a width that is not a
    multiple of 16 it writes past the frame (24 bytes at 200 wide), which
    corrupted the heap. The reader gives it room; each frame read, by
    ``read`` or into an exact-size buffer by ``read_into``, equals the same
    frame decoded into a buffer with room, and cv2's within the codec
    tolerance of the test above. In a child process: a corrupted heap
    ends it."""
    import subprocess

    _native_video_or_skip()
    paths = {w: write_clip(tmp_path / f"w{w}.mp4",
                           seeded_frames(w, 4, 48, w)) for w in (200, 208)}
    code = """
import ctypes, sys
import cv2, numpy as np
from scrfd_arcface_facerecognition_tpu_torch.runtime.native import (
    NativeVideoReader)
for path in sys.argv[1:]:
    a, b, c = (NativeVideoReader(path) for _ in range(3))
    ref = cv2.VideoCapture(path)
    n = a.height * a.width * 3
    for i in range(4):
        room = np.full(n + 4096, 7, np.uint8)
        assert c._lib.vdec_read(c._h, room.ctypes.data_as(ctypes.c_void_p),
                                n) == 1
        ok, f = a.read()
        exact = np.empty((a.height, a.width, 3), np.uint8)
        assert ok and b.read_into(exact)
        want = room[:n].reshape(a.height, a.width, 3)
        assert np.array_equal(f, want) and np.array_equal(exact, want)
        diff = np.abs(f.astype(int) - ref.read()[1].astype(int))
        assert diff.mean() < 2.0, diff.mean()
    assert a.read() == (False, None) and not b.read_into(exact)
    for r in (a, b, c, ref):
        r.release()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code, paths[200],
                          paths[208]], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.returncode, out.stderr[-2000:])


def test_native_reader_get_answers_without_cv2(tmp_path, monkeypatch):
    """cv2's numeric property ids are the port's own constants, and the
    reader answers them with no cv2 importable (the card's machine)."""
    import cv2

    assert (tnative.CAP_PROP_FRAME_WIDTH, tnative.CAP_PROP_FRAME_HEIGHT,
            tnative.CAP_PROP_FPS) == (cv2.CAP_PROP_FRAME_WIDTH,
                                      cv2.CAP_PROP_FRAME_HEIGHT,
                                      cv2.CAP_PROP_FPS)
    _native_video_or_skip()
    path = write_clip(tmp_path / "g.mp4", seeded_frames(9, 3, 48, 80),
                      fps=12.0)
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 now fails
    cap = NativeVideoReader(path)
    assert (cap.get(3), cap.get(4), cap.get(5)) == (80.0, 48.0, 12.0)
    assert cap.get(7) == 0.0
    cap.release()


def test_open_capture_prefers_native_and_falls_back(tmp_path):
    path = write_clip(tmp_path / "o.mp4", seeded_frames(10, 2, 48, 64))
    cap = open_capture(path)
    if tnative._load_video() is not None:
        assert isinstance(cap, NativeVideoReader)
    ok, frame = cap.read()
    assert ok and frame.dtype == np.uint8 and frame.shape == (48, 64, 3)
    cap.release()
    missing = open_capture(str(tmp_path / "missing.mp4"))
    assert not isinstance(missing, NativeVideoReader)
    assert not missing.isOpened()


def test_multi_stream_reader_batches_all_live_streams(tmp_path):
    """Every batch carries one frame of each still-live stream in stream
    order; a stream that ends drops out."""
    paths = []
    for si, n_frames in enumerate((6, 3)):
        frames = [np.full((48, 64, 3), 10 * si + f, np.uint8)
                  for f in range(n_frames)]
        paths.append(write_clip(tmp_path / f"s{si}.mp4", frames))
    reader = MultiStreamReader([open_capture(p) for p in paths],
                               timeout_ms=5000)
    batches = list(reader)
    reader.release()
    assert [ids for _, ids in batches[:3]] == [[0, 1]] * 3
    assert all(ids == [0] for _, ids in batches[3:])
    assert 4 <= len(batches) <= 6
    for batch, ids in batches:
        assert batch.shape[0] == len(ids) and batch.dtype == np.uint8


def test_multi_stream_reader_pads_to_the_largest_frame():
    a = FakeCapture(seeded_frames(11, 2, 20, 30))
    b = FakeCapture(seeded_frames(12, 2, 24, 16))
    want = list(jvideo.MultiStreamReader(
        [FakeCapture(seeded_frames(11, 2, 20, 30)),
         FakeCapture(seeded_frames(12, 2, 24, 16))], timeout_ms=2000))
    reader = MultiStreamReader([a, b], timeout_ms=2000)
    got = list(reader)
    reader.release()
    assert [ids for _, ids in got] == [ids for _, ids in want] == [[0, 1]] * 2
    for (g, _), (w, _) in zip(got, want):
        assert g.shape == (2, 24, 30, 3)
        np.testing.assert_array_equal(g, w)
