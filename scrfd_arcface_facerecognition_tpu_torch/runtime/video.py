"""Video input: frame batches decoded in the background.

A decode thread pushes BGR frames through the native ring
(``runtime/native.py`` ``FramePipe``) while the consumer assembles
(batch, H, W, 3) uint8 arrays for the pipeline, so decoding overlaps the
card's work. The port's own copy of the JAX package's ``runtime/video.py``;
cv2 is imported only where a capture is opened by it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np

from .native import FramePipe, NativeVideoReader


class BatchedFrameReader:
    """Iterate (n <= batch, H, W, 3) uint8 frame batches from a cv2-shaped
    capture (``read() -> (ok, frame)``; ``read_into(buf)`` where the
    capture has it). The last batch may be partial; iteration ends with
    the capture or at a change of frame shape."""

    def __init__(self, capture, batch: int = 8, ring_slots: int = 32,
                 zero_copy: bool = True):
        # zero_copy=False keeps the copying push / pop producer even where
        # the native ring could lend its slots; the mode is read once, here,
        # before the producer starts
        self.cap = capture
        self.batch = batch
        self._stop = threading.Event()
        ok, first = capture.read()
        if not ok:
            self._empty = True
            self.shape = None
            return
        self._empty = False
        self.shape = first.shape
        self._pipe = FramePipe(slot_bytes=first.nbytes, n_slots=ring_slots)
        self._zero_copy = bool(zero_copy) and self._pipe.zero_copy
        self._pipe.push(first.tobytes())
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        # zero-copy: reserve a ring slot and decode into it (the native
        # reader's read_into, or one copy of a cv2 frame); otherwise each
        # frame costs tobytes() and the ring's own copy
        zero_copy = self._zero_copy
        read_into = getattr(self.cap, "read_into", None)
        h, w, c = self.shape
        # the pipe closes however the loop ends, or the consumer would wait
        # out its whole timeout on a stream that has died
        try:
            while not self._stop.is_set():
                if zero_copy:
                    view = None
                    while not self._stop.is_set():
                        view = self._pipe.reserve_view(timeout_ms=200)
                        if view is not None:
                            break
                    if view is None:
                        break
                    slot = view[:h * w * c].reshape(h, w, c)
                    if read_into is not None:
                        ok = read_into(slot)
                    else:
                        ok, frame = self.cap.read()
                        if ok:
                            if frame.shape != (h, w, c):
                                break   # the frame size changed mid-stream
                            np.copyto(slot, frame)
                    if not ok:
                        break
                    self._pipe.commit()
                    continue
                ok, frame = self.cap.read()
                if not ok or frame.shape != (h, w, c):
                    break
                # short pushes that look at stop, so close() can always
                # free a producer waiting on a full ring
                pushed = False
                while not self._stop.is_set():
                    if self._pipe.push(frame.tobytes(), timeout_ms=200):
                        pushed = True
                        break
                if not pushed:
                    break
        finally:
            self._pipe.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._empty:
            return
        h, w, c = self.shape
        zero_copy = self._zero_copy
        while True:
            batch = np.empty((self.batch, h, w, c), np.uint8)
            n = 0
            for bi in range(self.batch):
                if zero_copy:
                    rc, view = self._pipe.peek_view(timeout_ms=60000)
                    if rc == 0:
                        # a stall, not the end: the same error as pop's
                        raise TimeoutError("peek_view timed out")
                    if rc != 1:
                        break
                    batch[bi] = view[:h * w * c].reshape(h, w, c)
                    self._pipe.release_slot()
                else:
                    data = self._pipe.pop(timeout_ms=60000)
                    if data is None:
                        break
                    batch[bi] = np.frombuffer(
                        data, np.uint8)[:h * w * c].reshape(h, w, c)
                n = bi + 1
            if n == 0:
                return
            yield batch[:n]
            if n < self.batch:
                return

    def close(self, join_timeout: float = 5.0) -> bool:
        """Stop the producer and join it, so the caller may release the
        capture afterwards (the producer may be inside ``cap.read()``, and
        freeing the native reader under it is a use after free). Returns
        whether the join succeeded; a producer stuck in a blocking read
        past the timeout is left running, and the capture must then be
        left unreleased."""
        self._stop.set()
        if self._empty:
            return True
        self._pipe.close()
        deadline = time.monotonic() + join_timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            # drain, so a producer waiting on a full ring can leave
            try:
                self._pipe.pop(timeout_ms=50)
            except TimeoutError:
                pass
            self._thread.join(timeout=0.05)
        return not self._thread.is_alive()


def open_capture(source):
    """A cv2-shaped capture for ``source``: the native ffmpeg decoder for a
    file or URL, ``cv2.VideoCapture`` for a webcam index or where the
    native decoder cannot open it."""
    if isinstance(source, str) and not source.isdigit():
        try:
            return NativeVideoReader(source)
        except (RuntimeError, OSError):
            pass
    import cv2

    return cv2.VideoCapture(int(source) if isinstance(source, str)
                            and source.isdigit() else source)


class MultiStreamReader:
    """N captures -> one batched feed: each source has a decode thread, and
    each batch is (n_live, H, W, 3), one frame of every live stream in
    stream order (smaller frames zero-padded to the largest). A stream that
    ends, or stalls past ``timeout_ms``, drops out; iteration ends when
    none is left. Yields (batch, stream ids)."""

    def __init__(self, captures, timeout_ms: int = 10000):
        self.captures = list(captures)
        self.timeout_ms = timeout_ms
        self._stop = threading.Event()
        self._queues = [queue.Queue(maxsize=4) for _ in self.captures]
        self._threads = []
        for cap, q in zip(self.captures, self._queues):
            t = threading.Thread(target=self._producer, args=(cap, q),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _producer(self, cap, q):
        while not self._stop.is_set():
            ok, frame = cap.read()
            if not ok:
                frame = None
            # puts that look at stop, so release() can free the producer
            while not self._stop.is_set():
                try:
                    q.put(frame, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if frame is None:
                return

    def __iter__(self):
        live = list(range(len(self.captures)))
        while live:
            frames, ids = [], []
            for i in live:
                try:
                    f = self._queues[i].get(timeout=self.timeout_ms / 1000)
                except queue.Empty:
                    f = None     # a stalled stream drops out
                if f is None:
                    continue
                frames.append(f)
                ids.append(i)
            live = list(ids)
            if not frames:
                return
            h = max(f.shape[0] for f in frames)
            w = max(f.shape[1] for f in frames)
            batch = np.zeros((len(frames), h, w, 3), np.uint8)
            for bi, f in enumerate(frames):
                batch[bi, :f.shape[0], :f.shape[1]] = f
            yield batch, ids

    def release(self):
        """Stop the producers, drain their queues so a blocked put returns,
        join them, then release each capture whose producer has left (one
        still inside ``cap.read()`` keeps its capture)."""
        self._stop.set()
        deadline = time.monotonic() + self.timeout_ms / 1000
        for t, q in zip(self._threads, self._queues):
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        for cap, t in zip(self.captures, self._threads):
            if t.is_alive():
                continue
            try:
                cap.release()
            except Exception:   # a capture's own release fault ends nothing
                pass
