"""Openers for the port's DecodePool that run inside its decode processes.

A pool's opener is pickled by reference, so it lives at the top level of
a module the workers can import. This module imports numpy and the
standard library only: a worker that imports it must stay free of torch,
which ``probe_opener`` reports from inside the worker.
"""
import os
import sys
import time

import numpy as np


class FrameCapture:
    """A cv2-shaped capture over a list of frames (read, get, isOpened,
    release); ``fps`` as the native reader has it."""

    def __init__(self, frames, fps=24.0):
        self.frames = list(frames)
        self.fps = fps
        self.i = 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1].copy()

    def get(self, prop):
        h, w = self.frames[0].shape[:2] if self.frames else (0, 0)
        return {3: float(w), 4: float(h), 5: self.fps}.get(prop, 0.0)

    def isOpened(self):
        return bool(self.frames)

    def release(self):
        self.frames = []


def seeded_frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def seeded_opener(source):
    """``"n:h:w:seed:fps"`` -> a capture of n seeded h x w frames at fps;
    ``"exit"`` ends the worker process at once (a worker that dies)."""
    if source == "exit":
        os._exit(3)
    n, h, w, seed, fps = source.split(":")
    return FrameCapture(seeded_frames(int(n), int(h), int(w), int(seed)),
                        fps=float(fps))


def probe_opener(source):
    """A capture of 3 frames 8 x 8 reporting from inside the worker:
    channel 0 is 1 where torch was imported there, channel 1 is 1 where
    the worker is another process than ``source`` (the parent's pid),
    channel 2 is 1 where the worker imported the port's decode pool."""
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[..., 0] = "torch" in sys.modules
    frame[..., 1] = os.getpid() != int(source)
    frame[..., 2] = ("scrfd_arcface_facerecognition_tpu_torch.runtime."
                     "decode_pool" in sys.modules)
    return FrameCapture([frame] * 3)


def slow_opener(source):
    """``"delay:n:h:w:seed"``: sleeps ``delay`` seconds (a camera that
    takes long to connect), then a capture of n seeded frames."""
    delay, rest = source.split(":", 1)
    time.sleep(float(delay))
    return seeded_opener(rest + ":24")


def ingest_probe(source):
    """``tools.bench_ingest.open_source`` called inside the worker on
    ``source``: its frames, the first reporting in channel 0 whether torch
    was imported there and in channel 1 whether the opener's module was."""
    from scrfd_arcface_facerecognition_tpu_torch.tools.bench_ingest import (
        open_source)

    cap = open_source(source)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    frames[0][0, 0, 0] = "torch" in sys.modules
    frames[0][0, 0, 1] = ("scrfd_arcface_facerecognition_tpu_torch.tools."
                          "bench_ingest" in sys.modules)
    return FrameCapture(frames)
