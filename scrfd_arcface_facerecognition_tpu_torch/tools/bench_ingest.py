"""The host's video-ingest rates: how many decode cores one card needs.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.bench_ingest \
        [--res 1920x1080] [--frames 300] [--streams 1,2,4,8] \
        [--source file|synthetic] [--device-fps FPS]

Port of the JAX repository's ``tools/bench_ingest.py``. Decode and batch
assembly only, no device work: what one host core can feed a card. The
paths, in the JAX tool's rows:

- raw decode, a new array a frame (``read``) and into one buffer
  (``read_into``);
- ``runtime.video.BatchedFrameReader``, its decode thread feeding the
  native ring through the copying push / pop and through the zero-copy
  slots;
- ``runtime.video.MultiStreamReader`` (a decode thread a stream) over each
  stream count;
- ``runtime.decode_pool.DecodePool`` (decode processes writing into shared
  memory) at 1, 2 and as many workers as streams (at most the cores).

The source is named, never switched: ``file`` decodes a clip of
camera-like frames (a gradient and six moving squares) that the tool
writes with cv2 (``make_video``; ``--fourcc``); ``synthetic`` draws the
same frames at read time (``SyntheticCapture``), so its rows measure the
drawing, not a codec, and say so. The card's machine has no cv2.

Prints a markdown table with the host's core count and CPU model, then the
decode cores a card needs at ``--device-fps`` frames a second (the card's
measured rate). Without ``--device-fps`` it derives no budget and says so.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np

SYNTHETIC = "synthetic"


def camera_base(w: int, h: int) -> np.ndarray:
    """The frames' background: rows ramp the blue channel, columns the
    green one, red at 96."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(yy * 255 // max(h, 1)).astype(np.uint8),
                     (xx * 255 // max(w, 1)).astype(np.uint8),
                     np.full((h, w), 96, np.uint8)], axis=-1)


def draw_frame(base: np.ndarray, i: int, out: np.ndarray) -> np.ndarray:
    """Frame ``i`` into ``out`` (h, w, 3): the background and six 100-px
    squares that move a frame (faces on a camera)."""
    h, w = base.shape[:2]
    np.copyto(out, base)
    for k in range(6):
        x0 = (37 * i + 211 * k) % max(w - 120, 1)
        y0 = (23 * i + 149 * k) % max(h - 120, 1)
        out[y0:y0 + 100, x0:x0 + 100] = (40 * k) % 255
    return out


def make_video(path: str, w: int, h: int, frames: int,
               fourcc: str = "mp4v") -> bool:
    """Write ``frames`` camera-like frames to ``path`` with cv2 (camera-like
    content, not noise: noise is incompressible and decodes several times
    slower than footage). False when the writer does not open."""
    import cv2

    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 24, (w, h))
    if not wr.isOpened():
        return False
    base = camera_base(w, h)
    f = np.empty_like(base)
    for i in range(frames):
        wr.write(draw_frame(base, i, f))
    wr.release()
    return True


class SyntheticCapture:
    """``make_video``'s frames drawn at read time (nothing kept but the
    background): the surface of the native reader (``read``,
    ``read_into``, ``get``, ``isOpened``, ``release``, ``width``,
    ``height``, ``fps``)."""

    fps = 24.0                      # make_video's rate

    def __init__(self, w: int, h: int, frames: int):
        self.width, self.height, self.frames = w, h, frames
        self._base = camera_base(w, h)
        self._i = 0

    def read_into(self, buf: np.ndarray) -> bool:
        if self._base is None or self._i >= self.frames:
            return False
        out = buf.reshape(-1)[:self.height * self.width * 3].reshape(
            self.height, self.width, 3)
        draw_frame(self._base, self._i, out)
        self._i += 1
        return True

    def read(self):
        frame = np.empty((self.height, self.width, 3), np.uint8)
        if not self.read_into(frame):
            return False, None
        return True, frame

    def get(self, prop) -> float:   # cv2's property ids
        return {3: float(self.width), 4: float(self.height),
                5: float(self.fps)}.get(prop, 0.0)

    def isOpened(self) -> bool:     # cv2's name
        return self._base is not None

    def release(self) -> None:
        self._base = None


def synthetic_source(w: int, h: int, frames: int) -> str:
    return f"{SYNTHETIC}:{w}x{h}:{frames}"


def open_source(source: str):
    """A capture for ``source``: ``"synthetic:WxH:N"`` draws N frames at
    read time, anything else opens through ``runtime.video.open_capture``.
    ``DecodePool``'s opener: its workers import this module, which
    imports no torch."""
    if source.startswith(SYNTHETIC + ":"):
        _, res, n = source.split(":")
        w, h = (int(x) for x in res.split("x"))
        return SyntheticCapture(w, h, int(n))
    from ..runtime.video import open_capture

    return open_capture(source)


def bench_raw_decode(source: str, use_read_into: bool):
    """The decode loop alone, no ring or queue."""
    cap = open_source(source)
    n = 0
    buf = None
    t0 = time.perf_counter()
    while True:
        if use_read_into and hasattr(cap, "read_into"):
            if buf is None:
                buf = np.empty((cap.height, cap.width, 3), np.uint8)
            if not cap.read_into(buf):
                break
        else:
            ok, _ = cap.read()
            if not ok:
                break
        n += 1
    dt = time.perf_counter() - t0
    cap.release()
    return n / dt if dt > 0 else 0.0, n


def bench_batched_reader(source: str, zero_copy: bool, batch: int = 8):
    """Decode thread -> native ring -> batch assembly (the single-stream
    serving feed); ``zero_copy=False`` takes the copying push / pop."""
    from ..runtime.video import BatchedFrameReader

    cap = open_source(source)
    r = BatchedFrameReader(cap, batch=batch, zero_copy=zero_copy)
    n = 0
    t0 = time.perf_counter()
    for b in r:
        n += len(b)
    dt = time.perf_counter() - t0
    r.close()
    cap.release()
    return n / dt if dt > 0 else 0.0, n


def bench_multistream(source: str, n_streams: int):
    """A decode thread a camera, under the interpreter lock."""
    from ..runtime.video import MultiStreamReader

    caps = [open_source(source) for _ in range(n_streams)]
    r = MultiStreamReader(caps, timeout_ms=5000)
    n = 0
    t0 = time.perf_counter()
    for batch, _ in r:
        n += len(batch)
    dt = time.perf_counter() - t0
    r.release()
    return n / dt if dt > 0 else 0.0, n


def bench_pool(source: str, n_streams: int, workers: int, w: int, h: int):
    """Decode processes into shared-memory slots."""
    from ..runtime.decode_pool import DecodePool

    pool = DecodePool([source] * n_streams, workers=workers,
                      slot_bytes=w * h * 3, timeout_ms=5000,
                      opener=open_source)
    n = 0
    t0 = time.perf_counter()
    for batch, _ in pool:
        n += len(batch)
    dt = time.perf_counter() - t0
    pool.release()
    return n / dt if dt > 0 else 0.0, n


def run(source: str, w: int, h: int, streams, cores: int) -> list:
    """Every path of the table over ``source`` on a host of ``cores``
    cores: rows of (path, streams, workers, aggregate frames a second,
    frames)."""
    rows = []
    fps, n = bench_raw_decode(source, use_read_into=False)
    rows.append(("raw decode (read, alloc per frame)", 1, "-", fps, n))
    fps, n = bench_raw_decode(source, use_read_into=True)
    rows.append(("raw decode (read_into, zero-alloc)", 1, "-", fps, n))
    fps, n = bench_batched_reader(source, zero_copy=False)
    rows.append(("BatchedFrameReader legacy (tobytes+pop: 4 copies)",
                 1, "thread", fps, n))
    fps, n = bench_batched_reader(source, zero_copy=True)
    rows.append(("BatchedFrameReader zero-copy ring (1 copy)",
                 1, "thread", fps, n))
    for ns in streams:
        fps, n = bench_multistream(source, ns)
        rows.append(("MultiStreamReader (threads, GIL)", ns, "thread",
                     fps, n))
        for wk in sorted({1, min(2, cores), min(ns, cores)}):
            fps, n = bench_pool(source, ns, wk, w, h)
            rows.append(("DecodePool", ns, f"{wk} proc", fps, n))
    return rows


def decode_cores(device_fps: float, feed_fps: float) -> int:
    """Decode cores that feed ``device_fps`` at ``feed_fps`` a core."""
    return int(math.ceil(device_fps / max(feed_fps, 1.0)))


def cpu_model() -> str:
    """The host CPU's model as Linux's /proc/cpuinfo gives it: its "model
    name", else its vendor, family and model numbers, else "unknown"."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break               # the first processor's block ends
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
           if fields.get(k)]
    return ", ".join(ids) or "unknown"


def table(rows, w: int, h: int, label: str, frames: int, cores: int,
          device_fps: Optional[float] = None) -> str:
    """The markdown table and the core-budget line."""
    synthetic = label == SYNTHETIC
    out = [f"\n## Ingest scaling ({w}x{h} "
           + ("synthetic frames drawn at read time, no codec"
              if synthetic else label)
           + f", {frames} frames/stream, {cores}-core host: {cpu_model()})"
           "\n",
           "| path | streams | workers | aggregate fps | frames |",
           "|---|---|---|---|---|"]
    for name, ns, wk, fps, n in rows:
        if synthetic:
            name += " [synthetic, no codec]"
        out.append(f"| {name} | {ns} | {wk} | {fps:.0f} | {n} |")
    zc = next(fps for name, _, _, fps, _ in rows
              if name.startswith("BatchedFrameReader zero-copy"))
    if device_fps is None:
        out.append("\nNo core budget: give --device-fps (the card's frames "
                   "a second) to derive one.")
    else:
        out.append(f"\nCore budget: zero-copy single-stream feed = {zc:.0f} "
                   f"fps/core at {w}x{h} ({label}); a card at "
                   f"{device_fps:.0f} fps needs ceil({device_fps:.0f}/"
                   f"{zc:.0f}) = {decode_cores(device_fps, zc)} decode cores "
                   "(+1 consumer core for batch assembly at scale).")
    return "\n".join(out)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--fourcc", default="mp4v")
    ap.add_argument("--streams", default="1,2,4,8")
    ap.add_argument("--source", choices=["file", SYNTHETIC], default="file",
                    help="file: a clip written with cv2 and decoded; "
                         "synthetic: the same frames drawn at read time")
    ap.add_argument("--device-fps", type=float, default=None,
                    help="the card's frames a second, for the core budget")
    ap.add_argument("--video-dir", default=tempfile.gettempdir(),
                    help="where the file source's clip is written")
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.res.split("x"))
    if args.source == SYNTHETIC:
        source, label = synthetic_source(w, h, args.frames), SYNTHETIC
    else:
        label = args.fourcc
        # the clip is named by every parameter of its content
        source = os.path.join(
            args.video_dir,
            f"ingest_bench_{w}x{h}_{args.fourcc}_{args.frames}.mp4")
        if not os.path.exists(source):
            print(f"writing synthetic {args.fourcc} video {w}x{h} "
                  f"x{args.frames} ...", file=sys.stderr)
            try:
                written = make_video(source, w, h, args.frames, args.fourcc)
            except ImportError:
                print("cv2 is needed to write the clip: use --source "
                      "synthetic", file=sys.stderr)
                return 1
            if not written:
                print("VideoWriter failed", file=sys.stderr)
                return 1
    cores = os.cpu_count() or 1
    rows = run(source, w, h, [int(x) for x in args.streams.split(",")],
               cores)
    print(table(rows, w, h, label, args.frames, cores, args.device_fps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
