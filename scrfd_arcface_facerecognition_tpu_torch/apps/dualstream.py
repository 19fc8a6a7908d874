"""Dual-camera face re-identification, shown side by side.

    python -m scrfd_arcface_facerecognition_tpu_torch.apps.dualstream
        --source1 rtsp://cam1 --source2 rtsp://cam2 --faces-dir faces
        [--output both.mp4] [--show]                           (one line)

The JAX package's dual-camera app, with the same flags, dests and
defaults: two sources, each opened with retries (``connect_to_camera``),
read in lockstep against one gallery; each pair of frames is one
two-frame ``FacePipeline`` call at bfloat16 compute, annotated and
written (or shown) as one side-by-side frame. A second frame of another
size is first resized to the first's with ``ops.resize_bilinear_u8_exact``
on the pipeline's device (cv2's INTER_LINEAR on uint8, bit for bit).

Runs on the CUDA card; ``run`` takes ``device="cpu"`` for a CPU run. The
captures, the writer, the drawing, the display and the gallery photos go
through the module-level names of ``apps/realtime.py`` (``open_capture``,
``open_writer``, ``annotate_batch``, ``show_frame``, ``read_image``), and
the pipeline through its ``app_pipeline``.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from ..ops.resize import resize_bilinear_u8_exact
from . import realtime

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Dual-camera Face Re-ID")
    parser.add_argument("--source1", type=str, required=True,
                        help="First camera (rtsp:// URL, file, or index)")
    parser.add_argument("--source2", type=str, required=True,
                        help="Second camera")
    parser.add_argument("--det-weight", type=str,
                        default="./weights/det_10g.onnx")
    parser.add_argument("--rec-weight", type=str,
                        default="./weights/w600k_r50.onnx")
    parser.add_argument("--similarity-thresh", type=float, default=0.4)
    parser.add_argument("--confidence-thresh", type=float, default=0.5)
    parser.add_argument("--faces-dir", type=str, default="./faces")
    parser.add_argument("--max-num", type=int, default=0)
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--output", type=str, default="")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--reconnect-delay", type=float, default=2.0,
                        help="Seconds between reconnect attempts")
    return parser.parse_args(argv)


def connect_to_camera(source, reconnect_delay: float = 2.0,
                      attempts: int = 3):
    """An opened capture of ``source`` (``realtime.open_capture``), tried
    ``attempts`` times ``reconnect_delay`` seconds apart; RuntimeError
    when none opens."""
    for i in range(attempts):
        cap = realtime.open_capture(str(source))
        if cap.isOpened():
            return cap
        logger.warning("Could not open %s (attempt %d/%d)", source, i + 1,
                       attempts)
        time.sleep(reconnect_delay)
    raise RuntimeError(f"Could not connect to camera {source!r}")


def run(params: argparse.Namespace, device=None) -> dict:
    """The app: gallery, then the two cameras in lockstep until either
    ends. Returns {"frames": frames served, "targets": gallery size}."""
    pipeline = realtime.app_pipeline(params, device)
    targets, colors = realtime.load_gallery(pipeline, params.faces_dir)
    cap1 = connect_to_camera(params.source1, params.reconnect_delay)
    cap2 = connect_to_camera(params.source2, params.reconnect_delay)

    writer = None
    n = 0
    try:
        while True:
            ok1, f1 = cap1.read()
            ok2, f2 = cap2.read()
            if not (ok1 and ok2):
                break
            if f1.shape != f2.shape:
                # on the pipeline's device: the exact-u8 resize is int32
                # arithmetic, slow on the host at camera sizes
                f2 = resize_bilinear_u8_exact(
                    torch.from_numpy(f2).to(pipeline.device),
                    f1.shape[:2]).cpu().numpy()
            batch = np.stack([f1, f2])
            out = pipeline(batch, max_num=params.max_num)
            realtime.annotate_batch(batch, out, pipeline.names, colors)
            combined = np.hstack([batch[0], batch[1]])
            if params.output:
                if writer is None:
                    writer = realtime.open_writer(
                        params.output, 24.0,
                        (combined.shape[1], combined.shape[0]))
                writer.write(combined)
            if params.show and not realtime.show_frame(combined):
                break
            n += 2
            if params.max_frames and n >= params.max_frames:
                break
    finally:
        cap1.release()
        cap2.release()
        if writer is not None:
            writer.release()
        if params.show:
            import cv2

            cv2.destroyAllWindows()
    return {"frames": n, "targets": len(targets)}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
