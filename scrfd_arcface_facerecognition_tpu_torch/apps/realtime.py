"""Real-time face re-identification CLI (the JAX package's realtime app).

    python -m scrfd_arcface_facerecognition_tpu_torch.apps.realtime
        --source in.mp4 --faces-dir faces --output out.mp4   (one line)

The same flags, dests and defaults as the JAX app: a gallery built from a
directory of face photos, then the video decoded in the background
(``runtime/video.py`` ``BatchedFrameReader`` over the native ring) and fed
in batches through ``FacePipeline.process_stream`` at bfloat16 compute,
each batch annotated and written. Runs on the CUDA card; ``run`` takes
``device="cpu"`` for a CPU run, and nothing falls back to the CPU.

The card's machine has no cv2. The functions that need it are module-level
names a caller can replace: ``read_image`` (gallery photos),
``open_capture`` (the source), ``open_writer`` (the output),
``annotate_batch`` (drawing) and ``show_frame`` (``--show``).

Weight files that exist at ``--det-weight`` / ``--rec-weight`` run
through the ONNX graph executor (``models/onnx_exec.py``); without the
files the variants are the seeded models the file names name, as in the
JAX app. Not ported yet: ``--disagg`` above 0 (multi-device serving,
ROADMAP.md queue 1, item 8), which raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import itertools
import logging
import os
import random
from typing import List, Tuple

import numpy as np
import torch

from ..pipeline import FacePipeline
from ..runtime.native import (CAP_PROP_FPS, CAP_PROP_FRAME_HEIGHT,
                              CAP_PROP_FRAME_WIDTH)
from ..runtime.video import BatchedFrameReader, open_capture
from ..utils.drawing import draw_bbox, draw_bbox_info

logger = logging.getLogger(__name__)

_VARIANT_BY_WEIGHT = {
    "det_500m": "det_500m", "det_2.5g": "det_2.5g", "det_10g": "det_10g",
    "w600k_mbf": "w600k_mbf", "w600k_r50": "w600k_r50",
}


def variant_from_path(path: str, default: str) -> str:
    stem = os.path.splitext(os.path.basename(str(path)))[0]
    return _VARIANT_BY_WEIGHT.get(stem, default)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Face Detection-and-Recognition")
    parser.add_argument("--det-weight", type=str,
                        default="./weights/det_10g.onnx",
                        help="Path to detection model")
    parser.add_argument("--rec-weight", type=str,
                        default="./weights/w600k_r50.onnx",
                        help="Path to recognition model")
    parser.add_argument("--similarity-thresh", type=float, default=0.4,
                        help="Similarity threshold between faces")
    parser.add_argument("--confidence-thresh", type=float, default=0.5,
                        help="Confidence threshold for face detection")
    parser.add_argument("--faces-dir", type=str, default="./faces",
                        help="Path to faces stored dir")
    parser.add_argument("--source", type=str,
                        default="./assets/in_video.mp4",
                        help="Video file or video camera source. i.e 0 - webcam")
    parser.add_argument("--max-num", type=int, default=0,
                        help="Maximum number of face detections from a frame")
    parser.add_argument("--log-level", type=str, default="INFO",
                        help="Logging level")
    parser.add_argument("--batch", type=int, default=8,
                        help="Device batch size (frames per device step)")
    parser.add_argument("--output", type=str, default="output_video.mp4",
                        help="Annotated output video path")
    parser.add_argument("--show", action="store_true",
                        help="Display frames (requires a display)")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="Stop after N frames (0 = all)")
    parser.add_argument("--disagg", type=int, default=0,
                        help="Stage-disaggregated deployment over several "
                             "devices (not ported: must be 0)")
    return parser.parse_args(argv)


def read_image(path: str):
    """A BGR u8 image from ``path``, or None where it is not one."""
    import cv2

    return cv2.imread(path)


def open_writer(path: str, fps: float, size: Tuple[int, int]):
    """The annotated output: a writer with ``write(frame)`` and
    ``release()``."""
    import cv2

    return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)


def show_frame(frame) -> bool:
    """Display one frame; False when the user asked to stop ('q')."""
    import cv2

    cv2.imshow("Frame", frame)
    return (cv2.waitKey(1) & 0xFF) != ord("q")


def build_targets(pipeline: FacePipeline, faces_dir: str
                  ) -> List[Tuple[np.ndarray, str]]:
    """The gallery from a directory of face photos: the most prominent face
    of each image, embedded and L2-normalized, named by the file."""
    targets = []
    for filename in sorted(os.listdir(faces_dir)):
        name = os.path.splitext(filename)[0]
        image = read_image(os.path.join(faces_dir, filename))
        if image is None:
            continue
        det, kps = pipeline.detector.detect(image, max_num=1)
        if len(det) == 0:
            logger.warning("No face detected in %s. Skipping...", filename)
            continue
        emb = pipeline.embedder(image, kps[0])
        targets.append((emb / max(np.linalg.norm(emb), 1e-12), name))
    return targets


def annotate_batch(frames: np.ndarray, out, names: List[str], colors) -> None:
    """Draw each frame's detections and matches onto it, in place."""
    boxes = out.boxes.cpu().numpy()
    valid = out.valid.cpu().numpy()
    sims = out.match_sim.cpu().numpy()
    match_idx = out.match_idx.cpu().numpy()
    for bi in range(frames.shape[0]):
        for k in range(boxes.shape[1]):
            if not valid[bi, k]:
                continue
            bbox = boxes[bi, k]
            gi = int(match_idx[bi, k])
            if gi >= 0:
                name = names[gi]
                draw_bbox_info(frames[bi], bbox, similarity=float(sims[bi, k]),
                               name=name, color=colors[name])
            else:
                draw_bbox(frames[bi], bbox, (255, 0, 0))


def app_pipeline(params: argparse.Namespace, device=None) -> FacePipeline:
    """The camera apps' pipeline at bfloat16 compute: weight files that
    exist at ``--det-weight`` / ``--rec-weight`` run as graphs (the graph
    executor); else the seeded variants the file names name."""
    return FacePipeline(
        det_variant=variant_from_path(params.det_weight, "det_10g"),
        rec_variant=variant_from_path(params.rec_weight, "w600k_r50"),
        det_onnx=(params.det_weight if os.path.exists(params.det_weight)
                  else None),
        rec_onnx=(params.rec_weight if os.path.exists(params.rec_weight)
                  else None),
        conf_thres=params.confidence_thresh,
        similarity_thresh=params.similarity_thresh,
        dtype=torch.bfloat16, device=device)


def load_gallery(pipeline: FacePipeline, faces_dir: str):
    """The pipeline's gallery from ``faces_dir`` (``build_targets``) and a
    random drawing colour a name; -> (targets, colors)."""
    targets = build_targets(pipeline, faces_dir)
    if targets:
        pipeline.set_gallery(np.stack([t[0] for t in targets]),
                             [t[1] for t in targets])
    colors = {name: (random.randint(0, 256), random.randint(0, 256),
                     random.randint(0, 256)) for _, name in targets}
    return targets, colors


def run(params: argparse.Namespace, device=None) -> dict:
    """The app: gallery, then the stream, annotated and written. Returns
    {"frames": frames written, "targets": gallery size}."""
    logging.basicConfig(
        level=getattr(logging, params.log_level.upper(), None),
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if params.disagg:
        raise NotImplementedError(
            f"--disagg {params.disagg}: multi-device serving is not ported "
            f"yet (ROADMAP.md queue 1, item 8); run with --disagg 0")
    pipeline = app_pipeline(params, device)
    targets, colors = load_gallery(pipeline, params.faces_dir)

    # the native ffmpeg decoder for files and streams, cv2 for webcams
    cap = open_capture(str(params.source))
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video source {params.source!r}")
    width = int(cap.get(CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(CAP_PROP_FPS) or 24.0
    writer = open_writer(params.output, fps, (width, height))

    reader = BatchedFrameReader(cap, batch=params.batch)
    n_frames = 0
    try:
        # the stream runs batches ahead of the drawing (process_stream's
        # depth); the tee hands the drawing the same batches in order
        feed, draw_feed = itertools.tee(iter(reader))
        stream = pipeline.process_stream(feed, max_num=params.max_num)
        for batch, out in zip(draw_feed, stream):
            annotate_batch(batch, out, pipeline.names, colors)
            for frame in batch:
                writer.write(frame)
                if params.show and not show_frame(frame):
                    raise KeyboardInterrupt
            n_frames += len(batch)
            if params.max_frames and n_frames >= params.max_frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        # close() joins the decode thread; only then may the capture be
        # released (the producer may still be inside cap.read()); a failed
        # join leaves the capture unreleased
        if reader.close():
            cap.release()
        writer.release()
        if params.show:
            import cv2

            cv2.destroyAllWindows()
    return {"frames": n_frames, "targets": len(targets)}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
