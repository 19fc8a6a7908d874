"""N-camera face re-identification: every live stream in one device batch.

    python -m scrfd_arcface_facerecognition_tpu_torch.apps.multistream
        --sources rtsp://cam1 rtsp://cam2 video3.mp4 --faces-dir faces
        [--output-dir out] [--decode-pool]                     (one line)

The JAX package's multi-camera app, with the same flags, dests and
defaults. Each round holds one frame of every live camera (smaller frames
zero-padded to the largest), and one ``FacePipeline`` call at bfloat16
compute serves them all. The rounds come from decode threads
(``runtime/video.py`` ``MultiStreamReader``) or, with ``--decode-pool``,
from decode processes over shared memory (``runtime/decode_pool.py``).
Each stream's annotated frames go to ``<output-dir>/stream_<i>.mp4`` at
the stream's own size and rate.

Runs on the CUDA card; ``run`` takes ``device="cpu"`` for a CPU run. The
captures, writers, drawing and gallery photos go through the module-level
names of ``apps/realtime.py`` (``open_capture``, ``open_writer``,
``annotate_batch``, ``read_image``) and the pipeline through its
``app_pipeline``. With ``--decode-pool``, ``realtime.open_capture`` is
the pool's opener: it runs in the decode processes, so it must be a
function defined at the top level of an importable module.
"""
from __future__ import annotations

import argparse
import logging
import os

from ..runtime.native import (CAP_PROP_FPS, CAP_PROP_FRAME_HEIGHT,
                              CAP_PROP_FRAME_WIDTH)
from ..runtime.video import MultiStreamReader
from . import realtime

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="N-camera Face Re-ID")
    parser.add_argument("--sources", type=str, nargs="+", required=True,
                        help="Any mix of rtsp:// URLs, files, webcam indices")
    parser.add_argument("--det-weight", type=str,
                        default="./weights/det_10g.onnx")
    parser.add_argument("--rec-weight", type=str,
                        default="./weights/w600k_r50.onnx")
    parser.add_argument("--similarity-thresh", type=float, default=0.4)
    parser.add_argument("--confidence-thresh", type=float, default=0.5)
    parser.add_argument("--faces-dir", type=str, default="./faces")
    parser.add_argument("--max-num", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default="",
                        help="Write annotated <dir>/stream_<i>.mp4 files")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="Stop after this many frames total (0 = all)")
    parser.add_argument("--decode-pool", action="store_true",
                        help="Decode in worker processes via shared memory "
                             "(runtime/decode_pool.DecodePool) instead of "
                             "threads")
    parser.add_argument("--decode-workers", type=int, default=0,
                        help="Decode processes for --decode-pool "
                             "(0 = one per core)")
    parser.add_argument("--slot-bytes", type=int, default=0,
                        help="Shared-memory frame slot size for "
                             "--decode-pool (0 = 1080p BGR). Must cover "
                             "the largest source's h*w*3; oversized "
                             "frames drop the stream with an error log")
    return parser.parse_args(argv)


def stream_writer(reader, sid: int, batch, output_dir: str):
    """Stream ``sid``'s writer, sized from the stream's own frames (the
    batch is padded to the largest live stream, and shrinks as streams
    end); -> (writer, h, w)."""
    caps = getattr(reader, "captures", None)
    if caps is not None:            # decode threads: the captures are here
        cap = caps[sid]
        sw = int(cap.get(CAP_PROP_FRAME_WIDTH)) or batch.shape[2]
        sh = int(cap.get(CAP_PROP_FRAME_HEIGHT)) or batch.shape[1]
        fps = cap.get(CAP_PROP_FPS) or 24.0
    else:                           # the pool: from the stream's first frame
        sh, sw = reader.stream_dims.get(sid, batch.shape[1:3])
        fps = reader.stream_fps.get(sid) or 24.0
    path = os.path.join(output_dir, f"stream_{sid}.mp4")
    return realtime.open_writer(path, fps, (sw, sh)), sh, sw


def run(params: argparse.Namespace, device=None) -> dict:
    """The app: gallery, then every round through the pipeline, annotated
    and written per stream. Returns {"frames": frames served, "streams":
    sources, "targets": gallery size}."""
    pipeline = realtime.app_pipeline(params, device)
    targets, colors = realtime.load_gallery(pipeline, params.faces_dir)
    if params.decode_pool:
        from ..runtime.decode_pool import DecodePool

        reader = DecodePool(params.sources,
                            workers=params.decode_workers or None,
                            slot_bytes=params.slot_bytes or None,
                            opener=realtime.open_capture)
    else:
        reader = MultiStreamReader([realtime.open_capture(s)
                                    for s in params.sources])
    writers = {}
    n = 0
    try:
        for batch, ids in reader:
            out = pipeline(batch, max_num=params.max_num)
            realtime.annotate_batch(batch, out, pipeline.names, colors)
            if params.output_dir:
                os.makedirs(params.output_dir, exist_ok=True)
                for bi, sid in enumerate(ids):
                    if sid not in writers:
                        writers[sid] = stream_writer(reader, sid, batch,
                                                     params.output_dir)
                    w, sh, sw = writers[sid]
                    w.write(batch[bi, :sh, :sw])
            n += len(ids)
            if params.max_frames and n >= params.max_frames:
                break
    finally:
        reader.release()
        for w, _, _ in writers.values():
            w.release()
    return {"frames": n, "streams": len(params.sources),
            "targets": len(targets)}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
