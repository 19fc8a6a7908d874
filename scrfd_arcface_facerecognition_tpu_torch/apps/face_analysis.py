"""FaceAnalysis-shaped facade over the port's pipeline.

The reference's clustering and verification engines consume insightface's
FaceAnalysis('buffalo_l') (smart_face_recognition.py:353-359, 912-913):
``app.get(image) -> [Face{bbox, kps, det_score, embedding,
normed_embedding}]``. This module gives the same surface over
``FacePipeline``, so the engines above it do not depend on the stack.

``get_batch`` routes images as the JAX package's facade does, so an image
takes the same route in both: groups of at least ``MIN_STATIC_GROUP``
same-shape images run the per-shape program in chunks of ``chunk``
(several chunks stream through ``process_stream``); smaller groups merge
into 256-px buckets, at most 8 images a call, through
``FacePipeline.call_dynamic``, whose per-image letterbox matrices give
the exact-shape canvas. The JAX facade pads each batch to a power of two
to bound its compile count; the port compiles nothing, so it does not pad.
Face crops are warped by kernel K1 on the card.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..pipeline import Detector, Embedder, FacePipeline


@dataclasses.dataclass
class Face:
    bbox: np.ndarray            # (4,) x1y1x2y2
    kps: np.ndarray             # (5, 2)
    det_score: float
    embedding: np.ndarray       # (512,) raw
    normed_embedding: np.ndarray  # (512,) L2-normalized

    @property
    def sex(self):  # genderage models are not supported (the reference
        return None  # pipelines do not use them)


class FaceAnalysis:
    """Drop-in facade: FaceAnalysis(name=...) / prepare / get.

    Weights come in as Flax-layout numpy trees (``det_variables`` /
    ``rec_variables``, see ``models/weights.py``); without them the
    weights are the seeded init. Runs on the CUDA card unless
    ``device="cpu"`` is passed.
    """

    def __init__(self, name: str = "buffalo_l",
                 det_variant: str = "det_10g", rec_variant: str = "w600k_r50",
                 det_variables: Any = None, rec_variables: Any = None,
                 dtype: Any = None, seed: int = 0, max_det: int = 16,
                 chunk: int = 16, det_onnx: Optional[str] = None,
                 rec_onnx: Optional[str] = None,
                 pipeline_kwargs: Optional[dict] = None, device=None):
        if dtype not in (None, torch.float32):
            raise ValueError(
                f"dtype {dtype!r}: the port computes in float32 only; "
                f"reduced-precision compute is not ported yet "
                f"(ROADMAP.md queue 1, item 2)")
        if det_onnx is not None or rec_onnx is not None:
            raise NotImplementedError(
                "det_onnx / rec_onnx: the ONNX graph executor is not ported "
                "yet (ROADMAP.md queue 1, item 6); load released weights "
                "with models.config_from_graph.variables_from_onnx instead")
        self.device = resolve_device(device)
        self.name = name
        self.chunk = chunk  # images a static batch (bounds device memory:
        # a batch embeds up to chunk * max_det 112x112 crops at once)
        self.detector = Detector(det_variant, variables=det_variables,
                                 seed=seed, max_det=max_det,
                                 device=self.device)
        self.embedder = Embedder(rec_variant, variables=rec_variables,
                                 seed=seed, device=self.device)
        self.det_thresh = 0.5
        # the pipeline's bucketed embed path; its gallery stays empty and
        # the match outputs are ignored
        self._pipe = FacePipeline(detector=self.detector,
                                  embedder=self.embedder,
                                  gallery_capacity=8, max_det=max_det,
                                  device=self.device,
                                  **(pipeline_kwargs or {}))
        self._microbatcher = None

    def enable_microbatch(self, max_batch: int = 32,
                          max_wait_ms: float = 4.0):
        """Coalesce concurrent get() calls (e.g. web request threads) into
        shared batches (``runtime.microbatch.MicroBatcher``). get_batch
        shape-buckets, so mixed request shapes are fine. Returns the
        batcher (stats: n_items / n_batches / max_batch_seen)."""
        from ..runtime.microbatch import MicroBatcher

        if self._microbatcher is not None:
            mb = self._microbatcher
            # compare the constructor's own max_wait_ms, not max_wait_s *
            # 1000: float round trips and the negative clamp would make a
            # same-argument re-enable raise
            if (mb.max_batch, mb.max_wait_ms) != (max_batch,
                                                  float(max_wait_ms)):
                raise ValueError(
                    "microbatch already enabled with different parameters "
                    "— disable_microbatch() first to retune")
            return mb
        self._microbatcher = MicroBatcher(
            lambda imgs, max_num=0: self._get_batch_direct(
                imgs, max_num=max_num),
            max_batch=max_batch, max_wait_ms=max_wait_ms)
        return self._microbatcher

    def disable_microbatch(self) -> None:
        if self._microbatcher is not None:
            self._microbatcher.close()
            self._microbatcher = None

    def prepare(self, ctx_id: int = 0, det_size: Tuple[int, int] = (640, 640),
                det_thresh: float = 0.5) -> None:
        """API mirror of insightface prepare(); ctx_id is accepted for
        compatibility (the device is the constructor's)."""
        self.detector.input_size = (det_size[1], det_size[0])
        self.detector.conf_thres = det_thresh
        self.det_thresh = det_thresh

    def get(self, image, max_num: int = 0) -> List[Face]:
        """Detect, align and embed every face of one BGR image. With
        enable_microbatch(), concurrent calls from different threads
        share batches (the routing lives in get_batch)."""
        return self.get_batch([np.asarray(image)], max_num=max_num)[0]

    # shape groups at least this large run the per-shape program (video,
    # repeated shapes); smaller ones merge into padded buckets whose
    # letterbox geometry rides in as data (exact-shape numerics either way)
    MIN_STATIC_GROUP = 8
    BUCKET = 256
    DYNAMIC_CHUNK = 8

    def get_batch(self, images, max_num: int = 0) -> List[List[Face]]:
        """Faces of each image. Same-shape groups run as one batch; mixed
        shapes merge into shape buckets (``ops.letterbox_matrices``).

        With enable_microbatch(), request-sized lists (smaller than
        MIN_STATIC_GROUP) go item by item through the shared collector, so
        concurrent requests, each a 1-2 image call on its own thread,
        share one batch; ``submit_async`` lands all of one caller's images
        in the same window. Large lists are batches already and go
        direct."""
        mb = self._microbatcher
        if mb is not None and 0 < len(images) < self.MIN_STATIC_GROUP:
            from ..runtime.microbatch import MicroBatcherClosed

            # the collector thread itself must never re-enter the batcher
            if threading.current_thread() is not mb._thread:
                try:
                    futs = [mb.submit_async(np.asarray(im),
                                            key=("max_num", max_num),
                                            key_kwargs={"max_num": max_num})
                            for im in images]
                    return [f.result() for f in futs]
                except MicroBatcherClosed:
                    pass   # disable_microbatch() raced us: direct path
        return self._get_batch_direct(images, max_num=max_num)

    def routes(self, images) -> Tuple[List[List[int]], dict]:
        """The routing of ``get_batch``: (static chunks of image indices,
        {(bucket_h, bucket_w): indices} of the dynamic route)."""
        by_shape: dict = {}
        for i, im in enumerate(images):
            by_shape.setdefault(tuple(np.shape(im)), []).append(i)
        static_chunks, dyn_by_bucket = [], {}
        for shape, idxs in by_shape.items():
            if len(idxs) >= self.MIN_STATIC_GROUP:
                for c in range(0, len(idxs), self.chunk):
                    static_chunks.append(idxs[c:c + self.chunk])
            else:
                b = self.BUCKET
                key = (-(-shape[0] // b) * b, -(-shape[1] // b) * b)
                dyn_by_bucket.setdefault(key, []).extend(idxs)
        return static_chunks, dyn_by_bucket

    def dynamic_inputs(self, images, idxs, bucket_hw):
        """call_dynamic's inputs for images ``idxs`` in one bucket: frames
        (n, bh, bw, 3) u8 zero-padded, wy (n, mh, bh), wx (n, mw, bw),
        det_scales (n,), frame_hws (n, 2), numpy."""
        bh, bw = bucket_hw
        model_hw = self.detector.input_size
        n = len(idxs)
        frames = np.zeros((n, bh, bw, 3), np.uint8)
        wys = np.zeros((n, model_hw[0], bh), np.float32)
        wxs = np.zeros((n, model_hw[1], bw), np.float32)
        scales = np.ones((n,), np.float32)
        hws = np.zeros((n, 2), np.int32)
        for bi, i in enumerate(idxs):
            im = images[i]
            h, w = im.shape[:2]
            frames[bi, :h, :w] = im
            wys[bi], wxs[bi], scales[bi] = ops.letterbox_matrices(
                (h, w), (bh, bw), model_hw)
            hws[bi] = (h, w)
        return frames, wys, wxs, scales, hws

    def _get_batch_direct(self, images, max_num: int = 0
                          ) -> List[List[Face]]:
        images = [np.asarray(im) for im in images]
        out: List[Optional[List[Face]]] = [None] * len(images)
        static_chunks, dyn_by_bucket = self.routes(images)

        def stack(idxs):
            return np.stack([images[i] for i in idxs])

        if len(static_chunks) > 1:
            # chunks may differ in shape; results come back in order
            batches = (stack(idxs) for idxs in static_chunks)
            for idxs, res in zip(static_chunks, self._pipe.process_stream(
                    batches, max_num=max_num)):
                self._scatter_faces(res, idxs, out)
        else:
            for idxs in static_chunks:
                res = self._pipe(stack(idxs), max_num=max_num)
                self._scatter_faces(res, idxs, out)

        # the matrices are (n, 640, bh) + (n, 640, bw) f32: chunk smaller
        # than the static route to bound their footprint
        step = max(1, min(self.chunk, self.DYNAMIC_CHUNK))
        for bucket_hw, idxs in dyn_by_bucket.items():
            for c in range(0, len(idxs), step):
                part = idxs[c:c + step]
                res = self._pipe.call_dynamic(
                    *self.dynamic_inputs(images, part, bucket_hw),
                    max_num=max_num)
                self._scatter_faces(res, part, out)
        return out  # type: ignore[return-value]

    def _scatter_faces(self, res, idxs, out) -> None:
        boxes = res.boxes.cpu().numpy()
        scores = res.scores.cpu().numpy()
        kps = res.kps.cpu().numpy()
        valid = res.valid.cpu().numpy()
        embs = res.embeddings.cpu().numpy()  # L2-normalized
        for bi, i in enumerate(idxs):
            faces = []
            for k in range(boxes.shape[1]):
                if not valid[bi, k]:
                    continue
                norm = embs[bi, k]
                # the raw embedding equals the normed one up to scale; every
                # consumer of `.embedding` uses scale-invariant cosine
                faces.append(Face(bbox=boxes[bi, k], kps=kps[bi, k],
                                  det_score=float(scores[bi, k]),
                                  embedding=norm, normed_embedding=norm))
            out[i] = faces
