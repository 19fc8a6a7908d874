"""The end-to-end path: frames -> detections + embeddings + gallery matches.

Stage 1 detects (letterbox -> SCRFD -> decode -> NMS); stage 2 aligns,
warps, embeds and matches only the valid faces, compacted to the front and
padded to a face-count bucket. The one host sync per batch is the face
count that picks the bucket; everything else stays on the device. On the
card the count travels to pinned host memory behind an event
(``CountReadback``), so ``process_stream`` can queue the next batches'
detects before it waits for one.

Frames split over a mesh (``parallel.shard_frames``) run each part on its
slot's device with that device's replicas of the weights and gallery
(the JAX package's ``_placed``): every part's detect is queued before any
count is read, and the outputs are joined in frame order on the first
slot's device.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import ops
from ..device import on_device, resolve_device
from ..parallel.data_parallel import Replicas, ShardedFrames
from ..parallel.sharded_gallery import RowShards
from ..stages import interval, now, span, stage
from .detector import (Detections, Detector, FrameStaging, as_frames,
                       detect_batch, detect_batch_dynamic)
from .embedder import Embedder, embed_crops, embed_faces


class PipelineOutput(NamedTuple):
    """Per-frame padded results, tensors on the pipeline's device.

    boxes (B, K, 4); scores (B, K); kps (B, K, 5, 2); valid (B, K);
    count (B,); embeddings (B, K, 512) L2-normalized;
    match_idx (B, K) best gallery row (-1 below threshold or invalid);
    match_sim (B, K) best cosine similarity (0 where invalid).
    """
    boxes: torch.Tensor
    scores: torch.Tensor
    kps: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    embeddings: torch.Tensor
    match_idx: torch.Tensor
    match_sim: torch.Tensor


def _match_gallery(emb_flat: torch.Tensor,
                   gallery: Union[torch.Tensor, RowShards],
                   gallery_valid: Optional[torch.Tensor],
                   valid_flat: torch.Tensor, similarity_thresh: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, D) L2 embeddings -> best_idx (F,) int32 (-1 for invalid or
    below-threshold slots) and best_sim (F,) clamped to [0, inf), zero on
    invalid slots, empty galleries and non-finite similarities.

    The product is full float32 (no TF32), the reference's HIGHEST
    precision, whatever dtype the embeddings come in; ``argmax`` takes the
    first maximum, as ``jnp.argmax``. A row-sharded gallery (``RowShards``,
    which holds its own validity) gives the same maximum and row.
    """
    if isinstance(gallery, RowShards):
        best_sim, best_idx = gallery.best(emb_flat.float())
    else:
        sims = emb_flat.float() @ gallery.T                      # (F, G)
        sims = torch.where(gallery_valid[None, :], sims,
                           torch.full_like(sims, -torch.inf))
        best_sim = sims.max(dim=-1).values
        best_idx = sims.argmax(dim=-1)
    matched = valid_flat & (best_sim > similarity_thresh)
    best_idx = torch.where(matched, best_idx,
                           torch.full_like(best_idx, -1)).to(torch.int32)
    zero = torch.zeros_like(best_sim)
    best_sim = torch.where(valid_flat, torch.maximum(best_sim, zero), zero)
    best_sim = torch.where(torch.isfinite(best_sim), best_sim, zero)
    return best_idx, best_sim


def bucket_slots(valid: torch.Tensor, bucket: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K) valid -> the ``bucket`` flat slots stage 2 runs (valid ones
    first, stable order) and each slot's frame index (int32)."""
    k = valid.shape[1]
    order = torch.argsort((~valid.reshape(-1)).to(torch.uint8), stable=True)
    sel = order[:bucket]
    return sel, (sel // k).to(torch.int32)


def embed_and_match_bucketed(model, frames: torch.Tensor, det: Detections,
                             gallery, gallery_valid, *,
                             similarity_thresh: float,
                             bucket: int) -> PipelineOutput:
    """Stage 2 with face-count bucketing: only the first ``bucket`` slots
    of the compacted slate are warped, embedded and matched; the results
    are scattered back into the padded (B, K) layout."""
    b, k = det.valid.shape
    sel, frame_idx = bucket_slots(det.valid, bucket)
    flat_valid = det.valid.reshape(-1)
    kps_sel = det.kps.reshape(b * k, 5, 2)[sel]
    valid_sel = flat_valid[sel]
    emb_sel = embed_crops(model, frames, kps_sel, frame_idx, valid_sel)
    with stage("match"):
        best_idx, best_sim = _match_gallery(emb_sel, gallery, gallery_valid,
                                            valid_sel, similarity_thresh)
        emb = torch.zeros((b * k, emb_sel.shape[-1]), dtype=emb_sel.dtype,
                          device=emb_sel.device)
        emb[sel] = emb_sel
        idx_full = torch.full((b * k,), -1, dtype=torch.int32,
                              device=emb.device)
        idx_full[sel] = best_idx
        sim_full = torch.zeros((b * k,), dtype=torch.float32,
                               device=emb.device)
        sim_full[sel] = best_sim
    return PipelineOutput(boxes=det.boxes, scores=det.scores, kps=det.kps,
                          valid=det.valid, count=det.count,
                          embeddings=emb.reshape(b, k, -1),
                          match_idx=idx_full.reshape(b, k),
                          match_sim=sim_full.reshape(b, k))


def embed_and_match(model, frames: torch.Tensor, det: Detections,
                    gallery, gallery_valid, *,
                    similarity_thresh: float) -> PipelineOutput:
    """Stage 2 without bucketing: every (B, K) slot is warped, embedded
    and matched (invalid ones give zero embeddings)."""
    emb = embed_faces(model, frames, det.kps, det.valid)
    b, k, d = emb.shape
    with stage("match"):
        best_idx, best_sim = _match_gallery(
            emb.reshape(b * k, d), gallery, gallery_valid,
            det.valid.reshape(b * k), similarity_thresh)
    return PipelineOutput(boxes=det.boxes, scores=det.scores, kps=det.kps,
                          valid=det.valid, count=det.count, embeddings=emb,
                          match_idx=best_idx.reshape(b, k),
                          match_sim=best_sim.reshape(b, k))


def join_outputs(outs: List[PipelineOutput],
                 device: torch.device) -> PipelineOutput:
    """Per-slot outputs, in frame order, as one batch on ``device``."""
    return PipelineOutput(*(torch.cat([o[i].to(device) for o in outs])
                            for i in range(len(PipelineOutput._fields))))


class CountReadback:
    """A batch's face count on its way to the host.

    On the card the count is copied into pinned host memory without
    blocking, and an event is recorded behind the copy on the count's own
    device's stream; ``value()`` waits on that event alone (the
    counterpart of the JAX package's ``_read_counts``, which transfers a
    ready buffer). On the CPU it is the plain ``int``.
    """

    def __init__(self, count: torch.Tensor):
        self.event = None
        if count.device.type == "cuda":
            self.host = torch.empty((), dtype=count.dtype, pin_memory=True)
            self.host.copy_(count, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(count.device))
        else:
            self.host = count

    def value(self) -> int:
        with span("stream.count_wait"):
            if self.event is not None:
                self.event.synchronize()
            return int(self.host)


class Placement(NamedTuple):
    """What a batch (or a slot's part of one) runs with, on its device:
    the models, and the gallery (a tensor with its validity, or
    ``RowShards`` with ``gallery_valid`` None)."""
    detector: Optional[nn.Module]
    embedder: nn.Module
    gallery: Union[torch.Tensor, RowShards]
    gallery_valid: Optional[torch.Tensor]


class Dispatched(NamedTuple):
    """A batch whose detect is queued: its frames on the device, its
    detections, its face count on the way to the host and what its
    stage 2 runs with."""
    frames: torch.Tensor
    det: Detections
    count: CountReadback
    placed: Placement


class FacePipeline:
    """Detector + Embedder + gallery on one device.

    >>> pipe = FacePipeline(det_variant="det_10g", rec_variant="w600k_r50")
    >>> pipe.set_gallery(embs, names)
    >>> out = pipe(frames_u8)           # (B, H, W, 3) BGR batch

    Runs on the CUDA card unless ``device="cpu"`` is passed; a supplied
    detector or embedder must live on the same kind of device. ``dtype``
    is the models' compute dtype when the pipeline builds them (float32 or
    bfloat16); with a bfloat16 detector the letterbox computes in bfloat16
    too. ``det_onnx`` / ``rec_onnx`` run released ``.onnx`` graphs through
    the executor in place of the ``det_variant`` / ``rec_variant`` models.
    """

    def __init__(self, detector: Detector = None, embedder: Embedder = None,
                 det_variant: str = "det_10g", rec_variant: str = "w600k_r50",
                 conf_thres: float = 0.5, iou_thres: float = 0.4,
                 similarity_thresh: float = 0.4,
                 pre_nms: int = 256, max_det: int = 16,
                 gallery_capacity: int = 512,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 tight_canvas: bool = True, det_onnx: Optional[str] = None,
                 rec_onnx: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.detector = detector or Detector(
            det_variant, conf_thres=conf_thres, iou_thres=iou_thres,
            pre_nms=pre_nms, max_det=max_det, dtype=dtype, seed=seed,
            onnx_path=det_onnx, device=self.device)
        self.embedder = embedder or Embedder(rec_variant, dtype=dtype,
                                             seed=seed, onnx_path=rec_onnx,
                                             device=self.device)
        for part in (self.detector, self.embedder):
            if part.device.type != self.device.type:
                raise ValueError(f"{type(part).__name__} lives on "
                                 f"{part.device}, the pipeline on "
                                 f"{self.device}")
        self.similarity_thresh = similarity_thresh
        # a supplied detector is the one source of its slate sizes
        if detector is not None:
            self.pre_nms = detector.pre_nms
            self.max_det = detector.max_det
        else:
            self.pre_nms = pre_nms
            self.max_det = max_det
        # trim the all-zero letterbox pad band (ops.tight_letterbox_plan)
        self.tight_canvas = tight_canvas
        self.gallery_capacity = gallery_capacity
        self.emb_dim = self.embedder.emb_dim
        self.names: list = []
        self._gallery = torch.zeros((gallery_capacity, self.emb_dim),
                                    dtype=torch.float32, device=self.device)
        self._gallery_valid = torch.zeros((gallery_capacity,),
                                          dtype=torch.bool,
                                          device=self.device)
        self._staging = FrameStaging(self.device)
        # copies on the devices of sharded frames (the JAX package's
        # placement cache), each made again when its source changes
        self._replicas = {name: Replicas()
                          for name in ("det", "emb", "gallery", "valid")}

    # ------------------------------------------------------------- gallery

    def set_gallery(self, embeddings, names) -> None:
        """Install target embeddings (rows L2-normalized on the device),
        zero-padded to the gallery capacity."""
        embs = np.asarray(embeddings,
                          dtype=np.float32).reshape(-1, self.emb_dim)
        g = len(embs)
        if g > self.gallery_capacity:
            raise ValueError(f"gallery ({g}) exceeds capacity "
                             f"({self.gallery_capacity})")
        if len(names) != g:
            raise ValueError("names/embeddings length mismatch")
        buf = np.zeros((self.gallery_capacity, self.emb_dim), np.float32)
        buf[:g] = embs
        valid = np.zeros((self.gallery_capacity,), bool)
        valid[:g] = True
        self._gallery = ops.l2_normalize(torch.from_numpy(buf).to(self.device))
        self._gallery_valid = torch.from_numpy(valid).to(self.device)
        self.names = list(names)
        # multi-device placements hold copies of the gallery: drop them
        for r in self._replicas.values():
            r.clear()

    def _home(self) -> Placement:
        return Placement(self.detector.model, self.embedder.model,
                         self._gallery, self._gallery_valid)

    def _placed(self, frames: ShardedFrames) -> List[Placement]:
        """A placement for each slot of sharded frames: copies of the
        models and the gallery on the slot's device (one set a device),
        made again when the pipeline's live ones change, in place too."""
        devs = [s.device for s in frames.slots]
        r = self._replicas
        det = r["det"].on(self.detector.model, devs)
        emb = r["emb"].on(self.embedder.model, devs)
        gal = r["gallery"].on(self._gallery, devs)
        valid = r["valid"].on(self._gallery_valid, devs)
        return [Placement(det[d], emb[d], gal[d], valid[d]) for d in devs]

    # ------------------------------------------------------------- forward

    @torch.inference_mode()
    def __call__(self, frames, max_num: int = 0, metric: str = "max",
                 bucketed: bool = True) -> PipelineOutput:
        """(B, H, W, 3) u8 BGR frames of one shape, or frames sharded over
        a mesh (``parallel.shard_frames``) -> PipelineOutput.
        ``bucketed=False`` embeds every slot instead of the valid faces'
        bucket (same results, more work; no host sync)."""
        batch = self._dispatch(frames, max_num, metric)
        if bucketed:
            return self._finish(batch)
        parts = batch if isinstance(batch, list) else [batch]
        outs = []
        for d in parts:
            with on_device(d.frames.device):
                outs.append(embed_and_match(
                    d.placed.embedder, d.frames, d.det, d.placed.gallery,
                    d.placed.gallery_valid,
                    similarity_thresh=self.similarity_thresh))
        return (join_outputs(outs, parts[0].frames.device)
                if isinstance(batch, list) else outs[0])

    def _detect(self, frames: torch.Tensor, max_num: int, metric: str,
                model: Optional[nn.Module] = None) -> Detections:
        """Stage 1 with the pipeline's detector, or ``model`` (a replica
        on the frames' device)."""
        plan = self.detector.plan(tuple(frames.shape[1:3]),
                                  tight=self.tight_canvas)
        return detect_batch(
            self.detector.model if model is None else model, frames,
            plan=plan, conf_thres=self.detector.conf_thres,
            iou_thres=self.detector.iou_thres, pre_nms=self.pre_nms,
            max_det=self.max_det, max_num=max_num, metric=metric,
            compute_dtype=self.detector.dtype)

    @torch.inference_mode()
    def _dispatch(self, frames, max_num: int, metric: str
                  ) -> Union[Dispatched, List[Dispatched]]:
        """Stage 1 queued on the device, and the face count sent on its
        way to the host; nothing here waits for the device. Sharded
        frames give one ``Dispatched`` a slot, every slot's detect queued
        before any count is read."""
        with span("stream.dispatch"):
            if isinstance(frames, ShardedFrames):
                return [self._dispatch_part(part, placed, max_num, metric)
                        for part, placed in zip(frames.parts,
                                                self._placed(frames))]
            return self._dispatch_part(self._staging(frames), self._home(),
                                       max_num, metric)

    def _dispatch_part(self, frames: torch.Tensor, placed: Placement,
                       max_num: int, metric: str) -> Dispatched:
        with on_device(frames.device):
            det = self._detect(frames, max_num, metric, placed.detector)
            return Dispatched(frames, det, CountReadback(det.valid.sum()),
                              placed)

    @torch.inference_mode()
    def call_dynamic(self, frames, wy, wx, det_scales, frame_hws,
                     max_num: int = 0, metric: str = "max"
                     ) -> PipelineOutput:
        """A batch of images of mixed shapes, letterbox geometry as data.

        frames (B, Hp, Wp, 3) u8, each image zero-padded bottom / right
        past its content; wy (B, mh, Hp) / wx (B, mw, Wp) stacked
        ``ops.letterbox_matrices``; det_scales (B,); frame_hws (B, 2)
        original sizes. The canvas is the square (untrimmed) one of the
        detector's input size, as exact-shape letterboxing gives it.
        ``frames`` may be sharded over a mesh; the per-image arrays then
        split with them.
        """
        if isinstance(frames, ShardedFrames):
            parts, placed = frames.parts, self._placed(frames)
        else:
            parts, placed = [as_frames(frames, self.device)], [self._home()]
        host = [np.asarray(a) for a in (wy, wx, det_scales, frame_hws)]
        batch, lo = [], 0
        for part, pl in zip(parts, placed):
            hi = lo + part.shape[0]
            batch.append(self._dispatch_dynamic(
                part, pl, *(a[lo:hi] for a in host), max_num, metric))
            lo = hi
        return self._finish(batch if isinstance(frames, ShardedFrames)
                            else batch[0])

    def _dispatch_dynamic(self, frames, placed: Placement, wy, wx,
                          det_scales, frame_hws, max_num: int,
                          metric: str) -> Dispatched:
        def dev(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=frames.device)

        with on_device(frames.device):
            inv_scale = 1.0 / dev(det_scales, torch.float32)
            det = detect_batch_dynamic(
                placed.detector, frames, dev(wy, torch.float32),
                dev(wx, torch.float32), inv_scale,
                dev(frame_hws, torch.int32),
                model_hw=self.detector.input_size,
                conf_thres=self.detector.conf_thres,
                iou_thres=self.detector.iou_thres, pre_nms=self.pre_nms,
                max_det=self.max_det, max_num=max_num, metric=metric)
            return Dispatched(frames, det, CountReadback(det.valid.sum()),
                              placed)

    def process_stream(self, frames_iter, max_num: int = 0,
                       metric: str = "max", depth: int = 2):
        """Yields a PipelineOutput per input batch (frames, or frames
        sharded over a mesh), in order (batches may differ in shape),
        keeping ``depth`` batches in flight: batches
        i+1..i+depth are dispatched before batch i's face count is read,
        so the count's trip to the host overlaps device work instead of
        draining the queue. ``depth`` below 1 acts as 1. A batch's wait
        in ``pending`` is the ``stream.queued`` interval."""
        pending = deque()
        for frames in frames_iter:
            pending.append((self._dispatch(frames, max_num, metric), now()))
            if len(pending) > max(1, depth):
                yield self._finish_queued(*pending.popleft())
        while pending:
            yield self._finish_queued(*pending.popleft())

    def _finish_queued(self, batch: Union[Dispatched, List[Dispatched]],
                       dispatched_at: int) -> PipelineOutput:
        interval("stream.queued", dispatched_at, now())
        return self._finish(batch)

    @staticmethod
    def _round_bucket(count: int, cap: int) -> int:
        """Smallest face-count bucket >= count: powers of two from 8 up to
        64, then multiples of 64, capped at ``cap``."""
        if count <= 0:
            return 0
        if count <= 64:
            b = 8
            while b < count:
                b *= 2
        else:
            b = -(-count // 64) * 64
        return min(b, cap)

    @torch.inference_mode()
    def _finish(self, batch: Union[Dispatched, List[Dispatched]]
                ) -> PipelineOutput:
        """Stage 2 for a dispatched detect, bucketed by the real face
        count: the batch's one wait for the device. A sharded batch's
        parts each take the bucket of their own count and are joined in
        frame order on the first part's device."""
        with span("stream.finish"):
            if isinstance(batch, list):
                return join_outputs([self._finish_part(d) for d in batch],
                                    batch[0].frames.device)
            return self._finish_part(batch)

    def _finish_part(self, batch: Dispatched) -> PipelineOutput:
        frames, det, placed = batch.frames, batch.det, batch.placed
        b, k = det.valid.shape
        count = batch.count.value()
        bucket = self._round_bucket(count, b * k)
        dev = frames.device
        if bucket == 0:
            return PipelineOutput(
                boxes=det.boxes, scores=det.scores, kps=det.kps,
                valid=det.valid, count=det.count,
                embeddings=torch.zeros((b, k, self.emb_dim),
                                       dtype=torch.float32, device=dev),
                match_idx=torch.full((b, k), -1, dtype=torch.int32,
                                     device=dev),
                match_sim=torch.zeros((b, k), dtype=torch.float32,
                                      device=dev))
        with on_device(dev):
            return embed_and_match_bucketed(
                placed.embedder, frames, det, placed.gallery,
                placed.gallery_valid,
                similarity_thresh=self.similarity_thresh, bucket=bucket)

    def match_names(self, out: PipelineOutput):
        """Host-side: match_idx -> names ('Unknown' below threshold)."""
        idx = out.match_idx.cpu().numpy()
        return [[self.names[j] if j >= 0 else "Unknown" for j in row]
                for row in idx]

    def build_targets_from_images(self, images, names) -> int:
        """Gallery from face photos: the most prominent face of each image
        is detected, embedded and installed. Returns the number installed;
        raises when no image yields a face."""
        embs, kept, skipped = [], [], []
        for img, name in zip(images, names):
            det, kps = self.detector.detect(img, max_num=1)
            if len(det) == 0:
                skipped.append(name)
                continue
            emb = self.embedder(img, kps[0])
            embs.append(emb / max(np.linalg.norm(emb), 1e-12))
            kept.append(name)
        if not embs:
            raise ValueError(
                f"no faces detected in any of the {len(skipped)} target "
                f"images — gallery left unchanged ({skipped[:5]}...)")
        if skipped:
            logging.getLogger(__name__).warning(
                "no face detected in %d/%d target images (skipped: %s)",
                len(skipped), len(skipped) + len(kept), skipped[:10])
        self.set_gallery(np.stack(embs), kept)
        return len(kept)
