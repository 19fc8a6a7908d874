"""Disaggregated two-stage serving: detect slots feed embed slots.

Counterpart of the JAX package's ``parallel/disagg.py``. The pipeline's
stages scale on different axes: detect cost is per FRAME (a fixed
letterboxed conv stack), embed cost is per FACE (a crowded frame costs up
to max_det ArcFace forwards, an empty one none). So the SCRFD weights sit
on one group of slots and the ArcFace weights and the gallery on another,
each group sized for its stage's load (lobby cameras: many frames, few
faces -> more detect slots; turnstile cameras: every frame dense with
faces -> more embed slots). Batches pipeline through both groups: while
batch i embeds on the embed group, batch i+1 detects on the detect group.

The stage handoff copies each batch's detections from the detect slots to
the embed slots (device to device) and its frames from the host to the
embed slots. One process drives both groups, as in the JAX package.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import on_device
from ..pipeline.detector import Detections
from ..pipeline.face_pipeline import CountReadback, Dispatched, Placement
from .data_parallel import Replicas, SourceKey, split_batch
from .mesh import Slot, card_slots, make_mesh
from .sharded_gallery import RowShards


def split_devices(n_det: Optional[int] = None,
                  devices: Optional[Sequence[Slot]] = None):
    """Partition slots (default: the CUDA cards; raises without one) into
    (detect_group, embed_group).

    Default is an even split. Size the detect group up for frame-heavy /
    face-light workloads and the embed group up for dense-face ones.
    """
    devices = list(devices if devices is not None else card_slots())
    if len(devices) < 2:
        raise ValueError("disaggregation needs at least 2 devices")
    if n_det is None:
        n_det = len(devices) // 2
    if not 0 < n_det < len(devices):
        raise ValueError(f"n_det={n_det} must leave both groups non-empty "
                         f"({len(devices)} devices)")
    return devices[:n_det], devices[n_det:]


def _handoff(dets: List[Detections], slots: Sequence[Slot]
             ) -> List[Detections]:
    """The detect slots' detections (frame order across the list) split
    evenly over ``slots``, each part copied to its slot's device: the PP
    boundary."""
    b = sum(d.valid.shape[0] for d in dets)
    per = b // len(slots)
    out = []
    for j, s in enumerate(slots):
        lo, hi = j * per, (j + 1) * per
        pieces, off = [], 0
        for d in dets:
            n = d.valid.shape[0]
            a, z = max(lo, off), min(hi, off + n)
            if a < z:
                pieces.append([t[a - off:z - off] for t in d])
            off += n
        out.append(Detections(*(
            torch.cat([p[f].to(s.device) for p in pieces])
            for f in range(len(Detections._fields)))))
    return out


class DisaggPipeline:
    """A FacePipeline deployed across two groups of slots (detect | embed).

    Wraps an existing :class:`FacePipeline`, with the same numerics and
    the same PipelineOutput, but stage 1 runs data-parallel over
    ``det_devices`` and stage 2 (+ gallery match) over ``emb_devices``;
    the output lands on the embed group's first device.

    >>> det_g, emb_g = split_devices()          # or explicit slot lists
    >>> server = DisaggPipeline(pipe, det_g, emb_g)
    >>> for out in server.process_stream(batches):  # pipelined handoff
    ...     ...
    """

    SHARD_AUTO_BYTES = 64 << 20   # shard past 64 MB (32k rows at 512 f32)

    def __init__(self, pipe, det_devices: Sequence[Slot],
                 emb_devices: Sequence[Slot], axis: str = "data",
                 shard_gallery="auto"):
        # shard_gallery: "auto" | True | False -- row-shard the gallery over
        # the embed group instead of replicating it. Replication caps the
        # deployment at galleries that fit one card beside ArcFace; sharded,
        # each embed slot's faces are matched against every shard and the
        # shards' best rows reduced (RowShards.best), which gives the
        # unsharded argmax.
        overlap = ({s.id for s in det_devices}
                   & {s.id for s in emb_devices})
        if overlap:
            raise ValueError("det/emb device groups overlap — that is the "
                             "co-located DP deployment; use shard_frames")
        if shard_gallery not in ("auto", True, False):
            raise ValueError(f"shard_gallery={shard_gallery!r}")
        self.pipe = pipe
        self.axis = axis
        self.shard_gallery = shard_gallery
        self.det_mesh = make_mesh((len(det_devices),), (axis,),
                                  devices=det_devices)
        self.emb_mesh = make_mesh((len(emb_devices),), (axis,),
                                  devices=emb_devices)
        self._det_slots = self.det_mesh.axis_slots(axis)
        self._emb_slots = self.emb_mesh.axis_slots(axis)
        self._det = Replicas()
        self._emb = Replicas()
        # (what the gallery placement was made from, the placement)
        self._gallery_state = None

    # ------------------------------------------------------------ placement

    def _det_models(self):
        return self._det.on(self.pipe.detector.model,
                            [s.device for s in self._det_slots])

    def _gallery_placed(self):
        """The pipeline's gallery on the embed group: a copy a device, or
        ``RowShards`` over the embed slots. Made again whenever the live
        gallery changes (``SourceKey``)."""
        pipe = self.pipe
        st = self._gallery_state
        if (st is None or not st[0].matches(pipe._gallery)
                or not st[1].matches(pipe._gallery_valid)):
            gallery, valid = pipe._gallery, pipe._gallery_valid
            shard = self.shard_gallery
            if shard == "auto":
                shard = (gallery.numel() * gallery.element_size()
                         > self.SHARD_AUTO_BYTES)
            if shard:
                placed = RowShards.split(gallery, valid, self._emb_slots)
            else:
                placed = {s.device: (gallery.to(s.device, copy=True),
                                     valid.to(s.device, copy=True))
                          for s in self._emb_slots}
            st = (SourceKey(gallery), SourceKey(valid), placed)
            self._gallery_state = st
        return st[2]

    def _emb_placed(self) -> List[Placement]:
        """A placement for each embed slot: the embedder's copy on its
        device and the gallery (a copy, or the shared ``RowShards``)."""
        emb = self._emb.on(self.pipe.embedder.model,
                           [s.device for s in self._emb_slots])
        gal = self._gallery_placed()
        out = []
        for s in self._emb_slots:
            if isinstance(gal, RowShards):
                out.append(Placement(None, emb[s.device], gal, None))
            else:
                out.append(Placement(None, emb[s.device], *gal[s.device]))
        return out

    # -------------------------------------------------------------- serving

    @torch.inference_mode()
    def _dispatch(self, frames, max_num, metric) -> List[Dispatched]:
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        if frames.dim() == 3:
            frames = frames[None]
        b = frames.shape[0]
        for name, slots in (("detect", self._det_slots),
                            ("embed", self._emb_slots)):
            if b % len(slots):
                raise ValueError(
                    f"batch {b} not divisible by the {name} group's "
                    f"{len(slots)} devices")
        models = self._det_models()
        dets = []
        for part, s in zip(split_batch(frames, self._det_slots),
                           self._det_slots):
            with on_device(s.device):
                dets.append(self.pipe._detect(part, max_num, metric,
                                              models[s.device]))
        # stage handoff: frames go host -> embed group; detections
        # detect -> embed group
        f_emb = split_batch(frames, self._emb_slots)
        out = []
        for f, d, s, placed in zip(f_emb, _handoff(dets, self._emb_slots),
                                   self._emb_slots, self._emb_placed()):
            with on_device(s.device):
                out.append(Dispatched(f, d, CountReadback(d.valid.sum()),
                                      placed))
        return out

    def __call__(self, frames, max_num: int = 0, metric: str = "max"):
        return self.pipe._finish(self._dispatch(frames, max_num, metric))

    def process_stream(self, frames_iter, max_num: int = 0,
                       metric: str = "max", depth: int = 2):
        """Pipelined disaggregated serving: yields PipelineOutput per batch.

        With ``depth`` batches in flight, batch i+1's detect is queued on
        the detect group before batch i's face counts are read and its
        embed runs on the embed group, so the two stages overlap across
        the groups (a single batch pays the handoff without the
        overlap)."""
        pending = deque()
        for frames in frames_iter:
            pending.append(self._dispatch(frames, max_num, metric))
            if len(pending) > max(1, depth):
                yield self.pipe._finish(pending.popleft())
        while pending:
            yield self.pipe._finish(pending.popleft())

    def match_names(self, out):
        return self.pipe.match_names(out)
