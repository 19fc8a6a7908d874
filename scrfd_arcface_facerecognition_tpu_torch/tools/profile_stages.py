"""Device time of each stage and sub-stage of the e2e path, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.profile_stages \
        [--batch 32] [--iters 20] [--bucket 0] [--device cpu]

Port of the JAX repository's ``tools/profile_stages.py``: det_10g +
w600k_r50 seeded at bf16, conf 0.5, IoU 0.4, pre_nms 256, max_det 16,
max_num 10, a 128-row gallery and random u8 1080p frames from
``default_rng(0)`` (``draws``), and the tight letterbox plan
``FacePipeline`` uses (the (384, 640) canvas). It times the two full
stages (detect; embed + match at the bucket the faces give), then each
sub-stage in the order ``FacePipeline`` runs them, each through the
port's own function:

- detect: ``ops.letterbox``, normalize, the SCRFD forward (the NCHW
  permute included), ``detector.decode_outputs``, then top-k + NMS +
  compaction (``ops.stable_top_k``, ``ops.nms_mask_blocked``,
  ``ops.compact_by_mask``, with the frame-pixel scaling and the max_num
  selection the detect stage runs around them), and canvas -> u8;
- embed: ``crop_matrices`` and kernel K1 (``ops.warp_align_crops``,
  ``csrc/warp_align.cu``), the r50 forward, l2 + match.

K1 fuses the ArcFace normalize, BGR -> RGB and the NCHW layout into the
warp, so the "arcface normalize" row says so instead of a time, and the
JAX tool's "pallas warp" row is "warp (K1)". Each row
is the mean of ``--iters`` calls after a warm-up, timed with CUDA events
(``tools.device_ms``); the JAX tool's host clock around many dispatches
served a remote TPU. ``chain`` composes the sub-stages into the
pipeline's output, so the rows split the very call ``FacePipeline``
makes. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional

import numpy as np

from . import card_line, device_ms

SETTINGS = dict(det="det_10g", rec="w600k_r50", conf=0.5, iou=0.4,
                pre_nms=256, max_det=16, max_num=10, gallery=128,
                frame_hw=(1080, 1920), input_size=(640, 640), sim=0.4)
FUSED = "fused in K1"       # the arcface normalize row's entry


def draws(batch: int):
    """The JAX tool's data from ``default_rng(0)``: the (128, 512)
    gallery rows, then (B, 1080, 1920, 3) u8 frames."""
    s = SETTINGS
    rng = np.random.default_rng(0)
    gallery = rng.normal(size=(s["gallery"], 512)).astype(np.float32)
    return gallery, rng.integers(0, 255, size=(batch, *s["frame_hw"], 3),
                                 dtype=np.uint8)


def make_pipeline(device, dtype=None):
    """The JAX tool's pipeline, seeded (seed 0), at ``dtype`` (bf16 by
    default), with its gallery."""
    import torch

    from ..pipeline import FacePipeline

    s = SETTINGS
    pipe = FacePipeline(det_variant=s["det"], rec_variant=s["rec"],
                        conf_thres=s["conf"], iou_thres=s["iou"],
                        max_det=s["max_det"], pre_nms=s["pre_nms"],
                        gallery_capacity=s["gallery"],
                        similarity_thresh=s["sim"],
                        dtype=torch.bfloat16 if dtype is None else dtype,
                        seed=0, device=device)
    gallery, _ = draws(0)
    pipe.set_gallery(gallery, [f"p{i}" for i in range(s["gallery"])])
    return pipe


class SubStages:
    """The e2e path's sub-stages over one plan, each the operations
    ``detect_batch`` / ``embed_and_match_bucketed`` run, in their order."""

    def __init__(self, pipe, plan, max_num: int):
        import torch

        self.pipe, self.plan, self.max_num = pipe, plan, max_num
        self.det = pipe.detector
        self.torch = torch

    def letterbox(self, frames):
        from .. import ops

        return ops.letterbox(frames, self.plan, dtype=self.det.dtype)

    def normalize(self, canvas):
        from .. import ops

        return ops.normalize_image(canvas, ops.SCRFD_MEAN, ops.SCRFD_STD)

    def scrfd(self, net_in):
        return self.det.model(net_in.permute(0, 3, 1, 2).contiguous())

    def decode(self, outputs):
        from ..pipeline.detector import decode_outputs

        return decode_outputs(outputs, self.plan.model_hw)

    def topk_nms(self, scores, boxes, kps):
        """Top-k, NMS, compaction and the max_num selection, boxes and kps
        in frame pixels: ``detector._detect_canvas`` after the decode."""
        from .. import ops
        from ..pipeline.detector import Detections

        torch = self.torch
        b = scores.shape[0]
        inv = 1.0 / self.plan.det_scale
        top_scores, top_idx = ops.stable_top_k(scores, self.pipe.pre_nms)
        top_boxes = torch.gather(boxes, 1,
                                 top_idx[..., None].expand(-1, -1, 4))
        top_kps = torch.gather(
            kps, 1, top_idx[..., None, None].expand(-1, -1, *kps.shape[2:]))
        inv_scale = torch.full((b,), inv, dtype=torch.float32,
                               device=scores.device)
        top_boxes = top_boxes * inv_scale[:, None, None]
        top_kps = top_kps * inv_scale[:, None, None, None]
        valid = top_scores >= self.det.conf_thres
        keep = ops.nms_mask_blocked(top_boxes, self.det.iou_thres, valid)
        det = torch.cat([top_boxes, top_scores[..., None]], dim=-1)
        count, mask, det_c, kps_c = ops.compact_by_mask(
            keep, det, top_kps, max_out=self.pipe.max_det)
        max_num = self.max_num
        if 0 < max_num < self.pipe.max_det:
            frame_hw = torch.empty((b, 2), dtype=torch.int64,
                                   device=scores.device)
            frame_hw[:, 0], frame_hw[:, 1] = self.plan.frame_hw
            det_s, kps_s, mask_s = ops.select_top_faces(
                det_c, kps_c, mask, max_num, "max", frame_hw)
            sel = count > max_num
            det_c = torch.where(sel[:, None, None], det_s,
                                det_c[:, :max_num])
            kps_c = torch.where(sel[:, None, None, None], kps_s,
                                kps_c[:, :max_num])
            mask = torch.where(sel[:, None], mask_s, mask[:, :max_num])
            count = torch.clamp(count, max=max_num)
        return Detections(boxes=det_c[..., :4], scores=det_c[..., 4],
                          kps=kps_c, valid=mask, count=count)

    def canvas_u8(self, canvas):
        return canvas.round().clamp(0, 255).to(self.torch.uint8)

    def warp(self, frames, kps_sel, frame_idx):
        """``crop_matrices`` and K1: (F, 3, 112, 112) ArcFace input."""
        from .. import ops
        from ..pipeline.embedder import crop_matrices

        return ops.warp_align_crops(frames, crop_matrices(kps_sel),
                                    frame_idx)

    def r50(self, crops):
        return self.pipe.embedder.model(crops)

    def match(self, emb, valid_sel):
        """l2 + match: the unit embeddings (zero on invalid slots), the
        best gallery row and its similarity."""
        from .. import ops
        from ..pipeline.face_pipeline import _match_gallery

        emb = ops.l2_normalize(emb) * valid_sel[:, None].to(emb.dtype)
        idx, sim = _match_gallery(emb, self.pipe._gallery,
                                  self.pipe._gallery_valid, valid_sel,
                                  self.pipe.similarity_thresh)
        return emb, idx, sim


def slots(det, bucket: int):
    """Stage 2's inputs for ``bucket`` slots: (sel, frame_idx, kps_sel,
    valid_sel)."""
    from ..pipeline.face_pipeline import bucket_slots

    b, k = det.valid.shape
    sel, frame_idx = bucket_slots(det.valid, bucket)
    return (sel, frame_idx, det.kps.reshape(b * k, 5, 2)[sel],
            det.valid.reshape(-1)[sel])


def chain(sub: SubStages, frames):
    """The sub-stages composed into ``FacePipeline``'s output for
    ``frames``, at the bucket its face count gives."""
    import torch

    from ..pipeline import FacePipeline
    from ..pipeline.face_pipeline import PipelineOutput

    det = sub.topk_nms(*sub.decode(sub.scrfd(sub.normalize(
        sub.letterbox(frames)))))
    b, k = det.valid.shape
    bucket = FacePipeline._round_bucket(int(det.valid.sum()), b * k)
    sel, frame_idx, kps_sel, valid_sel = slots(det, bucket)
    emb_sel, best_idx, best_sim = sub.match(
        sub.r50(sub.warp(frames, kps_sel, frame_idx)), valid_sel)
    emb = torch.zeros((b * k, emb_sel.shape[-1]), dtype=emb_sel.dtype,
                      device=emb_sel.device)
    emb[sel] = emb_sel
    idx = torch.full((b * k,), -1, dtype=torch.int32, device=emb.device)
    idx[sel] = best_idx
    sim = torch.zeros((b * k,), dtype=torch.float32, device=emb.device)
    sim[sel] = best_sim
    return PipelineOutput(det.boxes, det.scores, det.kps, det.valid,
                          det.count, emb.reshape(b, k, -1),
                          idx.reshape(b, k), sim.reshape(b, k))


def run(batch: int = 32, iters: int = 20, bucket: int = 0, device=None,
        pipe=None, emit: Callable[[str], None] = print) -> Dict:
    """The JAX tool's rows for one batch: {"rows": {label: ms, or
    ``FUSED``}, "faces", "bucket", "e2e_ms", "fps"}. ``pipe``
    (from ``make_pipeline``) may be shared between batches."""
    import torch

    from .. import ops
    from ..device import resolve_device
    from ..pipeline import FacePipeline
    from ..pipeline.detector import detect_batch
    from ..pipeline.face_pipeline import embed_and_match_bucketed

    s = SETTINGS
    if pipe is None:
        pipe = make_pipeline(resolve_device(device))
    dev = pipe.device
    frames = torch.from_numpy(draws(batch)[1]).to(dev)
    plan = ops.tight_letterbox_plan(s["frame_hw"], s["input_size"])
    det_m, emb_m = pipe.detector, pipe.embedder
    rows: Dict[str, object] = {}

    def timeit(name, fn, *args):
        out = fn(*args)
        ms = device_ms(lambda: fn(*args), iters, dev)
        rows[name.strip()] = ms
        emit(f"{name:<42s} {ms:8.2f} ms")
        return out, ms

    with torch.inference_mode():
        def detect(f):
            return detect_batch(det_m.model, f, plan=plan,
                                conf_thres=det_m.conf_thres,
                                iou_thres=det_m.iou_thres,
                                pre_nms=pipe.pre_nms, max_det=pipe.max_det,
                                max_num=s["max_num"], metric="max",
                                compute_dtype=det_m.dtype)

        det, t_det = timeit("detect (full stage 1)", detect, frames)
        nfaces = int(det.valid.sum())
        cap = det.valid.shape[0] * det.valid.shape[1]
        bucket = bucket or FacePipeline._round_bucket(nfaces, cap)
        emit(f"  faces={nfaces} bucket={bucket}")
        if bucket == 0:
            raise RuntimeError("profile_stages: the detector found no face, "
                               "so stage 2 has nothing to run")

        def embed_match(f, d):
            return embed_and_match_bucketed(
                emb_m.model, f, d, pipe._gallery, pipe._gallery_valid,
                similarity_thresh=pipe.similarity_thresh, bucket=bucket)

        _, t_em = timeit("embed+match (full stage 2)", embed_match, frames,
                         det)
        e2e = t_det + t_em
        emit(f"  => e2e {e2e:.1f} ms/batch, {batch / e2e * 1e3:.1f} fps")

        sub = SubStages(pipe, plan, s["max_num"])
        canvas, _ = timeit("  letterbox", sub.letterbox, frames)
        net_in, _ = timeit("  normalize", sub.normalize, canvas)
        outputs, _ = timeit("  scrfd forward", sub.scrfd, net_in)
        decoded, _ = timeit("  decode", sub.decode, outputs)
        timeit("  topk+nms+compact", sub.topk_nms, *decoded)
        timeit("  canvas->u8", sub.canvas_u8, canvas)
        _, frame_idx, kps_sel, valid_sel = slots(det, bucket)
        crops, _ = timeit("  warp (K1)", sub.warp, frames, kps_sel,
                          frame_idx)
        rows["arcface normalize"] = FUSED
        emit(f"{'  arcface normalize':<42s} {FUSED}")
        emb, _ = timeit("  r50 forward", sub.r50, crops)
        timeit("  l2+match", sub.match, emb, valid_sel)
    return dict(rows=rows, faces=nfaces, bucket=bucket, e2e_ms=e2e,
                fps=batch / e2e * 1e3)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bucket", type=int, default=0, help="0 = auto")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    print(f"card: {card_line(dev)}")
    run(args.batch, args.iters, args.bucket, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
