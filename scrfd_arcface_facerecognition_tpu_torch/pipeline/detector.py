"""SCRFD detection: letterbox -> forward -> decode -> top-K -> NMS.

Fixed shapes as in the JAX package: candidates are a top-K score slate
(a stable sort, so tied scores keep the lower anchor first, as
``lax.top_k`` does), NMS is the blocked greedy mask of ``ops/nms.py``,
and results are padded to ``max_det`` with a validity mask. Coordinates
are in original-frame pixels.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..models.init_utils import seeded_init_
from ..models.scrfd import SCRFD_CONFIGS, SCRFDConfig, SCRFDNet
from ..models.weights import load_flax_variables
from ..stages import stage


class Detections(NamedTuple):
    """Padded detections of a frame batch.

    boxes (B, max_det, 4) x1y1x2y2 in frame pixels; scores (B, max_det);
    kps (B, max_det, 5, 2); valid (B, max_det) bool; count (B,) int32.
    """
    boxes: torch.Tensor
    scores: torch.Tensor
    kps: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def as_frames(frames, device: torch.device) -> torch.Tensor:
    """numpy or tensor (B, H, W, 3) / (H, W, 3) u8 -> (B, H, W, 3) u8 on
    ``device``."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    if frames.dim() == 3:
        frames = frames[None]
    return frames.to(device).contiguous()


def decode_outputs(outputs: Dict[str, List[torch.Tensor]],
                   input_size: Tuple[int, int],
                   strides=ops.anchors.SCRFD_STRIDES
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-stride head outputs -> (B, N) scores, (B, N, 4) boxes,
    (B, N, 5, 2) kps in letterboxed-input pixels, stride-8 first."""
    h, w = input_size
    all_scores, all_boxes, all_kps = [], [], []
    for li, s in enumerate(strides):
        centers = ops.anchor_centers(h // s, w // s, s,
                                     device=outputs["scores"][li].device)
        all_scores.append(outputs["scores"][li][..., 0])
        all_boxes.append(ops.distance2bbox(centers, outputs["bboxes"][li] * s))
        all_kps.append(ops.distance2kps(centers, outputs["kps"][li] * s))
    return (torch.cat(all_scores, dim=1), torch.cat(all_boxes, dim=1),
            torch.cat(all_kps, dim=1))


def detect_batch(model: SCRFDNet, frames: torch.Tensor, *,
                 plan: ops.LetterboxPlan, conf_thres: float, iou_thres: float,
                 pre_nms: int, max_det: int, max_num: int = 0,
                 metric: str = "max") -> Detections:
    """Full detect over (B, H, W, 3) uint8 BGR frames."""
    with stage("letterbox"):
        canvas = ops.letterbox(frames, plan)
    with stage("scrfd"):
        net_in = ops.normalize_image(canvas, ops.SCRFD_MEAN, ops.SCRFD_STD)
        outputs = model(net_in.permute(0, 3, 1, 2).contiguous())
    with stage("decode_nms"):
        scores, boxes, kps = decode_outputs(outputs, plan.model_hw)
        top_scores, top_idx = ops.stable_top_k(scores, pre_nms)   # (B, K)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        top_kps = torch.gather(
            kps, 1, top_idx[..., None, None].expand(-1, -1, *kps.shape[2:]))
        inv_scale = 1.0 / plan.det_scale
        top_boxes = top_boxes * inv_scale
        top_kps = top_kps * inv_scale
        valid = top_scores >= conf_thres

        keep = ops.nms_mask_blocked(top_boxes, iou_thres, valid)
        det = torch.cat([top_boxes, top_scores[..., None]], dim=-1)
        count, mask, det_c, kps_c = ops.compact_by_mask(
            keep, det, top_kps, max_out=max_det)
        if 0 < max_num < max_det:
            det_s, kps_s, mask_s = ops.select_top_faces(
                det_c, kps_c, mask, max_num, metric, plan.frame_hw)
            # the reference selects (and reorders by area) only when MORE
            # than max_num faces survive NMS; otherwise score order stays
            sel = count > max_num
            det_c = torch.where(sel[:, None, None], det_s, det_c[:, :max_num])
            kps_c = torch.where(sel[:, None, None, None], kps_s,
                                kps_c[:, :max_num])
            mask = torch.where(sel[:, None], mask_s, mask[:, :max_num])
            count = torch.clamp(count, max=max_num)
    return Detections(boxes=det_c[..., :4], scores=det_c[..., 4], kps=kps_c,
                      valid=mask, count=count)


class Detector:
    """User-facing SCRFD detector.

    >>> det = Detector("det_10g", conf_thres=0.5, iou_thres=0.4)
    >>> boxes, kps = det.detect(frame_bgr_u8, max_num=0)

    ``variables`` is a Flax tree of numpy arrays (``{"params",
    "batch_stats"}``, see ``models/weights.py``); without it the weights
    are the seeded init. The model lives on ``device``: the CUDA card
    unless ``device="cpu"`` is passed.
    """

    def __init__(self, variant: str = "det_10g",
                 variables: Optional[Any] = None,
                 input_size: Tuple[int, int] = (640, 640),
                 conf_thres: float = 0.5, iou_thres: float = 0.4,
                 pre_nms: int = 256, max_det: int = 64, seed: int = 0,
                 tight_canvas: bool = False,
                 config: Optional[SCRFDConfig] = None, device=None):
        self.device = resolve_device(device)
        if config is None:
            if variant not in SCRFD_CONFIGS:
                raise ValueError(f"unknown SCRFD variant {variant!r}")
            config = SCRFD_CONFIGS[variant]
        self.variant = config.name
        self.input_size = (input_size[1], input_size[0])  # stored as (h, w)
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.pre_nms = pre_nms
        self.max_det = max_det
        # False: the square canvas of the single-image reference API;
        # FacePipeline trims the pad band instead
        self.tight_canvas = tight_canvas
        model = SCRFDNet(config)
        if variables is None:
            seeded_init_(model, seed)
        else:
            load_flax_variables(model, variables)
        self.model = model.eval().requires_grad_(False).to(self.device)

    def plan(self, frame_hw: Tuple[int, int],
             tight: Optional[bool] = None) -> ops.LetterboxPlan:
        tight = self.tight_canvas if tight is None else tight
        return (ops.tight_letterbox_plan(frame_hw, self.input_size) if tight
                else ops.letterbox_plan(frame_hw, self.input_size))

    @torch.inference_mode()
    def detect_batched(self, frames, max_num: int = 0,
                       metric: str = "max") -> Detections:
        """(B, H, W, 3) uint8 BGR -> padded Detections on the device."""
        frames = as_frames(frames, self.device)
        return detect_batch(
            self.model, frames, plan=self.plan(tuple(frames.shape[1:3])),
            conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            pre_nms=self.pre_nms, max_det=self.max_det, max_num=max_num,
            metric=metric)

    def detect(self, image, max_num: int = 0, metric: str = "max"):
        """Single image -> (det[N, 5], kps[N, 5, 2]) numpy, N surviving
        faces (the reference's return convention)."""
        d = self.detect_batched(np.asarray(image)[None], max_num=max_num,
                                metric=metric)
        n = int(d.count[0])
        det = torch.cat([d.boxes[0, :n], d.scores[0, :n, None]], dim=1)
        return det.cpu().numpy(), d.kps[0, :n].cpu().numpy()
