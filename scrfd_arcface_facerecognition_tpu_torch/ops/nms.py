"""Fixed-shape greedy NMS + face selection.

Candidates arrive as a score-sorted top-K slate with a validity mask; the
outputs are padded to a static size with a count. Every function takes
optional leading batch dimensions, so one call serves a whole frame batch.

Ties are broken the way the JAX reference breaks them (``lax.top_k`` and
stable ``argsort``): lower index first. ``torch.topk`` promises no order
among equal values, so selection uses a stable descending sort instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def stable_top_k(values: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, ties by lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def iou_matrix_legacy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x1y1x2y2 -> (..., K, K) IoU with the reference's +1
    offsets."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = (xx2 - xx1 + 1.0).clamp_min(0.0)
    h = (yy2 - yy1 + 1.0).clamp_min(0.0)
    inter = w * h
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def nms_mask_blocked(boxes: torch.Tensor, iou_thres: float,
                     valid: Optional[torch.Tensor] = None,
                     block: int = 32) -> torch.Tensor:
    """Exact greedy NMS over score-descending boxes (..., K, 4) -> keep
    mask (..., K).

    Invalid slots are never kept and never suppress others. The sequential
    chain runs per block: inside a block the triangular suppression is a
    short loop, then the block's survivors suppress every later candidate
    at once. The result equals plain greedy NMS.
    """
    k_in = boxes.shape[-2]
    batch = boxes.shape[:-2]
    block = min(block, k_in)
    if valid is None:
        valid = torch.ones(batch + (k_in,), dtype=torch.bool,
                           device=boxes.device)
    if k_in % block != 0:
        # pad to a block multiple with never-kept slots
        k = -(-k_in // block) * block
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, k - k_in))
        valid = torch.nn.functional.pad(valid, (0, k - k_in), value=False)
    k = boxes.shape[-2]
    iou = iou_matrix_legacy(boxes)
    over = iou > iou_thres
    idx = torch.arange(block, device=boxes.device)
    tri = idx[:, None] < idx[None, :]
    later_base = torch.arange(k, device=boxes.device)

    keep = valid.clone()
    for start in range(0, k, block):
        stop = start + block
        blk_keep = keep[..., start:stop]
        sup = over[..., start:stop, start:stop] & tri
        for i in range(block):
            blk_keep = blk_keep & ~(sup[..., i, :] & blk_keep[..., i:i + 1])
        keep[..., start:stop] = blk_keep
        # survivors of this block suppress every later candidate at once
        suppressed = (over[..., start:stop, :]
                      & blk_keep[..., :, None]).any(dim=-2)
        keep = keep & ~(suppressed & (later_base >= stop))
    return keep[..., :k_in]


def compact_by_mask(mask: torch.Tensor, *arrays: torch.Tensor,
                    max_out: int) -> Tuple[torch.Tensor, ...]:
    """Stable-compact rows where mask is True to the front of the last
    mask dim, cut to ``max_out``. Returns (count, compacted_mask,
    *compacted_arrays); kept rows keep their order."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    order = order[..., :max_out]
    count = mask.sum(dim=-1, dtype=torch.int32)
    out_mask = torch.gather(mask, -1, order)
    return (count, out_mask) + tuple(_take_rows(a, order) for a in arrays)


def _take_rows(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """a[..., order, ...] along the mask dim, for (..., K, *rest) arrays."""
    rest = a.shape[order.dim():]
    idx = order.reshape(order.shape + (1,) * len(rest)).expand(
        order.shape + rest)
    return torch.gather(a, order.dim() - 1, idx)


def select_top_faces(det: torch.Tensor, kps: torch.Tensor, valid: torch.Tensor,
                     max_num: int, metric: str = "max",
                     frame_hw=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the ``max_num`` best faces by area (metric="max") or
    center-weighted area (metric="default").

    det (..., K, 5) [x1 y1 x2 y2 score]; kps (..., K, 5, 2); valid (..., K)
    -> the (..., max_num, ...) rows of the chosen faces and their mask.
    ``frame_hw`` is one (h, w) or a (..., 2) integer tensor, one per row
    of the leading dims (for metric="default").
    """
    area = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    if metric == "max":
        values = area
    else:
        if frame_hw is None:
            raise ValueError("frame_hw required for metric='default'")
        half = (torch.as_tensor(frame_hw, device=det.device) // 2).to(
            det.dtype)[..., None, :]
        cy, cx = half[..., 0], half[..., 1]
        ox = (det[..., 0] + det[..., 2]) / 2 - cx
        oy = (det[..., 1] + det[..., 3]) / 2 - cy
        values = area - (ox * ox + oy * oy) * 2.0
    values = torch.where(valid, values, torch.full_like(values, -torch.inf))
    _, top_idx = stable_top_k(values, max_num)
    return (_take_rows(det, top_idx), _take_rows(kps, top_idx),
            torch.gather(valid, -1, top_idx))
