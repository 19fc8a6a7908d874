"""The plain reference's detector stages: letterbox, decode, top-K, NMS and
the selection of faces, in float32 (TF32 off), written from their public
definitions.

- Letterbox: cv2.resize(INTER_LINEAR) sampling at half-pixel centres with
  the edge clamped, the aspect kept, the content at the top-left of a zero
  canvas whose pad band is trimmed to a multiple of 64 (at least 64 x 512,
  at most the detector's input), as the serving path's tight canvas.
- SCRFD heads: anchor centres (col * s, row * s), two a location, row-major
  (index (row * W + col) * 2 + a); boxes are centre -/+ distance * stride,
  keypoints centre + offset * stride.
- Selection (InsightFace's ``SCRFD.detect``): the ``pre_nms`` best scores
  (a stable sort: ties keep the lower anchor first), those at or above
  ``conf``, greedy NMS with the +1 pixel IoU above ``iou``, at most
  ``max_det`` kept in score order, then (only when more than ``max_num``
  survive) the ``max_num`` largest boxes. A bias (``tier``, ``band``)
  lets the comparison ask which near-tied choices a kept set took.

Imports torch only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

STRIDES = (8, 16, 32)
ANCHORS = 2


def letterbox_plan(frame_hw: Tuple[int, int], det_size: Tuple[int, int],
                   multiple: int = 64, min_hw=(64, 512)):
    """(canvas (h, w), resized content (h, w), det_scale)."""
    fh, fw = frame_hw
    mh, mw = det_size
    if fh / fw > mh / mw:
        nh, nw = mh, int(mh / (fh / fw))
    else:
        nw, nh = mw, int(mw * (fh / fw))
    ch = min(mh, max(min_hw[0], -(-nh // multiple) * multiple))
    cw = min(mw, max(min_hw[1], -(-nw // multiple) * multiple))
    return (ch, cw), (nh, nw), nh / fh


def interp_matrix(dst: int, src: int, device) -> torch.Tensor:
    """(dst, src) bilinear weights, half-pixel centres, edges clamped."""
    d = torch.arange(dst, dtype=torch.float64, device=device)
    s = (d + 0.5) * (src / dst) - 0.5
    x0 = torch.floor(s)
    frac = s - x0
    w = torch.zeros((dst, src), dtype=torch.float64, device=device)
    rows = torch.arange(dst, device=device)
    i0 = x0.long().clamp(0, src - 1)
    i1 = (x0.long() + 1).clamp(0, src - 1)
    w.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    w.index_put_((rows, i1), frac, accumulate=True)
    return w.float()


def letterbox(frames: torch.Tensor, det_size) -> Tuple[torch.Tensor, float]:
    """(B, H, W, 3) u8 BGR -> (B, 3, h, w) float32 network input (RGB,
    (x - 127.5) / 128) and det_scale."""
    b, fh, fw, _ = frames.shape
    (ch, cw), (nh, nw), scale = letterbox_plan((fh, fw), det_size)
    wy = interp_matrix(nh, fh, frames.device)
    wx = interp_matrix(nw, fw, frames.device)
    x = frames.permute(0, 3, 1, 2).float()                   # (B, 3, H, W)
    x = torch.matmul(torch.matmul(wy, x), wx.T)              # (B, 3, nh, nw)
    canvas = torch.zeros((b, 3, ch, cw), device=frames.device)
    canvas[:, :, :nh, :nw] = x
    return (canvas.flip(1) - 127.5) / 128.0, scale


def anchor_centers(h: int, w: int, device) -> torch.Tensor:
    """(N, 2) x, y centres of every stride, stride 8 first."""
    out = []
    for s in STRIDES:
        ys, xs = torch.meshgrid(torch.arange(h // s, device=device),
                                torch.arange(w // s, device=device),
                                indexing="ij")
        c = torch.stack([xs, ys], -1).reshape(-1, 2).float() * s
        out.append(c.repeat_interleave(ANCHORS, 0))
    return torch.cat(out)


def heads(model, net_in: torch.Tensor,
          scale: float) -> Dict[str, torch.Tensor]:
    """Every anchor's score (B, N), box (B, N, 4) and keypoints (B, N, 5,
    2) in frame pixels."""
    out = model(net_in)
    h, w = net_in.shape[2:]
    centers = anchor_centers(h, w, net_in.device)
    strides = torch.cat([torch.full((o.shape[1],), float(s),
                                    device=net_in.device)
                         for s, o in zip(STRIDES, out[:3])])
    score = torch.cat([o[..., 0] for o in out[:3]], 1)
    dist = torch.cat(out[3:6], 1) * strides[:, None]
    off = torch.cat(out[6:9], 1) * strides[:, None]
    box = torch.cat([centers - dist[..., :2], centers + dist[..., 2:]], -1)
    kps = centers[:, None, :] + off.reshape(*off.shape[:2], 5, 2)
    return {"score": score, "box": box / scale, "kps": kps / scale}


def iou_plus1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x (..., L, 4) -> (..., K, L) IoU with +1 pixel sizes."""
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def select(hd: Dict[str, torch.Tensor], *, conf: float, iou: float,
           pre_nms: int, max_det: int, max_num: int,
           tier: torch.Tensor = None,
           band: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per frame: the kept anchors (B, n) (-1 past the count), the count,
    and the slate's cut (its lowest score).

    ``tier`` (B, N), each anchor -1, 0 or 1, and ``band`` bias every
    decision by ``band`` toward the higher tier: an anchor's score is
    raised by ``tier * band``, its area scaled by ``1 + tier * band``, and
    it is suppressed only past an IoU of ``iou + tier * band``. Without a
    tier, or at band 0, this is the plain selection."""
    score = hd["score"]
    dev = score.device
    t = (torch.zeros_like(score) if tier is None
         else tier.to(score.dtype)) * band
    top_s, top_i = torch.sort(score + t, dim=1, descending=True,
                              stable=True)
    top_s, top_i = top_s[:, :pre_nms], top_i[:, :pre_nms]
    top_t = torch.gather(t, 1, top_i)
    boxes = torch.gather(hd["box"], 1, top_i[..., None].expand(-1, -1, 4))
    over = iou_plus1(boxes, boxes) > (iou + top_t)[:, None, :]
    keep = top_s >= conf
    later = torch.arange(pre_nms, device=dev)
    for i in range(pre_nms):          # greedy, in score order
        keep = keep & ~(over[:, i] & keep[:, i:i + 1] & (later > i))
    keep = keep & (keep.cumsum(1) <= max_det)
    count = keep.sum(1)
    n_out = min(max_num, max_det) if max_num > 0 else max_det
    # survivors first, in score order; with more than max_num of them, the
    # max_num largest (equal areas keep score order)
    order = torch.sort(keep.to(torch.int8), dim=1, descending=True,
                       stable=True).indices
    if max_num > 0:
        area = ((boxes[..., 2] - boxes[..., 0])
                * (boxes[..., 3] - boxes[..., 1]) * (1 + top_t))
        by_area = torch.sort(torch.where(keep, area, -torch.inf), dim=1,
                             descending=True, stable=True).indices
        order = torch.where((count > max_num)[:, None], by_area, order)
    count = count.clamp(max=n_out)
    kept = torch.gather(top_i, 1, order[:, :n_out])
    kept = torch.where(torch.arange(n_out, device=dev) < count[:, None],
                       kept, -1)
    return {"kept": kept, "count": count, "cut": top_s[:, -1]}
