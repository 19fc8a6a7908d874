"""Detection training data and evaluation: WIDER / retinaface annotations,
static-shape batching and VOC-style AP.

Host numpy, as in the JAX package, so the arrays equal its own: read the
retinaface ``label.txt`` format (the annotation file distributed with
WIDER FACE: ``# <image path>`` lines, each followed by one face a line,
``x1 y1 w h [lm0x lm0y v0 ... lm4x lm4y v4 blur]``), letterbox each image
to the training resolution with the ground truth moved alongside, pad to
``max_gt`` with validity masks, and score detections with AP@0.5.

Images are read by ``image_loader`` (a function ``path -> BGR u8 array or
None``); without one, by ``read_image``: cv2 where it is installed,
otherwise a clear error naming the argument. An image the loader cannot
read (None) is left out, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.resize import _interp_matrix, letterbox_plan


def read_image(path: str) -> Optional[np.ndarray]:
    """A BGR u8 image from ``path`` (cv2), or None where it is not one."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            "reading images needs cv2, which is not installed here; pass "
            "image_loader= (a function path -> BGR u8 array)") from None
    return cv2.imread(path)


def _loader(image_loader: Optional[Callable]) -> Callable:
    return read_image if image_loader is None else image_loader


@dataclasses.dataclass
class Annotation:
    path: str
    boxes: np.ndarray      # (N, 4) x1y1x2y2 pixels
    kps: np.ndarray        # (N, 5, 2) pixels; NaN where unlabeled
    kps_valid: np.ndarray  # (N,) bool: all 5 landmarks labeled


def parse_wider_annotations(label_path: str,
                            images_root: Optional[str] = None
                            ) -> List[Annotation]:
    """Parse the retinaface label.txt format into Annotation records."""
    images_root = images_root or os.path.dirname(os.path.abspath(label_path))
    anns: List[Annotation] = []
    path = None
    boxes: List[List[float]] = []
    kps: List[np.ndarray] = []

    def flush():
        if path is None:
            return
        n = len(boxes)
        b = (np.asarray(boxes, np.float32).reshape(n, 4)
             if n else np.zeros((0, 4), np.float32))
        k = (np.stack(kps) if n else np.zeros((0, 5, 2), np.float32))
        valid = ~np.isnan(k).any(axis=(1, 2)) if n else np.zeros((0,), bool)
        anns.append(Annotation(path=os.path.join(images_root, path),
                               boxes=b, kps=k, kps_valid=valid))

    with open(label_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                flush()
                path = line[1:].strip()
                boxes, kps = [], []
                continue
            vals = [float(v) for v in line.split()]
            x1, y1, w, h = vals[:4]
            boxes.append([x1, y1, x1 + w, y1 + h])
            pts = np.full((5, 2), np.nan, np.float32)
            if len(vals) >= 19:
                lm = np.asarray(vals[4:19], np.float32).reshape(5, 3)
                labeled = lm[:, 2] >= 0          # flag -1: unlabeled
                pts[labeled] = lm[labeled, :2]
            kps.append(pts)
    flush()
    return anns


def letterbox_example(image: np.ndarray, ann: Annotation,
                      input_size: Tuple[int, int] = (640, 640),
                      max_gt: int = 32):
    """One training example: the letterboxed image and its ground truth,
    moved and padded.

    Returns (canvas (H, W, 3) f32, gt_boxes, gt_kps, gt_valid,
    gt_kps_valid): faces with unlabeled landmarks (``kps_valid`` False)
    keep their box but leave the landmark loss (``scrfd_loss``
    ``gt_kps_valid``). The letterbox runs on the host (numpy products with
    cv2's interpolation matrices): a dataset has thousands of image
    shapes.
    """
    h, w = image.shape[:2]
    plan = letterbox_plan((h, w), input_size)
    nh, nw = plan.new_hw
    x = image.astype(np.float32)
    # an axis kept at its size has the identity as its matrix, and its
    # product is the image itself (+ 0.0) when every value is finite
    same = np.isfinite(x).all()
    x = (x + np.float32(0) if same and nh == h else
         np.einsum("oh,hwc->owc", _interp_matrix(nh, h), x))
    x = (x + np.float32(0) if same and nw == w else
         np.einsum("pw,owc->opc", _interp_matrix(nw, w), x))
    canvas = np.zeros((*input_size, image.shape[2]), np.float32)
    canvas[:nh, :nw] = x
    s = plan.det_scale
    n = min(len(ann.boxes), max_gt)
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_kps = np.zeros((max_gt, 5, 2), np.float32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_kps_valid = np.zeros((max_gt,), bool)
    gt_boxes[:n] = ann.boxes[:n] * s
    gt_kps[:n] = np.nan_to_num(ann.kps[:n], nan=0.0) * s
    gt_valid[:n] = True
    gt_kps_valid[:n] = ann.kps_valid[:n]
    return canvas, gt_boxes, gt_kps, gt_valid, gt_kps_valid


def batches_from_annotations(anns: Sequence[Annotation], batch: int,
                             input_size: Tuple[int, int] = (640, 640),
                             max_gt: int = 32, seed: int = 0,
                             image_loader: Optional[Callable] = None,
                             normalize: bool = True) -> Iterator[Tuple]:
    """ONE shuffled pass of (images, gt_boxes, gt_kps, gt_valid,
    gt_kps_valid) numpy batches (callers loop for epochs, reseeding the
    shuffle).

    images are (B, H, W, 3) f32, SCRFD-normalized by default ((x - 127.5)
    / 128, BGR -> RGB); ``SCRFDTrainer.train_step`` takes them transposed
    to NCHW. The last partial batch is padded with empty images (gt_valid
    all False), so every batch has the same shape and no data is dropped.
    """
    image_loader = _loader(image_loader)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(anns))
    bufs = ([], [], [], [], [])

    def emit(bufs):
        while len(bufs[0]) < batch:   # pad the tail: empty image, no gt
            bufs[0].append(np.zeros_like(bufs[0][0]))
            for b, proto in zip(bufs[1:], (np.zeros((max_gt, 4), np.float32),
                                           np.zeros((max_gt, 5, 2),
                                                    np.float32),
                                           np.zeros((max_gt,), bool),
                                           np.zeros((max_gt,), bool))):
                b.append(proto)
        images = np.stack(bufs[0])
        if normalize:
            images = (images[..., ::-1] - 127.5) / 128.0
        return (images.astype(np.float32),) + tuple(
            np.stack(b) for b in bufs[1:])

    for idx in order:
        ann = anns[idx]
        img = image_loader(ann.path)
        if img is None:
            continue
        for buf, val in zip(bufs, letterbox_example(img, ann, input_size,
                                                    max_gt)):
            buf.append(val)
        if len(bufs[0]) == batch:
            yield emit(bufs)
            bufs = ([], [], [], [], [])
    if bufs[0]:
        yield emit(bufs)


# --------------------------------------------------------------------------
# evaluation: VOC-style AP@IoU
# --------------------------------------------------------------------------

def average_precision(pred_boxes: Sequence[np.ndarray],
                      pred_scores: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      iou_thresh: float = 0.5) -> float:
    """AP over a dataset: per-image predictions ((Ni, 4), (Ni,)) against
    the ground truth.

    Greedy matching (each face claims at most one detection, score
    descending), continuous-interpolation AP (the area under the precision
    envelope).
    """
    records = []   # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        n_gt += len(gb)
        if len(pb) == 0:
            continue
        order = np.argsort(-np.asarray(ps))
        taken = np.zeros(len(gb), bool)
        for i in order:
            if len(gb) == 0:
                records.append((ps[i], False))
                continue
            x1 = np.maximum(pb[i, 0], gb[:, 0])
            y1 = np.maximum(pb[i, 1], gb[:, 1])
            x2 = np.minimum(pb[i, 2], gb[:, 2])
            y2 = np.minimum(pb[i, 3], gb[:, 3])
            inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
            a1 = (pb[i, 2] - pb[i, 0]) * (pb[i, 3] - pb[i, 1])
            a2 = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
            iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
            iou = np.where(taken, -1.0, iou)
            j = int(np.argmax(iou))
            if iou[j] >= iou_thresh:
                taken[j] = True
                records.append((ps[i], True))
            else:
                records.append((ps[i], False))
    if n_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([not r[1] for r in records])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # the precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(np.diff(np.concatenate([[0.0], recall])) > 0)[0]
    return float(np.sum(precision[idx]
                        * np.diff(np.concatenate([[0.0], recall]))[idx]))


def evaluate_detector(detector, anns: Sequence[Annotation],
                      image_loader: Optional[Callable] = None,
                      iou_thresh: float = 0.5,
                      conf_thres: float = 0.02) -> Dict[str, float]:
    """Run a ``Detector`` over annotated images and report AP@iou, with its
    ``conf_thres`` set to ``conf_thres`` for the run and restored after."""
    image_loader = _loader(image_loader)
    pbs, pss, gbs = [], [], []
    old = detector.conf_thres
    detector.conf_thres = conf_thres
    try:
        for ann in anns:
            img = image_loader(ann.path)
            if img is None:
                continue
            det, _ = detector.detect(img)
            pbs.append(det[:, :4])
            pss.append(det[:, 4])
            gbs.append(ann.boxes)
    finally:
        detector.conf_thres = old
    return {"ap": average_precision(pbs, pss, gbs, iou_thresh),
            "images": len(pbs)}
