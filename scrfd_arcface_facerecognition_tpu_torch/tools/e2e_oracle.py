"""Reference replica of the whole inference path, for the release sign-off.

The port's own copy of the JAX repository's ``tests/e2e_oracle.py``: the
reference's complete path step for step (insightface's SCRFD and ArcFace
wrappers) over an abstract ``forward`` callback (a torch stand-in module,
the port's importer model, or any other independent compute path):

- letterbox: aspect-preserving resize + zero pad;
- the ``blobFromImage`` normalize (BGR -> RGB, NCHW);
- per-stride anchor decode and the score threshold;
- score-sorted greedy NMS with the reference's +1-pixel IoU;
- the ``max_num`` selection by area;
- the 5-point Umeyama alignment and the 112 x 112 warp;
- the ArcFace blob and forward.

``tools/verify_release.py`` holds ``FaceAnalysis`` to this replica.

It stays independent of the code it checks: numpy, and torch only to run
a stand-in module on the CPU in float32. Nothing of the port's ``ops``,
``pipeline`` or ``models`` is imported here. The reference calls cv2 for
two steps. The card's machine has no cv2, so both are numpy functions
here, bit-equal to the cv2 the replica was checked against (5.0, x86-64
with AVX-512):

- ``resize_linear_u8``: ``cv2.resize(INTER_LINEAR)`` on uint8. It takes
  cv2's 11-bit fixed-point weights and its vertical descale. An exact
  2x downscale goes to cv2's INTER_AREA fast path, as cv2 reroutes it.
- ``warp_affine_linear_u8``: ``cv2.warpAffine(INTER_LINEAR)`` on uint8
  with a zero constant border. Before 4.11, cv2 rounded each source
  coordinate to 1/32 pixel (``AB_BITS = 10``) and mixed the taps with
  15-bit weights. Since 4.11 its uint8 warp computes in float32, and that
  is what the installed cv2 does. Columns in whole groups of 16 take the
  vector kernel: the row term ``m1 * y + m2`` rounded once, then FMAs
  for the column term and both lerps. The last ``out_w % 16`` columns
  take the scalar code: ``(m0 * x + m1 * y) + m2`` and lerps, each
  operation rounded. The result is rounded half to even. The sign-off's
  112-pixel crops are seven whole groups and come out bit-equal, as do
  outputs narrower than 16. Where a wider output has a tail, about one
  tail pixel in a million is one step away from cv2: the scalar code
  that cv2 runs there was not pinned down further.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2

# insightface arcface 5-point template
REFERENCE_ALIGNMENT = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)

RESIZE_COEF_BITS = 11               # cv2's INTER_RESIZE_COEF_BITS
WARP_VECTOR_COLUMNS = 16            # cv2's vector warp: columns a step


# ------------------------------------------------------ cv2.resize, uint8


def _resize_taps(dst: int, src: int, horizontal: bool, area: bool = False):
    """cv2's linear taps along one axis: (index0, index1, weight0,
    weight1), the weights in 11-bit fixed point. The fraction is taken in
    float32 from the half-pixel map (``area``: from the cell edges, cv2's
    INTER_AREA when it enlarges); the horizontal taps clamp it at the
    borders, the vertical ones only clip the row index."""
    scale = 1.0 / (dst / src)             # cv2: 1 / inv_scale, in double
    d = np.arange(dst, dtype=np.float64)
    if area:
        sx = np.floor(d * scale).astype(np.int64)
        fx = ((d + 1) - (sx + 1) * (dst / src)).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0),
                      fx - np.floor(fx)).astype(np.float32)
    else:
        fx = ((d + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fx).astype(np.int64)
        fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if horizontal:
        low, high = sx < 0, sx >= src - 1
        fx[low | high] = 0
        sx[low] = 0
        sx[high] = src - 1
    i0 = np.clip(sx, 0, src - 1)
    i1 = np.clip(sx + 1, 0, src - 1)
    one = np.float32(1 << RESIZE_COEF_BITS)
    w0 = np.rint((np.float32(1) - fx) * one).astype(np.int64)
    w1 = np.rint(fx * one).astype(np.int64)
    return i0, i1, w0, w1


def linear_taps_u8(image: np.ndarray, out_hw: Tuple[int, int],
                   area: bool = False) -> np.ndarray:
    """cv2's two-tap fixed-point resize of a uint8 image (its horizontal
    integer sums, then its vector descale ``((((r0 >> 4) * b0) >> 16) +
    (((r1 >> 4) * b1) >> 16) + 2) >> 2``), with the taps of INTER_LINEAR
    or, ``area``, of INTER_AREA enlarging."""
    h, w = image.shape[:2]
    oh, ow = out_hw
    # int32 holds every sum: a row's 255 * 2048, a column's 2^16 * 2048
    x = image.reshape(h, w, -1).astype(np.int32)
    xi0, xi1, xa0, xa1 = _resize_taps(ow, w, True, area)
    yi0, yi1, yb0, yb1 = _resize_taps(oh, h, False, area)
    xa0, xa1, yb0, yb1 = (t.astype(np.int32) for t in (xa0, xa1, yb0, yb1))
    rows = x[:, xi0] * xa0[:, None] + x[:, xi1] * xa1[:, None]
    acc = ((((rows[yi0] >> 4) * yb0[:, None, None]) >> 16)
           + (((rows[yi1] >> 4) * yb1[:, None, None]) >> 16))
    out = (acc + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (oh, ow) + image.shape[2:])


def resize_linear_u8(image: np.ndarray, out_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=INTER_LINEAR)`` on a
    uint8 (H, W) or (H, W, C) image, bit for bit.

    The horizontal pass sums pixel x weight in integers; the vertical pass
    is cv2's vector descale, ``((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) *
    b1) >> 16) + 2) >> 2``. The same size is a copy; an exact 2x
    downscale is the 2 x 2 mean ``(a + b + c + d + 2) >> 2``."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 needs uint8, got {image.dtype}")
    h, w = image.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image.copy()
    if h == 2 * oh and w == 2 * ow:
        x = image.reshape(h, w, -1).astype(np.int64)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8).reshape(
            (oh, ow) + image.shape[2:])
    return linear_taps_u8(image, out_hw)


# -------------------------------------------------- cv2.warpAffine, uint8


_LOW = (1 << 29) - 1        # float64 mantissa bits below float32's
_HALF = 1 << 28
_TINY = float(np.finfo(np.float32).tiny)


def fma_f32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64; the sum is
    split into its float64 rounding and the exact remainder (TwoSum). The
    cast to float32 can only round wrongly when the float64 sum sits
    exactly halfway between two float32 values, and the remainder's sign
    then says which way the exact value lies. Only the sums that may sit
    there (their low 29 mantissa bits ``100...0``, or below float32's
    normal range, where fewer bits remain) go through that fix-up."""
    p = (np.asarray(a, np.float32).astype(np.float64)
         * np.asarray(b, np.float32))
    c = np.asarray(c, np.float32)
    s = p + c
    r = np.asarray(s.astype(np.float32))
    maybe = ((s.view(np.int64) & _LOW) == _HALF) | (np.abs(s) < _TINY)
    if maybe.any():
        pt = np.broadcast_to(p, s.shape)[maybe]
        ct = np.broadcast_to(c, s.shape)[maybe].astype(np.float64)
        st = s[maybe]
        bb = st - pt
        rem = (pt - (st - bb)) + (ct - bb)
        rt = r[maybe]
        up = np.nextafter(rt, np.float32(np.inf))
        down = np.nextafter(rt, np.float32(-np.inf))
        r64 = rt.astype(np.float64)
        rt = np.where((st == (r64 + up.astype(np.float64)) / 2) & (rem > 0),
                      up, rt)
        rt = np.where((st == (r64 + down.astype(np.float64)) / 2)
                      & (rem < 0), down, rt)
        r[maybe] = rt
    return r


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inversion of a 2 x 3 forward map, in double: the six
    coefficients of the destination -> source map."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _warp_columns(src: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                  fused: bool) -> np.ndarray:
    """Bilinear taps at float32 source coordinates, zero outside the
    image: the two horizontal lerps, then the vertical one."""
    h, w = src.shape[:2]
    ix, iy = np.floor(sx), np.floor(sy)
    ax = (sx - ix).astype(np.float32)[..., None]
    ay = (sy - iy).astype(np.float32)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    if fused:
        top = fma_f32(ax, p01 - p00, p00)
        bottom = fma_f32(ax, p11 - p10, p10)
        return fma_f32(ay, bottom - top, top)
    top = p00 + ax * (p01 - p00)
    bottom = p10 + ax * (p11 - p10)
    return top + ay * (bottom - top)


def warp_affine_linear_u8(image: np.ndarray, m: np.ndarray,
                          out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(image, m, (w, h), flags=INTER_LINEAR,
    borderValue=0)`` on a uint8 (H, W) or (H, W, C) image, bit for bit;
    ``m`` maps source to destination, as cv2 takes it."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"warp_affine_linear_u8 needs uint8, got "
                         f"{image.dtype}")
    h, w = image.shape[:2]
    oh, ow = out_hw
    src = image.reshape(h, w, -1).astype(np.float32)
    m32 = invert_affine(m).astype(np.float32)
    x = np.arange(ow, dtype=np.float32)[None, :]
    y = np.arange(oh, dtype=np.float32)[:, None]
    out = np.zeros((oh, ow, src.shape[2]), np.float32)
    v = ow - ow % WARP_VECTOR_COLUMNS
    if v:
        row_x = m32[1] * y + m32[2]
        row_y = m32[4] * y + m32[5]
        xv = x[:, :v]
        out[:, :v] = _warp_columns(src, fma_f32(m32[0], xv, row_x),
                                   fma_f32(m32[3], xv, row_y), fused=True)
    if v < ow:
        xt = x[:, v:]
        sx = (m32[0] * xt + m32[1] * y) + m32[2]
        sy = (m32[3] * xt + m32[4] * y) + m32[5]
        out[:, v:] = _warp_columns(src, sx, sy, fused=False)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(
        (oh, ow) + image.shape[2:])


# ------------------------------------------------------------ the replica


def letterbox(image: np.ndarray, size_hw=(640, 640)):
    """Aspect-preserving resize + zero pad. Returns (canvas u8,
    det_scale)."""
    height, width = size_hw
    im_ratio = float(image.shape[0]) / image.shape[1]
    model_ratio = height / width
    if im_ratio > model_ratio:
        new_height = height
        new_width = int(new_height / im_ratio)
    else:
        new_width = width
        new_height = int(new_width * im_ratio)
    det_scale = float(new_height) / image.shape[0]
    resized = resize_linear_u8(image, (new_height, new_width))
    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    canvas[:new_height, :new_width, :] = resized
    return canvas, det_scale


def center_crop112(image: np.ndarray) -> np.ndarray:
    """The central 112 x 112 of an image, upscaled first (cv2.resize's
    linear default) where a side is shorter."""
    h, w = image.shape[:2]
    if h < 112 or w < 112:
        image = resize_linear_u8(image, (max(112, h), max(112, w)))
        h, w = image.shape[:2]
    y, x = (h - 112) // 2, (w - 112) // 2
    return image[y:y + 112, x:x + 112]


def det_blob(canvas_bgr_u8: np.ndarray) -> np.ndarray:
    """cv2.dnn.blobFromImage for SCRFD: (x - 127.5) / 128, BGR -> RGB,
    HWC -> CHW, a batch of one."""
    x = canvas_bgr_u8[..., ::-1].astype(np.float32)
    return ((x - 127.5) / 128.0).transpose(2, 0, 1)[None]


def rec_blob(crops_bgr_u8: List[np.ndarray]) -> np.ndarray:
    """cv2.dnn.blobFromImages for ArcFace: (x - 127.5) / 127.5, BGR ->
    RGB, NCHW."""
    x = np.stack(crops_bgr_u8)[..., ::-1].astype(np.float32)
    return ((x - 127.5) / 127.5).transpose(0, 3, 1, 2)


def np_distance2bbox(points, distance):
    x1 = points[:, 0] - distance[:, 0]
    y1 = points[:, 1] - distance[:, 1]
    x2 = points[:, 0] + distance[:, 2]
    y2 = points[:, 1] + distance[:, 3]
    return np.stack([x1, y1, x2, y2], axis=-1)


def np_distance2kps(points, distance):
    preds = []
    for i in range(0, distance.shape[1], 2):
        preds.append(points[:, i % 2] + distance[:, i])
        preds.append(points[:, i % 2 + 1] + distance[:, i + 1])
    return np.stack(preds, axis=-1)


def pairwise_iou_legacy(dets: np.ndarray) -> np.ndarray:
    """(N, >=4) boxes -> (N, N) IoU with the reference's +1-pixel offset:
    the convention ``greedy_nms`` applies row by row, and the one the
    sign-off's IoU-gap probe must use."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = (np.maximum(0.0, xx2 - xx1 + 1)
             * np.maximum(0.0, yy2 - yy1 + 1))
    return inter / (areas[:, None] + areas[None, :] - inter)


def greedy_nms(dets: np.ndarray, iou_thres: float) -> List[int]:
    """The reference's O(N^2) +1-offset IoU NMS."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0,
                                                           yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= iou_thres)[0] + 1]
    return keep


def np_umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama least-squares similarity (the SVD form of skimage's
    SimilarityTransform.estimate): the (2, 3) map src -> dst, rotation
    with det +1, scale estimated."""
    src = src.astype(np.float64)
    dst = dst.astype(np.float64)
    n, dim = src.shape
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    a_cov = dc.T @ sc / n
    d = np.ones(dim)
    if np.linalg.det(a_cov) < 0:
        d[dim - 1] = -1
    u, s, vt = np.linalg.svd(a_cov)
    rot = u @ np.diag(d) @ vt
    var_s = sc.var(axis=0).sum()
    scale = (s @ d) / var_s
    t = mu_d - scale * rot @ mu_s
    m = np.zeros((2, 3))
    m[:, :2] = scale * rot
    m[:, 2] = t
    return m


def estimate_norm(landmark: np.ndarray, image_size: int = 112) -> np.ndarray:
    """The similarity that maps five landmarks onto the ArcFace
    template."""
    if landmark.shape != (5, 2):
        raise ValueError(f"landmarks {landmark.shape}, want (5, 2)")
    alignment = (REFERENCE_ALIGNMENT if image_size == 112
                 else REFERENCE_ALIGNMENT * (image_size / 112.0))
    return np_umeyama(landmark.astype(np.float64), alignment)


def norm_crop(image: np.ndarray, landmark: np.ndarray,
              image_size: int = 112) -> np.ndarray:
    return warp_affine_linear_u8(image, estimate_norm(landmark, image_size),
                                 (image_size, image_size))


class OracleStack:
    """The reference pipeline over abstract forward callbacks.

    det_forward(blob (1, 3, H, W) f32) -> list of 9 arrays
        [score x3, bbox x3, kps x3], each (1, H/s * W/s * 2, C).
    rec_forward(blob (N, 3, 112, 112) f32) -> (N, 512).
    """

    def __init__(self, det_forward: Callable, rec_forward: Callable,
                 input_size: Tuple[int, int] = (640, 640),
                 conf_thres: float = 0.5, iou_thres: float = 0.4):
        self.det_forward = det_forward
        self.rec_forward = rec_forward
        self.input_size = input_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        # the raw outputs do not depend on the thresholds, and the
        # sign-off reads each image three times (threshold pick, IoU pick,
        # the comparison); keyed by id(): callers keep the images alive
        self._raw_cache: dict = {}

    def _raw(self, image_bgr: np.ndarray):
        key = id(image_bgr)
        hit = self._raw_cache.get(key)
        if hit is None:
            canvas, det_scale = letterbox(image_bgr, self.input_size)
            outs = [np.asarray(o) for o in self.det_forward(det_blob(canvas))]
            if len(self._raw_cache) >= 64:
                self._raw_cache.clear()
            hit = self._raw_cache[key] = (outs, det_scale)
        return hit

    def raw_outputs(self, image_bgr: np.ndarray) -> List[np.ndarray]:
        return self._raw(image_bgr)[0]

    def candidates(self, image_bgr: np.ndarray) -> np.ndarray:
        """Score-sorted pre-NMS candidates (N, 5) in image coordinates."""
        return self._decode(image_bgr)[0]

    def _decode(self, image_bgr: np.ndarray):
        """Score-sorted pre-NMS (det (N, 5), kps (N, 5, 2)) in image
        coordinates."""
        height, width = self.input_size
        outputs, det_scale = self._raw(image_bgr)
        scores_list, bboxes_list, kpss_list = [], [], []
        for idx, stride in enumerate(STRIDES):
            scores = outputs[idx][0].ravel()
            bbox_preds = outputs[idx + 3][0] * stride
            kps_preds = outputs[idx + 6][0] * stride
            h, w = height // stride, width // stride
            centers = np.stack(
                np.mgrid[:h, :w][::-1], axis=-1).astype(np.float32)
            centers = (centers * stride).reshape(-1, 2)
            centers = np.stack([centers] * NUM_ANCHORS, axis=1).reshape(-1, 2)
            pos = np.where(scores >= self.conf_thres)[0]
            bboxes = np_distance2bbox(centers, bbox_preds)
            kpss = np_distance2kps(centers, kps_preds).reshape(
                len(centers), -1, 2)
            scores_list.append(scores[pos])
            bboxes_list.append(bboxes[pos])
            kpss_list.append(kpss[pos])
        scores = np.concatenate(scores_list)
        order = scores.argsort()[::-1]
        bboxes = np.vstack(bboxes_list) / det_scale
        kpss = np.vstack(kpss_list) / det_scale
        pre_det = np.hstack(
            [bboxes, scores[:, None]]).astype(np.float32)[order]
        return pre_det, kpss[order], det_scale

    def detect(self, image_bgr: np.ndarray, max_num: int = 0,
               metric: str = "max"):
        """(det (N, 5), kps (N, 5, 2)) in image coordinates."""
        pre_det, kpss, _ = self._decode(image_bgr)
        keep = greedy_nms(pre_det, self.iou_thres)
        det = pre_det[keep]
        kpss = kpss[keep]
        if 0 < max_num < det.shape[0]:
            area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            cy, cx = image_bgr.shape[0] // 2, image_bgr.shape[1] // 2
            off = np.vstack([(det[:, 0] + det[:, 2]) / 2 - cx,
                             (det[:, 1] + det[:, 3]) / 2 - cy])
            dist2 = np.sum(off ** 2, axis=0)
            values = area if metric == "max" else area - dist2 * 2.0
            bindex = np.argsort(values)[::-1][:max_num]
            det, kpss = det[bindex], kpss[bindex]
        return det, kpss

    def embed(self, image_bgr: np.ndarray, kps: np.ndarray) -> np.ndarray:
        """The aligned crop's embedding, unnormalized."""
        crop = norm_crop(image_bgr, kps.astype(np.float32))
        return np.asarray(self.rec_forward(rec_blob([crop])))[0]

    def process(self, image_bgr: np.ndarray, max_num: int = 0,
                metric: str = "max"):
        """Detect -> align -> embed, the embeddings L2-normalized.
        Returns (det (N, 5), kps (N, 5, 2), emb (N, 512))."""
        det, kpss = self.detect(image_bgr, max_num=max_num, metric=metric)
        embs = []
        for i in range(len(det)):
            e = self.embed(image_bgr, kpss[i])
            embs.append(e / max(float(np.linalg.norm(e)), 1e-12))
        emb = (np.stack(embs) if embs
               else np.zeros((0, 512), np.float32))
        return det, kpss, emb


def torch_det_forward(model):
    """A torch SCRFD stand-in as a det_forward callback: on the CPU, in
    float32."""
    import torch

    model = model.to("cpu", torch.float32).eval()

    def fwd(blob):
        with torch.no_grad():
            return [t.numpy() for t in model(torch.from_numpy(
                np.ascontiguousarray(blob, np.float32)))]
    return fwd


def torch_rec_forward(model):
    """A torch embedder stand-in as a rec_forward callback: on the CPU,
    in float32."""
    import torch

    model = model.to("cpu", torch.float32).eval()

    def fwd(blob):
        with torch.no_grad():
            return model(torch.from_numpy(
                np.ascontiguousarray(blob, np.float32))).numpy()
    return fwd


def synthetic_frames(n: int, seed: int = 0,
                     sizes: Sequence[Tuple[int, int]] = (
                         (480, 640), (720, 1280), (1080, 1920))
                     ) -> List[np.ndarray]:
    """``n`` seeded BGR uint8 frames, their sizes in turn from ``sizes``:
    smooth content (coarse noise upscaled by ``resize_linear_u8``), so the
    letterbox's resize reads gradients, not pixel noise."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, (max(2, h // 20), max(2, w // 20), 3),
                              dtype=np.uint8)
        frames.append(resize_linear_u8(coarse, (h, w)))
    return frames
