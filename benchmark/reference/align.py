"""The plain reference's embedder stages: the 5-point similarity onto
ArcFace's 112 x 112 template (Umeyama's least squares in closed form), its
inverse, the bilinear warp of cv2.warpAffine (each output pixel samples the
source at M^-1 (x, y, 1), zero outside the frame), the input scaling
(RGB, (x - 127.5) / 127.5) and the embedder, L2-normalised; then the
gallery match (cosine, best row, a threshold). Float32 with TF32 off,
except the match, which is float64.

Imports torch only.
"""
from __future__ import annotations

from typing import Tuple

import torch

# InsightFace's arcface_dst: the five landmarks of an aligned 112 x 112 face
TEMPLATE = ((38.2946, 51.6963), (73.5318, 51.5014), (56.0252, 71.7366),
            (41.5493, 92.3655), (70.7299, 92.2041))


def similarity(src: torch.Tensor) -> torch.Tensor:
    """(F, 5, 2) landmarks -> (F, 2, 3) least-squares similarity onto the
    template: dst ~= [[a, -b], [b, a]] src + t."""
    dst = torch.tensor(TEMPLATE, dtype=src.dtype, device=src.device)
    ms, md = src.mean(1, keepdim=True), dst.mean(0, keepdim=True)
    sc, dc = src - ms, dst - md
    var = (sc ** 2).sum((1, 2)).clamp_min(1e-12)
    a = (sc * dc).sum((1, 2)) / var
    b = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(1) / var
    tx = md[0, 0] - (a * ms[:, 0, 0] - b * ms[:, 0, 1])
    ty = md[0, 1] - (b * ms[:, 0, 0] + a * ms[:, 0, 1])
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)


def inverse(m: torch.Tensor) -> torch.Tensor:
    lin = m[..., :2]
    inv = torch.linalg.inv(lin)
    t = -(inv @ m[..., 2:])
    return torch.cat([inv, t], -1)


def warp(frames: torch.Tensor, minv: torch.Tensor, frame_idx: torch.Tensor,
         out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """(B, H, W, 3) u8 frames, (F, 2, 3) dst -> src, (F,) -> (F, h, w, 3)
    float32 bilinear samples, zero outside the frame."""
    _, h, w, _ = frames.shape
    oh, ow = out_hw
    gy, gx = torch.meshgrid(torch.arange(oh, device=frames.device,
                                         dtype=torch.float32),
                            torch.arange(ow, device=frames.device,
                                         dtype=torch.float32), indexing="ij")
    sx = minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy \
        + minv[:, 0, 2, None, None]
    sy = minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy \
        + minv[:, 1, 2, None, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    out = torch.zeros((*sx.shape, 3), device=frames.device)
    fi = frame_idx.long()[:, None, None]
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xt, yt = x0 + dx, y0 + dy
            inside = (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (yt <= h - 1)
            xi = torch.where(inside, xt, 0).long()
            yi = torch.where(inside, yt, 0).long()
            px = frames[fi.expand_as(xi), yi, xi].float()
            out += px * (wx * wy * inside)[..., None]
    return out


def net_input(frames: torch.Tensor, kps: torch.Tensor,
              frame_idx: torch.Tensor) -> torch.Tensor:
    """(F, 5, 2) landmarks in frames[frame_idx] -> (F, 3, 112, 112) the
    embedder's input: the aligned crops, RGB, scaled."""
    minv = inverse(similarity(kps.float()))
    crops = warp(frames, minv, frame_idx)
    x = (crops.flip(-1) - 127.5) / 127.5
    return x.permute(0, 3, 1, 2).contiguous()


def embed(model, frames: torch.Tensor, kps: torch.Tensor,
          frame_idx: torch.Tensor) -> torch.Tensor:
    """(F, 5, 2) landmarks in frames[frame_idx] -> (F, D) unit
    embeddings."""
    e = model(net_input(frames, kps, frame_idx))
    return torch.nn.functional.normalize(e, dim=1)


def match(emb: torch.Tensor, gallery: torch.Tensor, thresh: float):
    """float64 cosines of (F, D) embeddings against (G, D) rows: the best
    row, its similarity, every similarity (F, G)."""
    g = torch.nn.functional.normalize(gallery.double(), dim=1)
    sims = emb.double() @ g.T
    best, idx = sims.max(1)
    return torch.where(best > thresh, idx, -1), best, sims
