"""SCRFD detector family (det_500m / det_2.5g / det_10g) in PyTorch.

The I/O contract of the released detectors holds: 3 FPN strides (8, 16,
32), 2 anchors per location, keypoints on; outputs ordered [score x3,
bbox x3, kps x3] with shapes (B, H/s * W/s * 2, {1, 4, 10}), scores after
the sigmoid, bbox/kps in stride units.

The net takes NCHW input and keeps NCHW inside; the head permutes each
output to NHWC before flattening, so the flattened anchor order is the
row-major grid x 2 anchors that ``ops/anchors.py`` lays out. Submodule
names follow the JAX package's Flax names so the weights module maps one
tree onto the other path for path. Only the plain 3x3 stride-2 stem is
built: the space-to-depth stem is a TPU layout trick, and
``s2d_kernel_to_stem`` turns such a stem kernel back into the plain one.

``dtype`` is the compute dtype (``layers.set_compute_dtype``); parameters
stay float32 and the head's three outputs are float32 in either dtype, as
the JAX head casts them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .layers import (Conv2d, ConvBN, GroupNorm, RoundedWeights,
                     at_least_f32, set_compute_dtype)


@dataclasses.dataclass(frozen=True)
class SCRFDConfig:
    name: str
    stem_filters: int
    stage_blocks: Sequence[int]
    stage_filters: Sequence[int]
    neck_filters: int
    head_stacks: int
    head_filters: int
    strides: Sequence[int] = (8, 16, 32)
    num_anchors: int = 2
    num_kps: int = 5
    gn_groups: int = 16


SCRFD_CONFIGS = {
    "det_500m": SCRFDConfig("det_500m", 16, (3, 3, 2, 2), (16, 16, 40, 72),
                            neck_filters=24, head_stacks=3, head_filters=96),
    "det_2.5g": SCRFDConfig("det_2.5g", 24, (3, 4, 2, 3), (24, 48, 48, 80),
                            neck_filters=24, head_stacks=2, head_filters=64),
    "det_10g": SCRFDConfig("det_10g", 56, (3, 5, 2, 3), (56, 56, 144, 248),
                           neck_filters=56, head_stacks=3, head_filters=80),
}


def s2d_kernel_to_stem(w: np.ndarray) -> np.ndarray:
    """(2, 2, 12, C) space-to-depth stem kernel (HWIO) -> plain (3, 3, 3, C).

    Exact inverse of the JAX package's ``stem_kernel_to_s2d`` scatter.
    Raises if any of the 21 slots outside the scatter's image carries
    weight: such a kernel has no 3x3 equivalent.
    """
    w = np.asarray(w)
    c_out = w.shape[-1]
    out = np.zeros((3, 3, 3, c_out), w.dtype)
    used = np.zeros(w.shape[:3], bool)
    for ky in range(3):
        dby, dsy = divmod(ky - 1, 2)
        for kx in range(3):
            dbx, dsx = divmod(kx - 1, 2)
            for c in range(3):
                out[ky, kx, c] = w[dby + 1, dbx + 1, dsy * 6 + dsx * 3 + c]
                used[dby + 1, dbx + 1, dsy * 6 + dsx * 3 + c] = True
    resid = float(np.abs(w[~used]).max()) if (~used).any() else 0.0
    if resid > 1e-7 * max(1.0, float(np.abs(w).max())):
        raise ValueError(
            "s2d stem kernel carries weight outside the 3x3 scatter image "
            f"(max |tap| {resid:.3e}): it has no exact plain-stem equivalent")
    return out


class ResBlock(nn.Module):
    """Basic residual block with ReLU; ResNetV1e downsample (avg-pool, then
    a 1x1 conv)."""

    def __init__(self, in_ch: int, filters: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvBN(in_ch, filters, 3, stride=stride, padding=1,
                            act="relu")
        self.conv2 = ConvBN(filters, filters, 3, padding=1)
        self.down = (ConvBN(in_ch, filters, 1, padding=0)
                     if stride != 1 or in_ch != filters else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        identity = x
        if self.down is not None:
            if self.stride != 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.down(identity)
        return F.relu(out + identity)


class Backbone(nn.Module):
    """ResNetV1e: deep stem of three 3x3 convs (first stride 2), a 3x3/2
    max-pool, then 4 stages; returns the stride-8/16/32 maps."""

    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        half = cfg.stem_filters // 2
        self.stem1 = ConvBN(3, half, 3, stride=2, padding=1, act="relu")
        self.stem2 = ConvBN(half, half, 3, padding=1, act="relu")
        self.stem3 = ConvBN(half, cfg.stem_filters, 3, padding=1, act="relu")
        self.stages: List[List[str]] = []
        ch = cfg.stem_filters
        for si, (nblocks, filters) in enumerate(zip(cfg.stage_blocks,
                                                    cfg.stage_filters)):
            names = []
            for bi in range(nblocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                name = f"stage{si + 1}_block{bi}"
                self.add_module(name, ResBlock(ch, filters, stride))
                names.append(name)
                ch = filters
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem3(self.stem2(self.stem1(x)))
        # max_pool2d pads with -inf, as the reference's explicit pad
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if si >= 1:
                feats.append(x)
        return feats


class PAFPN(nn.Module):
    """Path-aggregation FPN, top-down then bottom-up over 3 levels."""

    def __init__(self, in_channels: Sequence[int], filters: int):
        super().__init__()
        n = len(in_channels)
        self.n = n
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", ConvBN(c, filters, 1, padding=0))
            self.add_module(f"td_smooth{i}", ConvBN(filters, filters, 3))
        for i in range(1, n):
            self.add_module(f"bu_down{i}",
                            ConvBN(filters, filters, 3, stride=2))
            self.add_module(f"bu_smooth{i}", ConvBN(filters, filters, 3))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        lats = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        td = [None] * self.n
        td[-1] = lats[-1]
        for i in range(self.n - 2, -1, -1):
            td[i] = lats[i] + F.interpolate(td[i + 1], scale_factor=2,
                                            mode="nearest")
        td = [getattr(self, f"td_smooth{i}")(t) for i, t in enumerate(td)]
        outs = [td[0]]
        for i in range(1, self.n):
            down = getattr(self, f"bu_down{i}")(outs[-1])
            outs.append(getattr(self, f"bu_smooth{i}")(down + td[i]))
        return outs


class GNConv(nn.Module):
    """3x3 conv + GroupNorm + ReLU (head tower unit)."""

    def __init__(self, in_ch: int, filters: int, groups: int = 16):
        super().__init__()
        self.conv = Conv2d(in_ch, filters, 3, padding=1)
        self.gn = GroupNorm(groups, filters, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


def _flatten_nhwc(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, A*c, H, W) -> (B, H*W*A, c), the NHWC flatten of the reference."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, c)


class SCRFDHead(RoundedWeights, nn.Module):
    """Anchor-free head shared across levels: a GroupNorm conv tower, then
    cls / bbox / kps 3x3 convs, a learnable scale per level on the bbox
    (multiplied in the compute dtype). The outputs are float32 (float64
    in a trainer's check in double)."""

    def __init__(self, cfg: SCRFDConfig, in_ch: int):
        super().__init__()
        self.rounded = tuple(f"scale{li}" for li in range(len(cfg.strides)))
        self.cfg = cfg
        self.n_tower = cfg.head_stacks
        for i in range(cfg.head_stacks):
            self.add_module(f"tower{i}", GNConv(
                in_ch if i == 0 else cfg.head_filters, cfg.head_filters,
                cfg.gn_groups))
        a = cfg.num_anchors
        self.cls = Conv2d(cfg.head_filters, a, 3, padding=1)
        self.box = Conv2d(cfg.head_filters, a * 4, 3, padding=1)
        self.kps = Conv2d(cfg.head_filters, a * cfg.num_kps * 2, 3,
                          padding=1)
        for li in range(len(cfg.strides)):
            self.register_parameter(f"scale{li}",
                                    nn.Parameter(torch.ones(1)))

    def forward(self, feats: List[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        nk = self.cfg.num_kps * 2
        scores, bboxes, kpss = [], [], []
        for li, x in enumerate(feats):
            t = x
            for i in range(self.n_tower):
                t = getattr(self, f"tower{i}")(t)
            scale = self.w(f"scale{li}")
            scores.append(at_least_f32(_flatten_nhwc(
                torch.sigmoid(self.cls(t)), 1)))
            bboxes.append(at_least_f32(_flatten_nhwc(self.box(t) * scale, 4)))
            kpss.append(at_least_f32(_flatten_nhwc(self.kps(t), nk)))
        return {"scores": scores, "bboxes": bboxes, "kps": kpss}


class SCRFDNet(nn.Module):
    """Backbone -> PAFPN -> head. Input (B, 3, H, W) normalized RGB, in
    any float dtype (the first conv casts it to the compute dtype)."""

    def __init__(self, config: SCRFDConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.backbone = Backbone(config)
        self.neck = PAFPN(config.stage_filters[1:], config.neck_filters)
        self.head = SCRFDHead(config, config.neck_filters)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        return self.head(self.neck(self.backbone(x)))


def build_scrfd(name: str, dtype: torch.dtype = torch.float32) -> SCRFDNet:
    return SCRFDNet(SCRFD_CONFIGS[name], dtype=dtype)
