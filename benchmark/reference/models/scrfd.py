"""SCRFD, the detector family (``"family": "scrfd"``): a frozen copy of
the repository's stand-in ``TorchSCRFD`` (``tests/torch_export.py``, after
the public SCRFD configurations), so that a later edit of the test helpers
cannot move the yardstick.

The harness finds this file by the configuration's ``family``
(``core.family``); ``standins.py`` says what a family file holds. After
the seeded draw a detector is calibrated as the stand-ins are, then its
score logits raised by the entry's ``score_logit_shift`` (the
classifier's bias), so that every seed's detector fills the slate and
keeps the same number of faces.

Imports torch only: nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# keys of the configuration's entry that are not sizes of ``MODULE``
NOT_SIZES = ("family", "variant", "score_logit_shift")


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, k=3, s=1, relu=True):
        layers = [nn.Conv2d(cin, cout, k, s, k // 2, bias=False),
                  nn.BatchNorm2d(cout)]
        if relu:
            layers.append(nn.ReLU(inplace=False))
        super().__init__(*layers)


class BasicBlockV1e(nn.Module):
    """mmdet ResNetV1e BasicBlock with avg-down shortcut."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = ConvBNReLU(cin, cout, 3, stride)
        self.conv2 = ConvBNReLU(cout, cout, 3, 1, relu=False)
        self.down = None
        if stride != 1 or cin != cout:
            down = []
            if stride != 1:
                down.append(nn.AvgPool2d(stride, stride, ceil_mode=True,
                                         count_include_pad=False))
            down += [nn.Conv2d(cin, cout, 1, 1, 0, bias=False),
                     nn.BatchNorm2d(cout)]
            self.down = nn.Sequential(*down)

    def forward(self, x):
        # main chain BEFORE the shortcut: mmdet's BasicBlock computes the
        # residual branch first, so the traced node order (what the ordered
        # importer zips against) matches the released files' graphs
        out = self.conv2(self.conv1(x))
        identity = self.down(x) if self.down is not None else x
        return F.relu(out + identity)


class ResNetV1e(nn.Module):
    """Deep-stem (3 convs) + maxpool + 4 stages; stage1 stride 1.

    Returns stages 2..4 (strides 8/16/32)."""

    def __init__(self, stem=56, blocks=(3, 5, 2, 3),
                 planes=(56, 56, 144, 248)):
        super().__init__()
        self.stem = nn.Sequential(
            ConvBNReLU(3, stem // 2, 3, 2), ConvBNReLU(stem // 2, stem // 2),
            ConvBNReLU(stem // 2, stem))
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        stages = []
        cin = stem
        for si, (n, p) in enumerate(zip(blocks, planes)):
            mods = []
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                mods.append(BasicBlockV1e(cin, p, stride))
                cin = p
            stages.append(nn.Sequential(*mods))
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        outs = []
        for si, stage in enumerate(self.stages):
            x = stage(x)
            if si >= 1:
                outs.append(x)
        return outs


class PAFPNTorch(nn.Module):
    def __init__(self, in_channels: Sequence[int], out: int):
        super().__init__()
        self.lateral = nn.ModuleList(
            [nn.Conv2d(c, out, 1) for c in in_channels])
        self.fpn = nn.ModuleList(
            [nn.Conv2d(out, out, 3, padding=1) for _ in in_channels])
        self.down = nn.ModuleList(
            [nn.Conv2d(out, out, 3, 2, 1) for _ in in_channels[1:]])
        self.pafpn = nn.ModuleList(
            [nn.Conv2d(out, out, 3, padding=1) for _ in in_channels[1:]])

    def forward(self, feats: List[torch.Tensor]):
        lats = [l(f) for l, f in zip(self.lateral, feats)]
        for i in range(len(lats) - 1, 0, -1):
            lats[i - 1] = lats[i - 1] + F.interpolate(
                lats[i], scale_factor=2.0, mode="nearest")
        outs = [f(l) for f, l in zip(self.fpn, lats)]
        for i in range(len(outs) - 1):
            outs[i + 1] = self.pafpn[i](self.down[i](outs[i]) + outs[i + 1])
        return outs


class SCRFDHeadTorch(nn.Module):
    """Stacked conv+GN+ReLU tower shared across levels; cls/box/kps convs."""

    def __init__(self, cin: int, feat: int, stacks: int, anchors: int = 2,
                 kps: int = 5, gn_groups: int = 16):
        super().__init__()
        tower = []
        for i in range(stacks):
            tower.append(nn.Conv2d(cin if i == 0 else feat, feat, 3,
                                   padding=1, bias=False))
            tower.append(nn.GroupNorm(gn_groups, feat))
            tower.append(nn.ReLU(inplace=False))
        self.tower = nn.Sequential(*tower)
        self.cls = nn.Conv2d(feat, anchors * 1, 3, padding=1)
        self.box = nn.Conv2d(feat, anchors * 4, 3, padding=1)
        self.kps = nn.Conv2d(feat, anchors * kps * 2, 3, padding=1)

    def forward(self, x, scale: torch.Tensor):
        t = self.tower(x)
        b = x.shape[0]
        s = torch.sigmoid(self.cls(t))
        d = self.box(t) * scale
        k = self.kps(t)
        # (B, A*C, H, W) -> (B, H*W*A, C), the released 9-output layout
        def to_nc(v, c):
            a = v.shape[1] // c
            return v.permute(0, 2, 3, 1).reshape(b, -1, c)
        return to_nc(s, 1), to_nc(d, 4), to_nc(k, 10)


class TorchSCRFD(nn.Module):
    """Outputs the released files' 9 tensors: scores, boxes and keypoints
    of strides 8, 16 and 32."""

    def __init__(self, stem=56, blocks=(3, 5, 2, 3),
                 planes=(56, 56, 144, 248), neck=56, head_feat=80,
                 head_stacks=3, gn_groups=16):
        super().__init__()
        self.backbone = ResNetV1e(stem, blocks, planes)
        self.neck = PAFPNTorch(planes[1:], neck)
        self.head = SCRFDHeadTorch(neck, head_feat, head_stacks,
                                   gn_groups=gn_groups)
        self.scales = nn.Parameter(torch.ones(3))

    def forward(self, x):
        feats = self.neck(self.backbone(x))
        scores, boxes, kps = [], [], []
        for li, f in enumerate(feats):
            s, d, k = self.head(f, self.scales[li])
            scores.append(s)
            boxes.append(d)
            kps.append(k)
        return tuple(scores + boxes + kps)


MODULE = TorchSCRFD


def calibrate_detector(model: TorchSCRFD) -> TorchSCRFD:
    """Make a seeded stand-in emit PLAUSIBLE geometry.

    Seeding randomizes every parameter, which leaves the FCOS per-level
    scales ~N(0, 0.1): box distances collapse to sub-pixel sizes, NMS/IoU
    and the max_num area metric then operate on degenerate near-tied boxes
    and e2e comparisons stress tie-breaking instead of the pipeline. Set
    the scales to distinct O(1) values and bias the box/kps branches so
    decoded faces are tens of pixels with data-dependent variation — the
    regime the real graphs produce."""
    with torch.no_grad():
        model.scales.copy_(torch.tensor([1.0, 1.15, 0.85]))
        model.head.box.bias.fill_(3.0)     # ~3 stride-units per side
        model.head.box.weight.mul_(3.0)    # data-driven size variation
        model.head.kps.bias.copy_(
            torch.linspace(-1.0, 1.0, model.head.kps.bias.numel()))
        model.head.kps.weight.mul_(3.0)
    return model


def prepare(model: TorchSCRFD, spec: dict) -> TorchSCRFD:
    """After the seeded draw: calibrated, then the entry's
    ``score_logit_shift`` on the classifier's bias."""
    calibrate_detector(model)
    with torch.no_grad():
        model.head.cls.bias.add_(spec.get("score_logit_shift", 0.0))
    return model


def small(spec: dict) -> dict:
    """The entry one block a stage deep, at its widths."""
    return dict(spec, blocks=[1] * len(spec["blocks"]))
