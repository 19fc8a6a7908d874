"""The plain reference's models: frozen copies of the stand-in modules.

The architectures are copied from the repository's stand-ins
(``tests/torch_export.py``: ``TorchSCRFD`` after the public SCRFD
configurations, ``TorchIResNet`` after the public ArcFace trunk), so that a later edit of the test helpers cannot
move the yardstick. ``build`` makes one from a configuration's sizes with
weights drawn from a seed on the device, in three calls (every parameter,
every BatchNorm running variance, every running mean), at the scales the
stand-ins use (``N(0, 0.1^2)`` parameters, variances in [0.75, 1.25),
means ``N(0, 0.1^2)``); detectors are then calibrated as the stand-ins
are. ``calibrate_norms_`` then sets the BatchNorm statistics from the
cell's own inputs, so that the outputs depend on the frame. The benchmark
hands these weights to the program through an ONNX file
(``export_onnx``) and keeps the module as the reference.

Imports torch only: nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def export_onnx(model: nn.Module, x: torch.Tensor, path: str,
                opset: int = 11) -> None:
    """``torch.onnx.export`` (TorchScript exporter, a dynamic batch axis)
    without the ``onnx`` package: the exporter imports it only to inject
    onnxscript functions, a no-op for these plain graphs."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = \
        lambda model_bytes, custom_opsets: model_bytes
    try:
        model.eval()
        torch.onnx.export(model, x, path, opset_version=opset, dynamo=False,
                          input_names=["input"],
                          dynamic_axes={"input": {0: "batch"}})
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


# --------------------------------------------------------------------- SCRFD

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


# ------------------------------------------------------------------- ArcFace

class IBasicBlock(nn.Module):
    """iResNet block: BN-Conv-BN-PReLU-Conv-BN (+1x1-conv shortcut)."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.prelu = nn.PReLU(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        # residual branch first (arcface_torch iresnet.py computes the
        # downsample after the main chain; node order must match its trace)
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        identity = self.down(x) if self.down is not None else x
        return y + identity


class TorchIResNet(nn.Module):
    """iResNet-style ArcFace trunk (w600k_r50 = blocks (3,4,14,3))."""

    def __init__(self, blocks=(3, 4, 14, 3), planes=(64, 128, 256, 512),
                 emb=512, fp16_bn=False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, planes[0], 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes[0])
        self.prelu = nn.PReLU(planes[0])
        layers = []
        cin = planes[0]
        for n, p in zip(blocks, planes):
            for bi in range(n):
                layers.append(IBasicBlock(cin, p, 2 if bi == 0 else 1))
                cin = p
        self.body = nn.Sequential(*layers)
        self.bn2 = nn.BatchNorm2d(planes[-1])
        self.fc = nn.Linear(planes[-1] * 7 * 7, emb)
        self.features = nn.BatchNorm1d(emb)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.bn2(self.body(x))
        x = torch.flatten(x, 1)
        return self.features(self.fc(x))


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


FAMILIES = {"scrfd": TorchSCRFD, "iresnet": TorchIResNet}


# keys of a configuration's model entry that are not constructor sizes
NOT_SIZES = ("family", "variant", "score_logit_shift")


def architecture(spec: dict) -> nn.Module:
    """The module a configuration's ``detector`` or ``embedder`` entry
    describes: ``family`` picks the class, the keys but ``NOT_SIZES`` are
    its constructor's sizes."""
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in spec.items() if k not in NOT_SIZES}
    return FAMILIES[spec["family"]](**kw)


@torch.no_grad()
def calibrate_norms_(model: nn.Module, x: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to the batch statistics of
    the activations ``x`` gives it, layer by layer (one forward in
    training mode, each norm normalising with its own batch's statistics
    as it records them), then back to eval mode. Seeded weights with the
    seeded statistics map every input to nearly the same output (heads
    within 1e-6 across frames, embeddings of different crops at cosine
    1.0000); with statistics of real inputs the outputs follow the
    input."""
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None               # a cumulative average: this batch
        m.train()
    model(x)
    for m in norms:
        m.momentum = 0.1
    return model.eval()


@torch.no_grad()
def seed_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Every parameter N(0, 0.1^2), every BatchNorm running variance
    uniform in [0.75, 1.25) and running mean N(0, 0.1^2), drawn on the
    model's device from ``seed`` in one call each."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = list(model.parameters())
    flat = torch.randn(sum(p.numel() for p in params), generator=gen,
                       device=dev) * 0.1
    _scatter(params, flat)
    buffers = dict(model.named_buffers())
    var = [b for n, b in buffers.items() if n.endswith("running_var")]
    mean = [b for n, b in buffers.items() if n.endswith("running_mean")]
    _scatter(var, torch.rand(sum(b.numel() for b in var), generator=gen,
                             device=dev) * 0.5 + 0.75)
    _scatter(mean, torch.randn(sum(b.numel() for b in mean), generator=gen,
                               device=dev) * 0.1)
    return model


def _scatter(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def build(spec: dict, seed: int, device) -> nn.Module:
    """The configured module in eval mode on ``device``, its weights drawn
    from ``seed`` there (no host copy of the parameters); detectors
    calibrated, then their score logits raised by the entry's
    ``score_logit_shift`` (the classifier's bias), so that every seed's
    detector fills the slate and keeps the same number of faces."""
    with torch.device("meta"):
        model = architecture(spec)
    model = model.to_empty(device=device)
    for name, b in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            b.zero_()
    seed_weights_(model, seed)
    if spec["family"] == "scrfd":
        calibrate_detector(model)
        with torch.no_grad():
            model.head.cls.bias.add_(spec.get("score_logit_shift", 0.0))
    return model.eval().requires_grad_(False)
