"""iResNet, the ArcFace embedder family (``"family": "iresnet"``): a
frozen copy of the repository's stand-in ``TorchIResNet``
(``tests/torch_export.py``, after the public ArcFace trunk,
arcface_torch's ``iresnet.py``), so that a later edit of the test helpers
cannot move the yardstick.

The harness finds this file by the configuration's ``family``
(``core.family``); ``standins.py`` says what a family file holds.

Imports torch only: nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

# keys of the configuration's entry that are not sizes of ``MODULE``
NOT_SIZES = ("family", "variant")


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


MODULE = TorchIResNet


def prepare(model: TorchIResNet, spec: dict) -> TorchIResNet:
    """Nothing follows the seeded draw."""
    return model


def small(spec: dict) -> dict:
    """The entry one block a stage deep, at its widths."""
    return dict(spec, blocks=[1] * len(spec["blocks"]))
