"""ArcFace embedders in PyTorch: iResNet (w600k_r50), MobileFaceNet
(w600k_mbf).

Contract of the released graphs: 112x112 input normalized (x-127.5)/127.5
RGB, one 512-d output. Input is NCHW. The embedding head flattens the last
feature map in NHWC order, as the reference does, so the FC weight carries
over from the Flax tree as a plain transpose. Submodule names follow the
JAX package's Flax names. ``dtype`` is the compute dtype
(``layers.set_compute_dtype``); parameters stay float32 and the embedding
leaves the model as float32, as the JAX models cast it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch
from torch import nn

from .layers import (BatchNorm1d, BatchNorm2d, Conv2d, ConvBN, Linear, PReLU,
                     set_compute_dtype)


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig:
    name: str
    arch: str                      # "iresnet" | "mobilefacenet"
    emb_dim: int = 512
    input_size: Tuple[int, int] = (112, 112)
    # iresnet
    stage_blocks: Sequence[int] = (3, 4, 14, 3)
    stage_filters: Sequence[int] = (64, 128, 256, 512)
    # mobilefacenet; None widths take the public get_mbf defaults
    mbf_blocks: Sequence[int] = (1, 4, 6, 2)
    mbf_scale: int = 2
    mbf_stem_filters: Any = None
    mbf_stem_dw_groups: Any = None
    mbf_stage_filters: Any = None
    mbf_down_groups: Any = None
    mbf_res_groups: Any = None
    mbf_sep_filters: Any = None

    def mbf_widths(self) -> dict:
        s = self.mbf_scale
        return {
            "stem": self.mbf_stem_filters or 64 * s,
            "stem_dw_groups": self.mbf_stem_dw_groups or 64,
            "stage_filters": tuple(self.mbf_stage_filters
                                   or (64 * s, 128 * s, 128 * s)),
            "down_groups": tuple(self.mbf_down_groups or (128, 256, 512)),
            "res_groups": tuple(self.mbf_res_groups or (128, 128, 256, 256)),
            "sep": self.mbf_sep_filters or 512,
        }


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).flatten(1)


class IBasicBlock(nn.Module):
    """BN-Conv3x3-BN-PReLU-Conv3x3(s)-BN + skip."""

    def __init__(self, in_ch: int, filters: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm2d(in_ch, eps=1e-5)
        self.conv1 = Conv2d(in_ch, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(filters, eps=1e-5)
        self.prelu = PReLU(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride=stride, padding=1,
                            bias=False)
        self.bn3 = BatchNorm2d(filters, eps=1e-5)
        if stride != 1 or in_ch != filters:
            self.down_conv = Conv2d(in_ch, filters, 1, stride=stride,
                                    bias=False)
            self.down_bn = BatchNorm2d(filters, eps=1e-5)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self.bn1(x))
        out = self.prelu(self.bn2(out))
        out = self.bn3(self.conv2(out))
        identity = x
        if self.down_conv is not None:
            identity = self.down_bn(self.down_conv(x))
        return out + identity


class IResNet(nn.Module):
    """iResNet trunk + ArcFace embedding head (BN -> flatten -> FC -> BN)."""

    def __init__(self, config: ArcFaceConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        c0 = cfg.stage_filters[0]
        self.stem_conv = Conv2d(3, c0, 3, padding=1, bias=False)
        self.stem_bn = BatchNorm2d(c0, eps=1e-5)
        self.stem_prelu = PReLU(c0)
        self.blocks = []
        ch = c0
        for si, (nblocks, filters) in enumerate(zip(cfg.stage_blocks,
                                                    cfg.stage_filters)):
            for bi in range(nblocks):
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, IBasicBlock(ch, filters,
                                                  2 if bi == 0 else 1))
                self.blocks.append(name)
                ch = filters
        side = cfg.input_size[0] // 2 ** len(cfg.stage_blocks)
        self.head_bn = BatchNorm2d(ch, eps=1e-5)
        self.fc = Linear(ch * side * side, cfg.emb_dim)
        self.features_bn = BatchNorm1d(cfg.emb_dim, eps=1e-5)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_prelu(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = _flatten_nhwc(self.head_bn(x))
        return self.features_bn(self.fc(x)).float()


class MBFDepthWise(nn.Module):
    """1x1 expand -> 3x3 grouped dw -> 1x1 linear project (+ residual)."""

    def __init__(self, in_ch: int, filters: int, groups: int,
                 stride: int = 1, residual: bool = False):
        super().__init__()
        self.residual = residual
        self.expand = ConvBN(in_ch, groups, 1, padding=0, act="prelu")
        self.dw = ConvBN(groups, groups, 3, stride=stride, padding=1,
                         groups=groups, act="prelu")
        self.project = ConvBN(groups, filters, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.project(self.dw(self.expand(x)))
        return out + x if self.residual else out


class MobileFaceNet(nn.Module):
    """MobileFaceNet (w600k_mbf: blocks (1, 4, 6, 2), scale 2, GDC head)."""

    def __init__(self, config: ArcFaceConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        w = cfg.mbf_widths()
        stem, sep = w["stem"], w["sep"]
        self.stem = ConvBN(3, stem, 3, stride=2, padding=1, act="prelu")
        self.blocks = []
        if cfg.mbf_blocks[0] == 1:
            self.stem_dw = ConvBN(stem, stem, 3, padding=1,
                                  groups=w["stem_dw_groups"], act="prelu")
            self.blocks.append("stem_dw")
        else:
            for bi in range(cfg.mbf_blocks[0]):
                name = f"stage0_block{bi}"
                self.add_module(name, MBFDepthWise(
                    stem, stem, w["res_groups"][0], 1, residual=True))
                self.blocks.append(name)
        ch = stem
        for si in range(3):
            c = w["stage_filters"][si]
            self.add_module(f"down{si}", MBFDepthWise(
                ch, c, w["down_groups"][si], 2))
            self.blocks.append(f"down{si}")
            for bi in range(cfg.mbf_blocks[si + 1]):
                name = f"stage{si + 1}_block{bi}"
                self.add_module(name, MBFDepthWise(
                    c, c, w["res_groups"][si + 1], 1, residual=True))
                self.blocks.append(name)
            ch = c
        self.conv_sep = ConvBN(ch, sep, 1, padding=0, act="prelu")
        gk = cfg.input_size[0] // 16
        self.gdc = ConvBN(sep, sep, gk, padding=0, groups=sep)
        self.fc = Linear(sep, cfg.emb_dim, bias=False)
        self.features_bn = BatchNorm1d(cfg.emb_dim, eps=1e-5)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = _flatten_nhwc(self.gdc(self.conv_sep(x)))
        return self.features_bn(self.fc(x)).float()


ARCFACE_CONFIGS = {
    "w600k_r50": ArcFaceConfig(name="w600k_r50", arch="iresnet",
                               stage_blocks=(3, 4, 14, 3),
                               stage_filters=(64, 128, 256, 512)),
    "w600k_mbf": ArcFaceConfig(name="w600k_mbf", arch="mobilefacenet",
                               mbf_blocks=(1, 4, 6, 2), mbf_scale=2),
}


def arcface_from_config(cfg: ArcFaceConfig,
                        dtype: torch.dtype = torch.float32) -> nn.Module:
    return (IResNet(cfg, dtype) if cfg.arch == "iresnet"
            else MobileFaceNet(cfg, dtype))


def build_arcface(name: str, dtype: torch.dtype = torch.float32) -> nn.Module:
    return arcface_from_config(ARCFACE_CONFIGS[name], dtype)
