"""Export the port's models to ONNX: the far end of train -> deploy.

The port's copy of the JAX package's ``models/onnx_export.py``. A model
trained here (``train/arcface_train.py``, ``tools/train_arcface.py``) is
written in the format of the released files, so the reference's
onnxruntime stack, the port's graph executor (``onnx_exec.py``) or any
ONNX runtime serves it unchanged.

Each ``export_*`` takes either a port ``nn.Module`` (its weights read with
``weights.variables_from_module``) or a config (``ArcFaceConfig`` /
``SCRFDConfig``) with a Flax-layout numpy tree ``{"params",
"batch_stats"}``, and writes the same graph as the JAX exporter on that
tree, byte for byte: the same nodes, node and initializer names, and
a dynamic batch dimension.

Contract of the released files:
- detector: input (B, 3, H, W) f32 normalized RGB; 9 outputs ordered
  [score x3, bbox x3, kps x3] shaped (B, Hs*Ws*2, {1, 4, 10});
- embedder: input (B, 3, 112, 112) f32 normalized; one (B, 512) output.

The weight layouts are the exact inverses of the importer's
(``onnx_import.py``), so export -> import round-trips bit for bit. A
space-to-depth detector stem (2, 2, 12, C) in a tree exports as the plain
stride-2 stem it equals (``scrfd.s2d_kernel_to_stem``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from .onnx_write import (encode_attr_float, encode_attr_int,
                         encode_attr_ints, encode_attr_string, encode_model,
                         encode_node)
from .scrfd import s2d_kernel_to_stem
from .weights import variables_from_module

__all__ = ["GraphBuilder", "export_arcface", "export_scrfd", "export_model"]


def _config_and_tree(model, variables: Optional[Mapping]
                     ) -> Tuple[Any, Mapping]:
    """(config, Flax-layout tree) from a port module (its own weights
    unless ``variables`` is given) or from a config and its tree."""
    if isinstance(model, nn.Module):
        cfg = model.config
        if variables is None:
            variables = variables_from_module(model)
    else:
        cfg = model
        if variables is None:
            raise ValueError("a config needs its variables tree")
    return cfg, variables


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


class GraphBuilder:
    """Incremental ONNX graph assembly from Flax-layout weights."""

    def __init__(self, input_name: str = "input.1"):
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.input_name = input_name
        self._n = 0

    # ------------------------------------------------------------- plumbing

    def _uniq(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, name: str, arr: np.ndarray) -> str:
        """Register an initializer; re-registering the same name is allowed
        only for shared weights (must be the identical array)."""
        if name in self.inits:
            if self.inits[name] is not arr and not np.array_equal(
                    self.inits[name], arr):
                raise ValueError(f"initializer name collision: {name}")
            return name
        self.inits[name] = np.ascontiguousarray(arr)
        return name

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1,
             name: str = "", attrs: Optional[List[bytes]] = None):
        outs = [self._uniq(name or op.lower()) for _ in range(n_out)]
        self.nodes.append(encode_node(op, list(inputs), outs,
                                      name=name or outs[0], attrs=attrs))
        return outs[0] if n_out == 1 else outs

    def finish(self, outputs: Sequence[str], path: Optional[str] = None,
               io_types: Optional[Dict] = None,
               graph_name: str = "graph") -> bytes:
        """io_types: {name: (elem_type, dims)} — onnxruntime REQUIRES type
        info on graph IO (this repo's parser does not read it)."""
        data = encode_model(self.nodes, self.inits, [self.input_name],
                            list(outputs), io_types=io_types,
                            graph_name=graph_name)
        if path is not None:
            with open(path, "wb") as f:
                f.write(data)
        return data

    # ------------------------------------------------------------- core ops

    def conv(self, x: str, kernel_hwio, bias=None, stride: int = 1,
             pads: int = 1, groups: int = 1, wname: Optional[str] = None
             ) -> str:
        """Conv from a Flax HWIO kernel (+ optional bias). `wname` names the
        weight initializer — pass the same name twice to share weights
        across nodes (the head tower reuses one tensor per level, like the
        released files)."""
        k = _np(kernel_hwio)
        wname = wname or self._uniq("w")
        self.init(wname, np.transpose(k, (3, 2, 0, 1)))  # HWIO -> OIHW
        ins = [x, wname]
        if bias is not None:
            bname = wname + "_b"
            self.init(bname, _np(bias).reshape(-1))  # re-registration of a
            # shared weight's bias validates it is the identical tensor
            ins.append(bname)
        attrs = [encode_attr_ints("kernel_shape", [k.shape[0], k.shape[1]]),
                 encode_attr_ints("strides", [stride, stride]),
                 encode_attr_ints("pads", [pads, pads, pads, pads]),
                 encode_attr_ints("dilations", [1, 1]),
                 encode_attr_int("group", groups)]
        return self.node("Conv", ins, attrs=attrs)

    def batchnorm(self, x: str, params: Dict, stats: Dict,
                  name: str = "bn", eps: float = 1e-5) -> str:
        pre = self._uniq(name)
        ins = [x]
        for suffix, arr in (("s", params["scale"]), ("b", params["bias"]),
                            ("m", stats["mean"]), ("v", stats["var"])):
            ins.append(self.init(f"{pre}_{suffix}", _np(arr).reshape(-1)))
        return self.node("BatchNormalization", ins,
                         attrs=[encode_attr_float("epsilon", eps),
                                encode_attr_float("momentum", 0.9)])

    def prelu(self, x: str, alpha) -> str:
        a = _np(alpha).reshape(-1, 1, 1)   # (C,1,1) broadcasts over NCHW
        return self.node("PRelu", [x, self.init(self._uniq("slope"), a)])

    def relu(self, x: str) -> str:
        return self.node("Relu", [x])

    def sigmoid(self, x: str) -> str:
        return self.node("Sigmoid", [x])

    def add(self, a: str, b: str) -> str:
        return self.node("Add", [a, b])

    def mul_scalar(self, x: str, v: float) -> str:
        s = self.init(self._uniq("scale"), np.float32(v).reshape(()))
        return self.node("Mul", [x, s])

    def maxpool(self, x: str, kernel: int, stride: int, pads: int) -> str:
        return self.node("MaxPool", [x], attrs=[
            encode_attr_ints("kernel_shape", [kernel, kernel]),
            encode_attr_ints("strides", [stride, stride]),
            encode_attr_ints("pads", [pads] * 4)])

    def avgpool(self, x: str, kernel: int, stride: int) -> str:
        return self.node("AveragePool", [x], attrs=[
            encode_attr_ints("kernel_shape", [kernel, kernel]),
            encode_attr_ints("strides", [stride, stride]),
            encode_attr_ints("pads", [0] * 4)])

    def resize2x(self, x: str) -> str:
        """Nearest 2x upsample (FPN top-down), opset-11 Resize."""
        scales = self.init(self._uniq("scales"),
                           np.asarray([1, 1, 2, 2], np.float32))
        return self.node("Resize", [x, "", scales], attrs=[
            encode_attr_string("mode", "nearest"),
            encode_attr_string("coordinate_transformation_mode",
                               "asymmetric"),
            encode_attr_string("nearest_mode", "floor")])

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        s = self.init(self._uniq("shape"), np.asarray(shape, np.int64))
        return self.node("Reshape", [x, s])

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        return self.node("Transpose", [x],
                         attrs=[encode_attr_ints("perm", perm)])

    def flatten(self, x: str) -> str:
        return self.node("Flatten", [x], attrs=[encode_attr_int("axis", 1)])

    def gemm(self, x: str, kernel, bias=None,
             chw: Optional[Tuple[int, int, int]] = None) -> str:
        """Dense from a Flax (in, out) kernel. `chw` = the pre-flatten
        (C, H, W) map shape when the in-axis was an NHWC flatten: the ONNX
        side flattens NCHW, so the rows permute (exact inverse of
        onnx_import.fc_kernel_to_flax)."""
        k = _np(kernel)
        if chw is not None and chw[1] * chw[2] != 1:
            c, h, w = chw
            # rows (h, w, c) -> (c, h, w), keeping (in, out) orientation
            k = k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(
                c * h * w, -1)
        wname = self.init(self._uniq("fc_w"), k.T)   # (out, in), transB=1
        ins = [x, wname]
        if bias is not None:
            ins.append(self.init(self._uniq("fc_b"), _np(bias).reshape(-1)))
        return self.node("Gemm", ins, attrs=[encode_attr_int("transB", 1)])

    def groupnorm(self, x: str, params: Dict, groups: int,
                  eps: float = 1e-5, wname: Optional[str] = None) -> str:
        """GroupNorm via the released files' idiom:
        Reshape(B,G,-1) -> InstanceNormalization -> Reshape(back) ->
        Mul(scale) -> Add(bias). Pass the same `wname` to share the affine
        parameters across nodes (one GN module traced per FPN level)."""
        wname = wname or self._uniq("gn")
        shp = self.node("Shape", [x])
        r1 = self.reshape(x, [0, groups, -1])
        ones = self.init(f"{wname}_ones", np.ones(groups, np.float32))
        zeros = self.init(f"{wname}_zeros", np.zeros(groups, np.float32))
        y = self.node("InstanceNormalization", [r1, ones, zeros],
                      attrs=[encode_attr_float("epsilon", eps)])
        y = self.node("Reshape", [y, shp])
        scale = _np(params["scale"]).reshape(1, -1, 1, 1)
        bias = _np(params["bias"]).reshape(1, -1, 1, 1)
        y = self.node("Mul", [y, self.init(f"{wname}_s", scale)])
        return self.node("Add", [y, self.init(f"{wname}_b", bias)])

    # ----------------------------------------------- the models' subtrees

    def conv_bn(self, x: str, p: Dict, bs: Dict, stride: int = 1,
                pads: int = 1, groups: int = 1, relu: bool = False,
                prelu: bool = False, wname: Optional[str] = None) -> str:
        """Emit a layers.ConvBN subtree (conv [+bn] [+act])."""
        conv_p = p["conv"]
        x = self.conv(x, conv_p["kernel"], conv_p.get("bias"), stride=stride,
                      pads=pads, groups=groups, wname=wname)
        if "bn" in p:
            x = self.batchnorm(x, p["bn"], bs["bn"])
        if prelu:
            x = self.prelu(x, p["prelu"]["alpha"])
        elif relu:
            x = self.relu(x)
        return x


# ---------------------------------------------------------------- embedders


def _export_iresnet(cfg, variables, path=None) -> bytes:
    p = variables["params"]
    bs = variables["batch_stats"]
    g = GraphBuilder()
    x = g.input_name

    stem_kernel = np.asarray(p["stem_conv"]["kernel"])
    x = g.conv(x, stem_kernel, None, stride=1, pads=1, wname="stem_w")
    x = g.batchnorm(x, p["stem_bn"], bs["stem_bn"])
    x = g.prelu(x, p["stem_prelu"]["alpha"])

    for si, nblocks in enumerate(cfg.stage_blocks):
        for bi in range(nblocks):
            stride = 2 if bi == 0 else 1
            bp = p[f"layer{si + 1}_block{bi}"]
            bb = bs[f"layer{si + 1}_block{bi}"]
            out = g.batchnorm(x, bp["bn1"], bb["bn1"])
            out = g.conv(out, bp["conv1"]["kernel"], None, pads=1)
            out = g.batchnorm(out, bp["bn2"], bb["bn2"])
            out = g.prelu(out, bp["prelu"]["alpha"])
            out = g.conv(out, bp["conv2"]["kernel"], None, stride=stride,
                         pads=1)
            out = g.batchnorm(out, bp["bn3"], bb["bn3"])
            if "down_conv" in bp:
                identity = g.conv(x, bp["down_conv"]["kernel"], None,
                                  stride=stride, pads=0)
                identity = g.batchnorm(identity, bp["down_bn"],
                                       bb["down_bn"])
            else:
                identity = x
            x = g.add(out, identity)

    x = g.batchnorm(x, p["head_bn"], bs["head_bn"])
    x = g.flatten(x)
    h = cfg.input_size[0] // 16
    w = cfg.input_size[1] // 16
    x = g.gemm(x, p["fc"]["kernel"], p["fc"].get("bias"),
               chw=(cfg.stage_filters[-1], h, w))
    x = g.batchnorm(x, p["features_bn"], bs["features_bn"])
    return g.finish([x], path, graph_name=cfg.name, io_types={
        g.input_name: (1, ("batch", 3, *cfg.input_size)),
        x: (1, ("batch", cfg.emb_dim))})


def _export_mbf(cfg, variables, path=None) -> bytes:
    p = variables["params"]
    bs = variables["batch_stats"]
    s = cfg.mbf_scale
    g = GraphBuilder()

    def dw_unit(x, name, stride):
        """MBFDepthWise: 1x1 expand -> grouped 3x3 dw -> 1x1 project."""
        up, ub = p[name], bs[name]
        groups = np.asarray(up["dw"]["conv"]["kernel"]).shape[-1]
        out = g.conv_bn(x, up["expand"], ub["expand"], pads=0, prelu=True)
        out = g.conv_bn(out, up["dw"], ub["dw"], stride=stride, pads=1,
                        groups=int(groups), prelu=True)
        return g.conv_bn(out, up["project"], ub["project"], pads=0)

    def conv_groups(unit_p):
        """Group count of a same-width grouped conv from its Flax kernel
        (kh, kw, cin/g, out) — cin == out for every mbf grouped conv, so
        g = out // (cin/g)."""
        k = np.asarray(unit_p["conv"]["kernel"])
        return int(k.shape[3]) // int(k.shape[2])

    x = g.conv_bn(g.input_name, p["stem"], bs["stem"], stride=2, pads=1,
                  prelu=True)
    if cfg.mbf_blocks[0] == 1:
        x = g.conv_bn(x, p["stem_dw"], bs["stem_dw"], pads=1,
                      groups=conv_groups(p["stem_dw"]), prelu=True)
    else:
        for bi in range(cfg.mbf_blocks[0]):
            x = g.add(dw_unit(x, f"stage0_block{bi}", 1), x)
    for si, n in enumerate(cfg.mbf_blocks[1:]):
        x = dw_unit(x, f"down{si}", 2)
        for bi in range(n):
            x = g.add(dw_unit(x, f"stage{si + 1}_block{bi}", 1), x)
    x = g.conv_bn(x, p["conv_sep"], bs["conv_sep"], pads=0, prelu=True)
    x = g.conv_bn(x, p["gdc"], bs["gdc"], pads=0, groups=conv_groups(p["gdc"]))
    x = g.flatten(x)   # (B, 512, 1, 1): NCHW and NHWC flatten agree
    x = g.gemm(x, p["fc"]["kernel"], p["fc"].get("bias"))
    x = g.batchnorm(x, p["features_bn"], bs["features_bn"])
    return g.finish([x], path, graph_name=cfg.name, io_types={
        g.input_name: (1, ("batch", 3, *cfg.input_size)),
        x: (1, ("batch", cfg.emb_dim))})


def export_arcface(model, variables: Optional[Mapping] = None,
                   path: Optional[str] = None) -> bytes:
    """An IResNet / MobileFaceNet (a port module, or a config with its
    tree) as ONNX ModelProto bytes; also writes ``path`` when given."""
    cfg, variables = _config_and_tree(model, variables)
    arch = getattr(cfg, "arch", None)
    if arch == "iresnet":
        return _export_iresnet(cfg, variables, path)
    if arch == "mobilefacenet":
        return _export_mbf(cfg, variables, path)
    raise ValueError(f"unknown ArcFace arch: {arch!r}")


# ----------------------------------------------------------------- detector


def export_scrfd(model, variables: Optional[Mapping] = None,
                 path: Optional[str] = None) -> bytes:
    """A SCRFD detector (a port module, or a config with its tree) as ONNX
    with the released files' 9-output contract. An s2d stem kernel in the
    tree exports as the equivalent plain stride-2 stem."""
    cfg, variables = _config_and_tree(model, variables)
    p = variables["params"]
    bs = variables["batch_stats"]
    g = GraphBuilder()

    # -- backbone
    bp, bb = p["backbone"], bs["backbone"]
    stem_kernel = np.asarray(bp["stem1"]["conv"]["kernel"])
    if tuple(stem_kernel.shape[:3]) == (2, 2, 12):
        stem_kernel = s2d_kernel_to_stem(stem_kernel)
    x = g.conv(g.input_name, stem_kernel, None, stride=2, pads=1,
               wname="stem1_w")
    x = g.batchnorm(x, bp["stem1"]["bn"], bb["stem1"]["bn"])
    x = g.relu(x)
    x = g.conv_bn(x, bp["stem2"], bb["stem2"], pads=1, relu=True)
    x = g.conv_bn(x, bp["stem3"], bb["stem3"], pads=1, relu=True)
    x = g.maxpool(x, 3, 2, 1)

    feats = []
    for si, nblocks in enumerate(cfg.stage_blocks):
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            rp = bp[f"stage{si + 1}_block{bi}"]
            rb = bb[f"stage{si + 1}_block{bi}"]
            out = g.conv_bn(x, rp["conv1"], rb["conv1"], stride=stride,
                            pads=1, relu=True)
            out = g.conv_bn(out, rp["conv2"], rb["conv2"], pads=1)
            if "down" in rp:
                identity = x
                if stride != 1:
                    identity = g.avgpool(identity, stride, stride)
                identity = g.conv_bn(identity, rp["down"], rb["down"],
                                     pads=0)
            else:
                identity = x
            x = g.relu(g.add(out, identity))
        if si >= 1:
            feats.append(x)

    # -- PAFPN neck
    np_, nb = p["neck"], bs["neck"]
    lats = [g.conv_bn(f, np_[f"lateral{i}"], nb[f"lateral{i}"], pads=0)
            for i, f in enumerate(feats)]
    td = [None] * len(lats)
    td[-1] = lats[-1]
    for i in range(len(lats) - 2, -1, -1):
        td[i] = g.add(lats[i], g.resize2x(td[i + 1]))
    td = [g.conv_bn(t, np_[f"td_smooth{i}"], nb[f"td_smooth{i}"], pads=1)
          for i, t in enumerate(td)]
    outs = [td[0]]
    for i in range(1, len(td)):
        down = g.conv_bn(outs[-1], np_[f"bu_down{i}"], nb[f"bu_down{i}"],
                         stride=2, pads=1)
        outs.append(g.conv_bn(g.add(down, td[i]), np_[f"bu_smooth{i}"],
                              nb[f"bu_smooth{i}"], pads=1))

    # -- head (weights shared across levels; initializers registered once)
    hp = p["head"]
    scores, bboxes, kpss = [], [], []
    for li, f in enumerate(outs):
        t = f
        for i in range(cfg.head_stacks):
            tw = hp[f"tower{i}"]
            t = g.conv(t, tw["conv"]["kernel"], tw["conv"].get("bias"),
                       pads=1, wname=f"tower{i}_w")
            t = g.groupnorm(t, tw["gn"], groups=getattr(cfg, "gn_groups", 16),
                            wname=f"tower{i}_gn")
            t = g.relu(t)
        s = g.conv(t, hp["cls"]["kernel"], hp["cls"].get("bias"), pads=1,
                   wname="cls_w")
        s = g.reshape(g.transpose(g.sigmoid(s), (0, 2, 3, 1)), (0, -1, 1))
        d = g.conv(t, hp["box"]["kernel"], hp["box"].get("bias"), pads=1,
                   wname="box_w")
        d = g.mul_scalar(d, float(np.asarray(hp[f"scale{li}"]).reshape(())))
        d = g.reshape(g.transpose(d, (0, 2, 3, 1)), (0, -1, 4))
        k = g.conv(t, hp["kps"]["kernel"], hp["kps"].get("bias"), pads=1,
                   wname="kps_w")
        k = g.reshape(g.transpose(k, (0, 2, 3, 1)),
                      (0, -1, cfg.num_kps * 2))
        scores.append(s)
        bboxes.append(d)
        kpss.append(k)

    io_types = {g.input_name: (1, ("batch", 3, "height", "width"))}
    for group, width in ((scores, 1), (bboxes, 4),
                         (kpss, cfg.num_kps * 2)):
        for li, name in enumerate(group):
            io_types[name] = (1, ("batch",
                                  f"anchors_s{cfg.strides[li]}", width))
    return g.finish(scores + bboxes + kpss, path, graph_name=cfg.name,
                    io_types=io_types)


def export_model(model, variables: Optional[Mapping] = None,
                 path: Optional[str] = None) -> bytes:
    """Dispatch on the model family (SCRFD vs the ArcFace trunks)."""
    cfg = model.config if isinstance(model, nn.Module) else model
    if hasattr(cfg, "strides"):
        return export_scrfd(model, variables, path)
    return export_arcface(model, variables, path)
