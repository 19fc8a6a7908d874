"""Config-from-graph inference: the model architecture read FROM ONNX bytes.

The port's copy of the JAX package's ``models/config_from_graph.py``. The
ordered importer (``models/onnx_import.py``) zips the model's parameters
against graph nodes and fails loudly on any shape mismatch, so it can only
load a file whose widths and depths the model's config matches. SCRFD
widths are NAS-derived (arXiv:2105.04714), not round numbers; this module
walks the graph topology and builds the ``SCRFDConfig`` / ``ArcFaceConfig``
from what the file contains:

- SCRFD (only the stride, anchor and output ordering is fixed): the
  deep-stem convs are the convs ahead of the MaxPool; backbone blocks parse
  from the conv grammar [3x3(s), 3x3, optional 1x1 down] with stage
  boundaries at stride-2 blocks; the PAFPN boundary is found from the
  Resize (nearest-upsample) nodes' lateral convs; the head is walked back
  from the 9 graph outputs (cls/box/kps branch convs, then the shared
  conv+GN tower), with the GroupNorm group count read from the
  InstanceNormalization lowering's scale width.
- iResNet (w600k_r50 kin): stem conv + [3x3, 3x3(s), optional 1x1 down]
  blocks, stages split at stride-2 blocks, emb_dim from the final Gemm.
- MobileFaceNet (w600k_mbf kin): stem / stem-dw / DepthWise-unit grammar
  ((1x1 expand, 3x3 grouped dw, 1x1 project)), stage splits at stride-2
  units, all widths read from the conv shapes.

``variables_from_onnx(path)`` is the one-call load path: infer the config,
build the port's model, run the ordered importer; the tree it returns is
what ``Detector(config=..., variables=...)`` and ``Embedder(...)`` take.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .onnx_proto import OnnxGraph, load_onnx


class ConfigInferenceError(ValueError):
    """The graph's structure does not match any supported family."""


@dataclasses.dataclass
class ConvSpec:
    """One (deduped) Conv node's shape facts, in first-use node order."""
    weight: str
    out: int
    cin: int           # total input channels (groups * per-group)
    kh: int
    kw: int
    stride: int
    groups: int
    idx: int           # index of the first node using this weight
    node: Any          # the OnnxNode


# Ops a data path may pass through when walking producer chains.
_PASSTHROUGH = {"Relu", "PRelu", "Sigmoid", "Cast", "Identity", "Clip",
                "Reshape", "Transpose", "Flatten", "Squeeze", "Unsqueeze",
                "Mul", "Add", "Div", "Sub", "BatchNormalization",
                "InstanceNormalization", "LeakyRelu", "MaxPool",
                "AveragePool"}
# Shape-computation ops: never contain the data path.
_SHAPEY = {"Shape", "Constant", "ConstantOfShape", "Gather", "Concat",
           "Slice", "Range", "Expand"}


def conv_specs(graph: OnnxGraph) -> List[ConvSpec]:
    """All Conv nodes with initializer weights, deduped by weight name at
    first use (weight-shared head towers appear once), in node order."""
    init = graph.initializers
    seen = set()
    out: List[ConvSpec] = []
    for idx, node in enumerate(graph.nodes):
        if node.op_type != "Conv" or len(node.inputs) < 2:
            continue
        wname = node.inputs[1]
        if wname not in init or wname in seen:
            continue
        seen.add(wname)
        w = init[wname]           # OIHW
        groups = int(node.attrs.get("group", 1))
        strides = node.attrs.get("strides", [1, 1])
        out.append(ConvSpec(
            weight=wname, out=int(w.shape[0]), cin=int(w.shape[1]) * groups,
            kh=int(w.shape[2]), kw=int(w.shape[3]),
            stride=int(strides[0] if strides else 1), groups=groups,
            idx=idx, node=node))
    return out


def _producers(graph: OnnxGraph) -> Dict[str, Any]:
    return {o: n for n in graph.nodes for o in n.outputs}


def _walk_back_to_conv(tensor: str, producers, init,
                       max_depth: int = 24) -> Optional[Any]:
    """DFS back through passthrough ops to the nearest Conv node; shape
    subgraphs (Constant/Gather/Shape chains) are dead ends."""
    stack = [(tensor, 0)]
    visited = set()
    while stack:
        t, d = stack.pop()
        if t in visited or d > max_depth or t in init:
            continue
        visited.add(t)
        n = producers.get(t)
        if n is None:
            continue
        if n.op_type == "Conv":
            return n
        if n.op_type in _SHAPEY:
            continue
        if n.op_type in _PASSTHROUGH:
            # depth-first, preferring the leading (data) input
            for inp in reversed(n.inputs):
                stack.append((inp, d + 1))
    return None


def _fwd_hits_instancenorm(tensor: str, consumers, max_depth: int = 4):
    """Does this conv output feed a GroupNorm lowering (possibly through a
    Reshape)? Returns the InstanceNormalization node or None."""
    frontier = [tensor]
    for _ in range(max_depth):
        nxt = []
        for t in frontier:
            for n in consumers.get(t, []):
                if n.op_type == "InstanceNormalization":
                    return n
                if n.op_type == "Reshape":
                    nxt.append(n.outputs[0])
        frontier = nxt
        if not frontier:
            break
    return None


def _const_tensor(t: str, producers, init) -> Optional[np.ndarray]:
    """Resolve a tensor name to a static array: an initializer, or a
    Constant node's value attribute (torch exports GN's InstanceNorm
    scale/bias as Constant nodes, not initializers)."""
    if t in init:
        return init[t]
    n = producers.get(t)
    if n is not None and n.op_type == "Constant":
        v = n.attrs.get("value")
        if isinstance(v, np.ndarray):
            return v
    return None


def _consumers(graph: OnnxGraph) -> Dict[str, List]:
    cons: Dict[str, List] = {}
    for n in graph.nodes:
        for t in n.inputs:
            cons.setdefault(t, []).append(n)
    return cons


def detect_family(graph: OnnxGraph) -> str:
    """'scrfd' | 'iresnet' | 'mobilefacenet' from gross graph structure."""
    if len(graph.outputs) >= 6:
        return "scrfd"
    if len(graph.outputs) != 1:
        raise ConfigInferenceError(
            f"unsupported output arity {len(graph.outputs)} (expected 1 "
            "embedding output or >=6 detector outputs)")
    if any(int(n.attrs.get("group", 1)) > 1 for n in graph.nodes
           if n.op_type == "Conv"):
        return "mobilefacenet"
    return "iresnet"


# ------------------------------------------------------------------ blocks


def _parse_res_blocks(specs: List[ConvSpec], strided_conv: int,
                      where: str) -> List[Dict[str, Any]]:
    """Parse a [3x3, 3x3, optional 1x1 down] residual-block grammar.

    strided_conv: which of the two 3x3 convs carries the block stride
    (0 for SCRFD/ResNetV1e conv1, 1 for iResNet conv2).
    """
    blocks = []
    i = 0
    while i < len(specs):
        if i + 1 >= len(specs):
            raise ConfigInferenceError(
                f"{where}: dangling conv {specs[i].weight} — not a "
                "2-conv residual block")
        c1, c2 = specs[i], specs[i + 1]
        if c1.kh != 3 or c2.kh != 3:
            raise ConfigInferenceError(
                f"{where}: block convs must be 3x3, got "
                f"{c1.kh}x{c1.kw} / {c2.kh}x{c2.kw} at conv {i}")
        stride = (c1, c2)[strided_conv].stride
        j = i + 2
        has_down = (j < len(specs) and specs[j].kh == 1
                    and specs[j].cin == c1.cin and specs[j].out == c2.out)
        if j < len(specs) and specs[j].kh == 1 and not has_down:
            raise ConfigInferenceError(
                f"{where}: 1x1 conv {specs[j].weight} does not match a "
                f"downsample ({specs[j].cin}->{specs[j].out} vs block "
                f"{c1.cin}->{c2.out})")
        blocks.append({"filters": c2.out, "stride": stride,
                       "down": has_down, "cin": c1.cin})
        i = j + (1 if has_down else 0)
    return blocks


def _split_stages(blocks: List[Dict[str, Any]], where: str,
                  first_stage_strided: bool) -> Tuple[Tuple[int, ...],
                                                      Tuple[int, ...]]:
    """Stage boundaries at stride-2 blocks. first_stage_strided: stage 1's
    block 0 is itself stride-2 (iResNet) vs stride-1 (SCRFD, which sits at
    stride 4 after the stem maxpool)."""
    stages: List[List[Dict]] = []
    for bi, b in enumerate(blocks):
        if bi == 0:
            want = 2 if first_stage_strided else 1
            if b["stride"] != want:
                raise ConfigInferenceError(
                    f"{where}: first block must be stride {want}, "
                    f"got {b['stride']}")
            stages.append([b])
        elif b["stride"] == 2:
            stages.append([b])
        elif b["stride"] == 1:
            stages[-1].append(b)
        else:
            raise ConfigInferenceError(
                f"{where}: unexpected block stride {b['stride']}")
    stage_blocks, stage_filters = [], []
    for si, st in enumerate(stages):
        f = {b["filters"] for b in st}
        if len(f) != 1:
            raise ConfigInferenceError(
                f"{where}: stage {si + 1} has mixed widths {sorted(f)}")
        stage_blocks.append(len(st))
        stage_filters.append(st[0]["filters"])
    return tuple(stage_blocks), tuple(stage_filters)


# ------------------------------------------------------------------- SCRFD


def infer_scrfd_config(graph: OnnxGraph, name: str = "scrfd_onnx"):
    """Derive a SCRFDConfig from graph topology (shapes + structure only;
    no width/depth assumptions)."""
    from .scrfd import SCRFDConfig

    specs = conv_specs(graph)
    if not specs:
        raise ConfigInferenceError("no Conv nodes with initializer weights")
    producers = _producers(graph)
    consumers = _consumers(graph)
    init = graph.initializers
    by_weight = {s.weight: s for s in specs}

    # --- neck laterals via the FPN top-down Resize/Upsample structure
    resizes = [n for n in graph.nodes
               if n.op_type in ("Resize", "Upsample")]
    if not resizes:
        raise ConfigInferenceError(
            "no Resize/Upsample nodes — not an FPN detector graph")
    lateral_w = set()
    for rz in resizes:
        c = _walk_back_to_conv(rz.inputs[0], producers, init, max_depth=4)
        if c is not None:
            lateral_w.add(c.inputs[1])
        for add in consumers.get(rz.outputs[0], []):
            if add.op_type != "Add":
                continue
            for other in add.inputs:
                if other == rz.outputs[0] or other in init:
                    continue
                c = _walk_back_to_conv(other, producers, init, max_depth=4)
                if c is not None:
                    lateral_w.add(c.inputs[1])
    laterals = [by_weight[w] for w in lateral_w if w in by_weight]
    if not laterals:
        raise ConfigInferenceError("could not locate FPN lateral convs")
    neck_out = {s.out for s in laterals}
    if len(neck_out) != 1:
        raise ConfigInferenceError(
            f"lateral convs disagree on neck width: {sorted(neck_out)}")
    neck_filters = neck_out.pop()
    boundary = min(s.idx for s in laterals)

    # --- backbone: stem convs precede the MaxPool; blocks follow
    maxpools = [i for i, n in enumerate(graph.nodes)
                if n.op_type == "MaxPool"]
    if not maxpools:
        raise ConfigInferenceError("no stem MaxPool — unsupported backbone")
    mp = maxpools[0]
    stem = [s for s in specs if s.idx < mp]
    body = [s for s in specs if mp < s.idx < boundary]
    if len(stem) != 3:
        raise ConfigInferenceError(
            f"expected a 3-conv deep stem ahead of the MaxPool, found "
            f"{len(stem)} convs — unsupported stem layout")
    if stem[0].cin != 3 or stem[0].stride != 2:
        raise ConfigInferenceError(
            f"stem conv is {stem[0].cin}ch stride {stem[0].stride}, "
            "expected 3ch stride 2")
    stem_filters = stem[2].out
    blocks = _parse_res_blocks(body, strided_conv=0, where="scrfd backbone")
    stage_blocks, stage_filters = _split_stages(
        blocks, "scrfd backbone", first_stage_strided=False)
    if len(stage_blocks) != 4:
        raise ConfigInferenceError(
            f"expected 4 backbone stages, found {len(stage_blocks)}")
    # the Flax ResBlock derives down-conv existence from (stride, widths);
    # verify the graph agrees so the ordered importer cannot desync
    for b in blocks:
        want_down = b["stride"] != 1 or b["cin"] != b["filters"]
        if b["down"] != want_down:
            raise ConfigInferenceError(
                "backbone downsample-conv placement does not match the "
                f"ResNetV1e rule at a {b['cin']}->{b['filters']} "
                f"stride-{b['stride']} block")

    # --- head: branch convs walked back from the graph outputs
    n_out = len(graph.outputs)
    if n_out % 3 != 0:
        raise ConfigInferenceError(f"{n_out} outputs, expected 3xL")
    levels = n_out // 3
    branch = []
    for oi in (0, levels, 2 * levels):      # [score x L, bbox x L, kps x L]
        c = _walk_back_to_conv(graph.outputs[oi], producers, init)
        if c is None:
            raise ConfigInferenceError(
                f"no conv feeds graph output {oi}")
        branch.append(by_weight[c.inputs[1]])
    cls_c, box_c, kps_c = branch
    num_anchors = cls_c.out
    if box_c.out != 4 * num_anchors or kps_c.out % (2 * num_anchors):
        raise ConfigInferenceError(
            f"head branch widths inconsistent: cls {cls_c.out} "
            f"box {box_c.out} kps {kps_c.out}")
    num_kps = kps_c.out // (2 * num_anchors)

    # --- head tower: walk back from the cls conv through conv+GN units
    tower: List[ConvSpec] = []
    t = cls_c.node.inputs[0]
    gn_groups = None
    for _ in range(16):
        c = _walk_back_to_conv(t, producers, init, max_depth=10)
        if c is None:
            raise ConfigInferenceError("head tower walk hit a dead end")
        spec = by_weight[c.inputs[1]]
        inorm = _fwd_hits_instancenorm(c.outputs[0], consumers)
        if inorm is None:
            break                    # reached the neck (bare conv, no GN)
        tower.append(spec)
        if gn_groups is None and len(inorm.inputs) > 1:
            scale = _const_tensor(inorm.inputs[1], producers, init)
            if scale is not None:
                gn_groups = int(scale.size)
        t = c.inputs[0]
    if not tower:
        raise ConfigInferenceError("no conv+GN tower ahead of the cls conv")
    head_stacks = len(tower)
    head_filters = tower[0].out
    if tower[-1].cin != neck_filters:
        raise ConfigInferenceError(
            f"head tower input width {tower[-1].cin} != neck width "
            f"{neck_filters}")

    strides = tuple(8 * (2 ** i) for i in range(levels))
    return SCRFDConfig(
        name=name, stem_filters=stem_filters, stage_blocks=stage_blocks,
        stage_filters=stage_filters, neck_filters=neck_filters,
        head_stacks=head_stacks, head_filters=head_filters,
        strides=strides, num_anchors=num_anchors, num_kps=num_kps,
        gn_groups=gn_groups or 16)


# ----------------------------------------------------------------- ArcFace


def _final_emb_dim(graph: OnnxGraph) -> int:
    init = graph.initializers
    gemms = [n for n in graph.nodes if n.op_type in ("Gemm", "MatMul")
             and len(n.inputs) > 1 and n.inputs[1] in init]
    if not gemms:
        raise ConfigInferenceError("no FC layer (Gemm/MatMul) found")
    g = gemms[-1]
    w = init[g.inputs[1]]
    transB = g.op_type == "Gemm" and bool(g.attrs.get("transB", 0))
    return int(w.shape[0] if transB else w.shape[1])


def infer_iresnet_config(graph: OnnxGraph, name: str = "iresnet_onnx"):
    from .arcface import ArcFaceConfig

    specs = conv_specs(graph)
    if not specs or specs[0].cin != 3 or specs[0].kh != 3:
        raise ConfigInferenceError("iresnet stem conv not found")
    blocks = _parse_res_blocks(specs[1:], strided_conv=1,
                               where="iresnet trunk")
    stage_blocks, stage_filters = _split_stages(
        blocks, "iresnet trunk", first_stage_strided=True)
    for b in blocks:
        want_down = b["stride"] != 1 or b["cin"] != b["filters"]
        if b["down"] != want_down:
            raise ConfigInferenceError(
                "iresnet downsample placement does not match the "
                f"IBasicBlock rule at a {b['cin']}->{b['filters']} "
                f"stride-{b['stride']} block")
    if blocks and blocks[0]["cin"] != specs[0].out:
        raise ConfigInferenceError(
            f"stem width {specs[0].out} does not feed the first block "
            f"({blocks[0]['cin']}ch)")
    return ArcFaceConfig(
        name=name, arch="iresnet", emb_dim=_final_emb_dim(graph),
        stage_blocks=stage_blocks, stage_filters=stage_filters)


def infer_mbf_config(graph: OnnxGraph, name: str = "mbf_onnx"):
    from .arcface import ArcFaceConfig

    specs = conv_specs(graph)
    if not specs or specs[0].cin != 3 or specs[0].stride != 2:
        raise ConfigInferenceError("mobilefacenet stem conv not found")
    stem = specs[0]
    i = 1
    stem_dw_groups = None
    stage0: List[Dict] = []
    if (i < len(specs) and specs[i].groups > 1 and specs[i].kh == 3
            and specs[i].stride == 1 and specs[i].cin == stem.out
            and specs[i].out == stem.out
            and (i + 1 >= len(specs) or specs[i + 1].kh == 1)):
        # a bare grouped 3x3 right after the stem, followed by a unit's
        # 1x1 expand: the blocks[0]==1 stem-dw form
        stem_dw_groups = specs[i].groups
        i += 1

    # DepthWise units: (1x1 expand, 3x3 grouped dw, 1x1 project)
    units: List[Dict] = []
    while i + 2 < len(specs):
        e, d, p = specs[i], specs[i + 1], specs[i + 2]
        if not (e.kh == 1 and e.groups == 1 and d.kh == 3 and d.groups > 1
                and p.kh == 1 and p.groups == 1):
            break
        units.append({"group": d.out, "stride": d.stride, "out": p.out})
        i += 3
    if stem_dw_groups is None:
        while units and units[0]["stride"] == 1:
            stage0.append(units.pop(0))
    if i >= len(specs) or specs[i].kh != 1:
        raise ConfigInferenceError("conv_sep (1x1) not found after units")
    sep = specs[i]
    i += 1
    if i >= len(specs) or specs[i].groups <= 1 or specs[i].kh < 4:
        raise ConfigInferenceError("GDC (grouped KxK) conv not found")
    gdc = specs[i]
    if gdc.groups != sep.out:
        raise ConfigInferenceError(
            f"GDC groups {gdc.groups} != conv_sep width {sep.out}")

    # segment units at stride-2 downs
    stages: List[Dict] = []
    for u in units:
        if u["stride"] == 2:
            stages.append({"down": u, "res": []})
        else:
            if not stages:
                raise ConfigInferenceError(
                    "stride-1 unit before the first downsample")
            stages[-1]["res"].append(u)
    if len(stages) != 3:
        raise ConfigInferenceError(
            f"expected 3 downsample stages, found {len(stages)}")
    res_groups = [stage0[0]["group"] if stage0 else 128]
    stage_filters, down_groups, blocks = [], [], []
    for st in stages:
        stage_filters.append(st["down"]["out"])
        down_groups.append(st["down"]["group"])
        rg = {u["group"] for u in st["res"]}
        if len(rg) > 1:
            raise ConfigInferenceError(
                f"mixed residual group widths in one stage: {sorted(rg)}")
        res_groups.append(rg.pop() if rg else down_groups[-1])
        blocks.append(len(st["res"]))
        for u in st["res"]:
            if u["out"] != st["down"]["out"]:
                raise ConfigInferenceError(
                    "residual unit width differs from its stage width")

    if stem_dw_groups is None and len(stage0) == 1:
        # mbf_blocks[0]==1 is reserved for the bare stem-dw conv form
        # (the released w600k_mbf shape); a stage0 of exactly one residual
        # DepthWise unit (3 convs) cannot be expressed by the config and
        # would desync the ordered importer deep inside the weight walk —
        # fail here, at the point the ambiguity is actually detectable
        raise ConfigInferenceError(
            "stage0 has exactly one residual DepthWise unit, which "
            "MobileFaceNet config cannot represent (blocks[0]==1 denotes "
            "the bare stem-dw conv form)")
    mbf_blocks = (1 if stem_dw_groups is not None else len(stage0),
                  *blocks)
    scale = stem.out // 64 if stem.out % 64 == 0 else 1
    return ArcFaceConfig(
        name=name, arch="mobilefacenet", emb_dim=_final_emb_dim(graph),
        mbf_blocks=mbf_blocks, mbf_scale=max(scale, 1),
        mbf_stem_filters=stem.out,
        mbf_stem_dw_groups=stem_dw_groups or 64,
        mbf_stage_filters=tuple(stage_filters),
        mbf_down_groups=tuple(down_groups),
        mbf_res_groups=tuple(res_groups),
        mbf_sep_filters=sep.out)


# ---------------------------------------------------------------- dispatch


def infer_config(graph: OnnxGraph, name: Optional[str] = None):
    """Family-dispatching config inference."""
    fam = detect_family(graph)
    if fam == "scrfd":
        return infer_scrfd_config(graph, name or "scrfd_onnx")
    if fam == "mobilefacenet":
        return infer_mbf_config(graph, name or "mbf_onnx")
    return infer_iresnet_config(graph, name or "iresnet_onnx")


def variables_from_onnx(path: str, name: Optional[str] = None,
                        input_size: Tuple[int, int] = (640, 640)):
    """One call: ONNX file -> (config, Flax-layout numpy variables).

    The architecture is inferred from the graph (never from a registry), so
    released files whose NAS widths differ from ``SCRFD_CONFIGS`` /
    ``ARCFACE_CONFIGS`` still load. The weights go through the ordered
    importer against the port's own model of that config, traced at
    ``input_size`` (detectors) or the embedder's 112 x 112.
    """
    from . import onnx_import as oi
    from .arcface import arcface_from_config
    from .scrfd import SCRFDNet

    graph = load_onnx(path)
    cfg = infer_config(graph, name=name)
    if hasattr(cfg, "strides"):                       # detector
        def build():
            return SCRFDNet(cfg)
        sample = (1, 3, *input_size)
    else:
        def build():
            return arcface_from_config(cfg)
        sample = (1, 3, *cfg.input_size)
    return cfg, oi.import_into_module(build, graph, sample)
