"""ONNX weight importer: ONNX files -> Flax-layout trees for the port's models.

The port's counterpart of the JAX package's ``models/onnx_import.py``: the
numpy parts (``extract_weight_sequences``, ``identity_bn``, the kernel
layout conversions) are copies, and the ordered walk of
``import_into_variables`` is the same walk with its loud failures and its
BatchNorm pairing and folding. It fills a tree of the layout the port's
``models/weights.py`` reads (``{"params", "batch_stats"}``, numpy f32,
paths = the port's submodule names), so ``Detector`` / ``Embedder`` take
the result as they take a Flax checkpoint.

Where the JAX package asks Flax and its graph executor, the port asks its
own model (``trace_module``, one forward on PyTorch's "meta" device, which
computes shapes only):

- the model's call order: a forward pre-hook on every submodule records
  when it is first called (the JAX package intercepts Flax methods);
- the (C, H, W) feature map that each dense layer's input was flattened
  from: the last 4-D submodule output before the layer's call (the JAX
  package infers the graph's shapes with its executor).

The template tree is the model's seeded init (``variables_from_module``);
the walk keeps a template leaf only where the graph has nothing for it,
the SCRFD head's per-level ``scale{li}`` when the graph carries no scalar
``Mul``: 1.0 in both packages' inits.

Conversion conventions:

- Conv W: ONNX OIHW -> Flax HWIO: transpose (2, 3, 1, 0); grouped convs
  keep the (H, W, I/g, O) layout after the same transpose.
- BatchNorm: scale/B -> params.{scale,bias}; mean/var -> batch_stats.
- PRelu slope (C,) or (C,1,1) -> PReLU alpha (C,).
- Gemm/MatMul after a flatten: ONNX flattens NCHW (c, h, w); the models
  flatten (h, w, c). The FC weight is re-permuted:
  W(out, C*H*W) -> reshape (out, C, H, W) -> transpose (2, 3, 1, 0)
  -> reshape (H*W*C, out).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .init_utils import seeded_init_
from .onnx_proto import OnnxGraph
from .weights import variables_from_module


def conv_kernel_to_flax(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def fc_kernel_to_flax(w: np.ndarray, chw: Tuple[int, int, int],
                      transB: bool = True) -> np.ndarray:
    """Gemm weight -> Dense kernel with NCHW->NHWC flatten fix.

    w: (out, C*H*W) if transB else (C*H*W, out); chw: the pre-flatten
    feature map shape (C, H, W).
    """
    c, h, wd = chw
    if not transB:
        w = w.T
    out = w.shape[0]
    return np.ascontiguousarray(
        w.reshape(out, c, h, wd).transpose(2, 3, 1, 0).reshape(h * wd * c, out))


def prelu_slope_to_flax(s: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(s.reshape(-1))


@dataclasses.dataclass
class _Extracted:
    """Weight bundles pulled from the graph in node order."""
    convs: List[Dict[str, np.ndarray]]
    bns: List[Dict[str, np.ndarray]]
    prelus: List[np.ndarray]
    gemms: List[Dict[str, np.ndarray]]
    gns: List[Dict[str, np.ndarray]] = dataclasses.field(default_factory=list)
    muls: List[np.ndarray] = dataclasses.field(default_factory=list)


def _bn_entry(init, node) -> Dict[str, np.ndarray]:
    return {
        "scale": init[node.inputs[1]].reshape(-1),
        "bias": init[node.inputs[2]].reshape(-1),
        "mean": init[node.inputs[3]].reshape(-1),
        "var": init[node.inputs[4]].reshape(-1),
    }


def identity_bn(channels: int, bias: Optional[np.ndarray] = None,
                eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """A BN that computes x + bias exactly (var chosen so var+eps == 1).

    Used when the graph's Conv carries a FOLDED batchnorm (onnxsim and the
    torchscript exporter both fuse Conv+BN in eval mode — the released
    files have far fewer BN nodes than the architectures have BN layers):
    the model's ConvBN then gets (folded kernel, identity BN with the
    conv's bias), which is numerically identical to the fused graph.
    """
    return {
        "scale": np.ones(channels, np.float32),
        "bias": (np.zeros(channels, np.float32) if bias is None
                 else np.asarray(bias, np.float32).reshape(-1)),
        "mean": np.zeros(channels, np.float32),
        "var": np.full(channels, 1.0 - eps, np.float32),
    }


def extract_weight_sequences(graph: OnnxGraph) -> _Extracted:
    """Collect Conv/BN/PRelu/Gemm weights in topological (node) order.

    - A weight initializer referenced by several nodes (e.g. the SCRFD head
      tower, traced once per FPN level) is collected once, at its FIRST
      use — matching a weight-shared Flax module, which also appears once.
    - A BatchNormalization whose input is a Conv/Gemm output is ATTACHED to
      that conv entry (`entry["bn"]`) and excluded from the standalone
      `bns` list; the importer pairs the model's ConvBN modules against
      conv entries (attached real BN, or an identity BN absorbing the
      folded conv's bias) and its free BNs against the standalone list.
    """
    init = graph.initializers
    convs, bns, prelus, gemms = [], [], [], []
    gns, muls = [], []
    seen = set()
    by_output: Dict[str, Dict] = {}   # conv/gemm output name -> entry

    # GroupNorm lowering (torch exporter): Reshape -> InstanceNormalization
    # -> Reshape -> Mul(scale (C,1,1)) -> Add(bias (C,1,1)). Pre-scan the
    # affine Mul/Add pairs so (a) GN params are importable and (b) those
    # Muls don't masquerade as FCOS-style per-level scalar scales.
    consumers: Dict[str, List] = {}
    for node in graph.nodes:
        for t in node.inputs:
            consumers.setdefault(t, []).append(node)
    gn_member_ids = set()
    seen_gn = set()
    for node in graph.nodes:
        if node.op_type != "InstanceNormalization":
            continue
        t = node.outputs[0]
        mul = None
        for _ in range(3):                       # skip reshapes
            nxt = consumers.get(t, [])
            if len(nxt) != 1:
                break
            if nxt[0].op_type == "Reshape":
                t = nxt[0].outputs[0]
                continue
            if nxt[0].op_type == "Mul":
                mul = nxt[0]
            break
        if mul is None:
            continue
        wname = next((i for i in mul.inputs if i in init), None)
        if wname is None:
            continue
        w = init[wname]
        add = next(iter(consumers.get(mul.outputs[0], [])), None)
        b = None
        if add is not None and add.op_type == "Add":
            b = next((init[i] for i in add.inputs if i in init), None)
        gn_member_ids.add(id(mul))
        if b is not None:
            gn_member_ids.add(id(add))
        if wname in seen_gn:   # weight-shared GN (head tower per FPN level)
            continue
        seen_gn.add(wname)
        gns.append({"scale": w.reshape(-1),
                    "bias": (b.reshape(-1) if b is not None
                             else np.zeros(w.size, np.float32))})

    for node in graph.nodes:
        if (node.op_type in ("Conv", "BatchNormalization", "PRelu", "Gemm",
                             "MatMul") and len(node.inputs) > 1):
            if node.inputs[1] in seen:
                continue
            seen.add(node.inputs[1])
        if node.op_type == "Conv":
            entry = {"kernel": conv_kernel_to_flax(init[node.inputs[1]]),
                     "group": int(node.attrs.get("group", 1))}
            if len(node.inputs) > 2 and node.inputs[2] in init:
                entry["bias"] = init[node.inputs[2]].reshape(-1)
            convs.append(entry)
            by_output[node.outputs[0]] = entry
        elif node.op_type == "BatchNormalization":
            owner = by_output.get(node.inputs[0])
            if owner is not None and "bn" not in owner:
                owner["bn"] = _bn_entry(init, node)
            else:
                bns.append(_bn_entry(init, node))
        elif node.op_type == "PRelu":
            prelus.append(prelu_slope_to_flax(init[node.inputs[1]]))
        elif node.op_type in ("Gemm", "MatMul"):
            w = init.get(node.inputs[1])
            if w is None:
                continue
            # Layout is explicit: Gemm's transB attribute; MatMul is always
            # (in, out). No shape guessing (the old disambiguation heuristic
            # mis-picked permutations for square layers).
            entry = {"weight": w,
                     "transB": (node.op_type == "Gemm"
                                and bool(node.attrs.get("transB", 0))),
                     "data_input": node.inputs[0]}
            if len(node.inputs) > 2 and node.inputs[2] in init:
                entry["bias"] = init[node.inputs[2]].reshape(-1)
            gemms.append(entry)
            by_output[node.outputs[0]] = entry
        elif node.op_type == "Mul" and id(node) not in gn_member_ids:
            w = next((init[i] for i in node.inputs if i in init), None)
            if w is not None and w.size == 1:
                # FCOS-style per-level scalar scale on the bbox branch
                muls.append(w.reshape(-1).astype(np.float32))
    return _Extracted(convs, bns, prelus, gemms, gns, muls)


def _flat_params_in_order(variables) -> List[Tuple[tuple, np.ndarray]]:
    """Flatten a variables collection preserving insertion (definition)
    order of flax's FrozenDict/dict."""
    out = []

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out.append((path, node))

    walk(variables, ())
    return out


class ImportError_(ValueError):
    pass


def trace_module(build: Callable[[], nn.Module], sample_shape: Tuple[int, ...]
                 ) -> Tuple[Dict[tuple, int], Dict[tuple, Tuple[int, int, int]]]:
    """One forward of ``build()`` on the "meta" device at ``sample_shape``
    (NCHW). Returns each submodule path's first-call position, and for each
    dense layer the (C, H, W) of the last 4-D submodule output before its
    call (the map its input was flattened from)."""
    with torch.device("meta"):
        model = build().eval()
    paths = {m: tuple(n.split(".")) if n else () for n, m in
             model.named_modules()}
    order: Dict[tuple, int] = {}
    dense_chw: Dict[tuple, Tuple[int, int, int]] = {}
    last_map: List[Optional[Tuple[int, int, int]]] = [None]

    def before(mod, args):
        p = paths[mod]
        if p and p not in order:
            order[p] = len(order)
        if isinstance(mod, nn.Linear) and last_map[0] is not None:
            dense_chw.setdefault(p, last_map[0])

    def after(mod, args, out):
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            last_map[0] = tuple(int(d) for d in out.shape[1:])

    handles = []
    try:
        for m in model.modules():
            handles.append(m.register_forward_pre_hook(before))
            handles.append(m.register_forward_hook(after))
        with torch.no_grad():
            model(torch.empty(sample_shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return order, dense_chw


def import_into_variables(variables: Dict[str, Any], graph: OnnxGraph,
                          module_order: Dict[tuple, int],
                          dense_chw: Dict[tuple, Tuple[int, int, int]]
                          ) -> Dict[str, Any]:
    """Fill a Flax-layout variables tree from an ONNX graph by ordered
    matching.

    The model's conv/bn/prelu/dense/groupnorm parameters (in
    ``module_order``, the forward's call order) are zipped against the
    graph's Conv/BN/PRelu/Gemm/GroupNorm weights (in node order). Raises
    ImportError_ with a precise location when counts or shapes mismatch:
    structural disagreement means the architecture does not correspond to
    the file, and silent corruption is never possible. ``dense_chw`` gives
    each dense layer's pre-flatten (C, H, W) (see ``trace_module``).
    """
    ex = extract_weight_sequences(graph)
    params = _flat_params_in_order(variables.get("params", variables))
    stats = _flat_params_in_order(variables.get("batch_stats", {}))

    # group our parameters by module (the path minus the leaf name)
    new_params: Dict[tuple, np.ndarray] = {}
    new_stats: Dict[tuple, np.ndarray] = {}

    conv_i = bn_i = prelu_i = gemm_i = gn_i = mul_i = 0
    by_module: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, arr in params:
        by_module.setdefault(path[:-1], {})[path[-1]] = arr
    stats_by_module: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, arr in stats:
        stats_by_module.setdefault(path[:-1], {})[path[-1]] = arr

    def fail(msg):
        raise ImportError_(msg)

    # match in the model's forward-call order (== graph node order for a
    # faithful architecture), not alphabetical path order
    items = sorted(by_module.items(),
                   key=lambda kv: (module_order.get(
                       kv[0], len(module_order)), kv[0]))
    # BN pairing state: a conv/gemm deposits its attached (or synthesized
    # identity) BN here; the NEXT model BN module consumes it. Model BNs
    # with nothing pending consume the standalone-BN sequence.
    pending_bn: Optional[Dict[str, np.ndarray]] = None
    pending_real = False

    for mod_path, leaves in items:
        if "kernel" in leaves and leaves["kernel"].ndim == 4:      # conv
            if conv_i >= len(ex.convs):
                fail(f"model has more convs than graph at {mod_path}")
            if pending_real:
                fail(f"graph BN after previous conv was never consumed "
                     f"(model conv at {'/'.join(mod_path)} follows it)")
            src = ex.convs[conv_i]
            conv_i += 1
            kernel = src["kernel"]
            if tuple(kernel.shape) != tuple(leaves["kernel"].shape):
                fail(f"conv shape mismatch at {'/'.join(mod_path)}: "
                     f"onnx {kernel.shape} vs model "
                     f"{leaves['kernel'].shape}")
            new_params[mod_path + ("kernel",)] = kernel
            if "bias" in leaves:
                bias = src.get("bias", np.zeros(leaves["bias"].shape, np.float32))
                new_params[mod_path + ("bias",)] = bias
                pending_bn = src.get("bn")
                pending_real = pending_bn is not None
            else:
                # bias-free model conv (ConvBN unit): pair with the graph
                # conv's attached BN, or synthesize the identity BN that
                # carries a folded conv's bias
                pending_bn = src.get("bn")
                if pending_bn is not None and src.get("bias") is not None:
                    # unfused Conv(bias) -> BN: BN(conv + b) == BN with
                    # running mean shifted by -b — fold it, never drop it
                    pending_bn = dict(pending_bn)
                    pending_bn["mean"] = (
                        np.asarray(pending_bn["mean"], np.float32)
                        - np.asarray(src["bias"], np.float32).reshape(-1))
                if pending_bn is None:
                    pending_bn = identity_bn(kernel.shape[-1],
                                             src.get("bias"))
                pending_real = "bn" in src
        elif "kernel" in leaves and leaves["kernel"].ndim == 2:    # dense
            if gemm_i >= len(ex.gemms):
                fail(f"model has more dense layers than graph at {mod_path}")
            if pending_real:
                fail(f"graph BN after previous conv/gemm was never consumed "
                     f"(model dense at {'/'.join(mod_path)} follows it)")
            src = ex.gemms[gemm_i]
            gemm_i += 1
            w = src["weight"]
            if src["transB"]:
                w = w.T                                 # normalize to (in, out)
            chw = dense_chw.get(mod_path)
            if chw is not None and w.shape[0] == int(np.prod(chw)) \
                    and chw[1] * chw[2] > 1:
                # NCHW-flatten ahead of this layer: permute rows to the
                # model's NHWC flatten order.
                kernel = fc_kernel_to_flax(w.T, chw, transB=True)
            else:
                kernel = w
            if kernel.shape != leaves["kernel"].shape:
                fail(f"dense shape mismatch at {'/'.join(mod_path)}: "
                     f"{kernel.shape} vs {leaves['kernel'].shape}")
            new_params[mod_path + ("kernel",)] = kernel
            if "bias" in leaves:
                new_params[mod_path + ("bias",)] = src.get(
                    "bias", np.zeros(leaves["bias"].shape, np.float32))
                pending_bn = src.get("bn")
                pending_real = pending_bn is not None
            else:
                pending_bn = src.get("bn")
                if pending_bn is not None and src.get("bias") is not None:
                    # Gemm(bias) -> BN: same mean -= bias fold as convs
                    pending_bn = dict(pending_bn)
                    pending_bn["mean"] = (
                        np.asarray(pending_bn["mean"], np.float32)
                        - np.asarray(src["bias"], np.float32).reshape(-1))
                if pending_bn is None:
                    pending_bn = identity_bn(kernel.shape[-1],
                                             src.get("bias"))
                pending_real = "bn" in src
        elif "alpha" in leaves:                                    # prelu
            if prelu_i >= len(ex.prelus):
                fail(f"model has more PReLUs than graph at {mod_path}")
            slope = ex.prelus[prelu_i]
            prelu_i += 1
            if slope.shape != leaves["alpha"].shape:
                fail(f"prelu shape mismatch at {'/'.join(mod_path)}")
            new_params[mod_path + ("alpha",)] = slope
        elif "scale" in leaves and mod_path in stats_by_module:    # batchnorm
            if pending_bn is not None:
                src = pending_bn
                pending_bn = None
                pending_real = False
            else:
                if bn_i >= len(ex.bns):
                    fail(f"model has more BNs than graph at {mod_path}")
                src = ex.bns[bn_i]
                bn_i += 1
            if src["scale"].shape != leaves["scale"].shape:
                fail(f"bn shape mismatch at {'/'.join(mod_path)}: "
                     f"onnx {src['scale'].shape} vs model "
                     f"{leaves['scale'].shape}")
            new_params[mod_path + ("scale",)] = src["scale"]
            new_params[mod_path + ("bias",)] = src["bias"]
            new_stats[mod_path + ("mean",)] = src["mean"]
            new_stats[mod_path + ("var",)] = src["var"]
        elif ("scale" in leaves and "bias" in leaves
              and leaves["scale"].ndim == 1
              and leaves["scale"].size > 1):                       # groupnorm
            if gn_i >= len(ex.gns):
                fail(f"model has more GroupNorms than graph at {mod_path}")
            src = ex.gns[gn_i]
            gn_i += 1
            if src["scale"].shape != leaves["scale"].shape:
                fail(f"groupnorm shape mismatch at {'/'.join(mod_path)}: "
                     f"onnx {src['scale'].shape} vs model "
                     f"{leaves['scale'].shape}")
            new_params[mod_path + ("scale",)] = src["scale"]
            new_params[mod_path + ("bias",)] = src["bias"]
        else:                                                      # misc
            for leaf, arr in sorted(leaves.items()):
                arr = np.asarray(arr)
                if (leaf.startswith("scale") and arr.size == 1
                        and mul_i < len(ex.muls)):
                    # FCOS per-level scale, consumed in level order
                    new_params[mod_path + (leaf,)] = \
                        ex.muls[mul_i].reshape(arr.shape)
                    mul_i += 1
                else:
                    new_params[mod_path + (leaf,)] = arr

    if pending_real:
        # the LAST matched conv/gemm carried a real attached graph BN that
        # no model BN consumed — only the conv-follows-conv case catches
        # this mid-loop; catch the tail case here or the BN params are
        # silently dropped (import "succeeds" with wrong outputs)
        fail("graph BN attached to the final conv/gemm was never consumed "
             "(architecture mismatch)")
    leftovers = [(n, used, len(seq)) for n, used, seq in [
        ("conv", conv_i, ex.convs), ("bn", bn_i, ex.bns),
        ("prelu", prelu_i, ex.prelus), ("gemm", gemm_i, ex.gemms),
        ("groupnorm", gn_i, ex.gns), ("mul", mul_i, ex.muls)]
        if used != len(seq)]
    if leftovers:
        fail("graph weights left unconsumed (architecture mismatch): "
             + ", ".join(f"{n} {u}/{t}" for n, u, t in leftovers))

    def rebuild(tree, table, prefix=()):
        out = {}
        for k, v in tree.items():
            p = prefix + (k,)
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = rebuild(v, table, p)
            else:
                out[k] = np.asarray(table.get(p, v), np.float32)
        return out

    result = {"params": rebuild(variables["params"], new_params)}
    if "batch_stats" in variables:
        result["batch_stats"] = rebuild(variables["batch_stats"], new_stats)
    return result


def import_into_module(build: Callable[[], nn.Module], graph: OnnxGraph,
                       sample_shape: Tuple[int, ...]) -> Dict[str, Any]:
    """The port's model ``build()`` (seeded init as the template, traced at
    ``sample_shape``, NCHW) filled from ``graph``: a Flax-layout numpy
    tree."""
    template = variables_from_module(seeded_init_(build(), 0))
    order, dense_chw = trace_module(build, sample_shape)
    return import_into_variables(template, graph, module_order=order,
                                 dense_chw=dense_chw)
