"""ONNX graph executor: a parsed graph run op by op in PyTorch.

The second weight path beside the importer (``config_from_graph.py``,
``onnx_import.py``): the released ``.onnx`` graph is the model, every node
a PyTorch op, so nothing depends on a hand-written architecture matching
the file. Counterpart of the JAX package's ``models/onnx_exec.py``.

- Layout: ONNX's own NCHW throughout. The input is NCHW, the outputs come
  in declared order, float32.
- Load time: every node becomes a ready step (attributes, pads and the
  op's branch parsed once). Initializers become non-persistent buffers on
  the device; the weights of Conv, BatchNormalization, InstanceNormalization,
  PRelu and Gemm are prepared for their node once, rounded to the compute
  dtype as the JAX executor rounds them on every call.
- Constant folding: ``Shape`` gives numpy, and a node whose inputs are all
  numpy runs in numpy (``_fold_numpy``), so shape chains (Shape -> Gather
  -> Unsqueeze -> Concat -> Reshape) never become device ops. Reshape,
  Slice, Expand, Resize, Split and the reductions read their structural
  inputs from numpy (``_static``); a value that lives on the device there
  raises ``UnsupportedOp``, as a traced value does under ``jax.jit``. A
  numpy constant that meets a device op is copied to the device once and
  kept, so a warm forward makes no host-device sync.
- Numerics follow the JAX executor (the reference), not the port's native
  bf16 layers: Conv runs without its bias and adds it afterwards in the
  compute dtype; BatchNormalization is ``x * inv + add`` in the compute
  dtype from float32 ``inv`` / ``add``; InstanceNormalization computes in
  its input's dtype; Gemm is ``alpha * (a @ b) + beta * C``. At float32 the
  convolutions and matmuls run without TF32 (the JAX executor's
  ``Precision.HIGHEST``). Values keep JAX's promotion: a float32 constant
  that meets a bfloat16 activation promotes it, except where the JAX
  executor casts the constant first, which is where a conv-family output
  (``_MAPS``) meets a scalar or a per-channel constant.
- Inference semantics: BatchNormalization uses its stored statistics,
  Dropout is identity.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import full_f32_matmul, resolve_device
from .onnx_proto import TENSOR_DTYPES, OnnxGraph, OnnxNode, load_onnx


class UnsupportedOp(ValueError):
    pass


# Every op type the executor can run; models/preflight.py scans release
# files against this set. The same 55 names as the JAX executor's.
SUPPORTED_OPS = frozenset({
    "Conv", "BatchNormalization", "InstanceNormalization", "PRelu",
    "Relu", "LeakyRelu", "Sigmoid", "Exp", "Tanh", "Sqrt", "Neg", "Abs",
    "Softplus", "Erf", "HardSigmoid", "HardSwish", "Identity", "Dropout",
    "Add", "Sub", "Mul", "Div", "Pow", "Min", "Max", "Concat", "Constant",
    "MaxPool", "AveragePool", "GlobalAveragePool", "Resize", "Upsample",
    "Shape", "Reshape", "Flatten", "Squeeze", "Unsqueeze", "Transpose",
    "Slice", "Gather", "Split", "Expand", "Softmax", "ReduceMean",
    "ReduceSum", "Cast", "Clip", "MatMul", "Gemm", "Where", "Equal",
    "Greater", "Less", "ConstantOfShape", "Range",
})

# Ops whose output the JAX executor keeps in its conv layout; a binary op
# between such a map and a scalar or per-channel constant casts the
# constant to the compute dtype there (the "nhwc" tag of the JAX executor)
_MAPS = frozenset({"Conv", "MaxPool", "AveragePool", "GlobalAveragePool",
                   "Resize", "Upsample"})
_KEEP_MAP = frozenset({"BatchNormalization", "PRelu", "Relu", "LeakyRelu",
                       "Sigmoid", "Exp", "Tanh", "Sqrt", "Neg", "Abs",
                       "Softplus", "Erf", "HardSigmoid", "HardSwish",
                       "Identity", "Dropout"})
_BINARY = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
           "Div": torch.div, "Pow": torch.pow, "Min": torch.minimum,
           "Max": torch.maximum}
_INT_MAX = 2 ** 31


def _pair(v, default=(1, 1)):
    if v is None:
        return default
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v))
    return tuple(int(i) for i in v)


def _resolve_pads(attrs, in_hw, kernel, strides, dilations):
    """((top, bottom), (left, right)) honoring ONNX auto_pad.

    NOTSET -> explicit 'pads' [t, l, b, r]; VALID -> zero;
    SAME_UPPER/SAME_LOWER -> pad so out = ceil(in/stride), extra on the
    end/begin side respectively (ONNX Conv spec).
    """
    auto = attrs.get("auto_pad", b"NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    if auto in ("NOTSET", ""):
        pads = attrs.get("pads", [0, 0, 0, 0])
        if isinstance(pads, (int, np.integer)):
            pads = [int(pads)] * 4
        return ((int(pads[0]), int(pads[2])), (int(pads[1]), int(pads[3])))
    if auto == "VALID":
        return ((0, 0), (0, 0))
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for size, k, s, d in zip(in_hw, kernel, strides, dilations):
            eff_k = (k - 1) * d + 1
            n_out = -(-int(size) // s)
            total = max((n_out - 1) * s + eff_k - int(size), 0)
            small, big = total // 2, total - total // 2
            out.append((small, big) if auto == "SAME_UPPER"
                       else (big, small))
        return tuple(out)
    raise UnsupportedOp(f"auto_pad={auto!r}")


def _const(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _canonical(a) -> np.ndarray:
    """A numpy value as the JAX package hands it to the device (64-bit
    floats become float32: JAX runs without x64)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(_canonical(np.zeros(0, np_dtype))).dtype


def _promote(*ts: torch.Tensor) -> List[torch.Tensor]:
    """The operands in their common dtype, by dtype alone: a 0-d float32
    constant promotes a bfloat16 activation, as a numpy constant does in
    JAX (PyTorch itself would keep bfloat16 for a 0-d operand)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _slice(x, axis: int, start, end, step: int):
    """x[start:end:step] along ``axis`` with Python's semantics, negative
    steps included (PyTorch slicing takes positive steps only)."""
    lead = (slice(None),) * axis
    if step > 0:
        return x[lead + (slice(start, end, step),)]
    idx = range(*slice(start, end, step).indices(x.shape[axis]))
    if not len(idx):
        return x.narrow(axis, 0, 0)
    j0 = x.shape[axis] - 1 - idx.start
    return x.flip(axis)[lead + (slice(j0, j0 + len(idx) * -step, -step),)]


class _Run:
    """One forward's state: the environment (numpy constants and device
    tensors), the conv-layout names and the buffers in use."""

    __slots__ = ("env", "maps", "bufs", "device", "shapes")

    def __init__(self, env, bufs, device, shapes):
        self.env = env
        self.maps: Set[str] = set()
        self.bufs = bufs
        self.device = device
        self.shapes = shapes


class OnnxModel(nn.Module):
    """One ONNX graph as an ``nn.Module``.

    >>> m = onnx_model("det_10g.onnx", dtype=torch.bfloat16)
    >>> outs = m(x_nchw)                  # list of float32, declared order

    ``dtype`` is the compute dtype (float32 or bfloat16); the model lives
    on ``device``: the CUDA card unless ``device="cpu"`` is passed.
    """

    def __init__(self, graph: OnnxGraph, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        self.device = resolve_device(device)
        self.graph = graph
        self.dtype = dtype
        self.input_name = self._data_input()
        self._inits = graph.initializers
        self._weights: Dict[str, str] = {}      # initializer -> buffer key
        self._nbuf = 0
        self._consts: Dict[tuple, Tuple[np.ndarray, torch.Tensor]] = {}
        self._counts: Dict[tuple, torch.Tensor] = {}
        self._steps: List[Callable[[_Run], None]] = []
        for node in graph.nodes:
            self._steps.append(self._compile(node))
        self.to(self.device)

    # ----------------------------------------------------------- helpers

    def _data_input(self) -> str:
        for name in self.graph.inputs:
            if name not in self.graph.initializers:
                return name
        raise ValueError("graph has no non-initializer input")

    def _buffer(self, t: torch.Tensor) -> str:
        key = f"b{self._nbuf}"
        self._nbuf += 1
        self.register_buffer(key, t.contiguous(), persistent=False)
        return key

    def _weight(self, name: str) -> str:
        """The buffer of initializer ``name`` as the file stores it."""
        if name not in self._weights:
            arr = _canonical(self._inits[name])
            self._weights[name] = self._buffer(torch.from_numpy(arr.copy()))
        return self._weights[name]

    def _prepared(self, name: str, fn=None, dtype=None) -> str:
        """A buffer made once from initializer ``name``: ``fn`` of its
        float32 tensor, then cast to ``dtype``; the file's own buffer
        when that changes nothing."""
        self._handled.add(name)
        if fn is None and (dtype is None or _torch_dtype(
                self._inits[name].dtype) == dtype):
            return self._weight(name)
        t = torch.from_numpy(_canonical(self._inits[name]).copy())
        if fn is not None:
            t = fn(t.float())
        return self._buffer(t if dtype is None else t.to(dtype))

    def _static(self, run: _Run, name: str) -> Optional[np.ndarray]:
        """An input that must be known on the host (a Reshape target,
        Slice indices, Resize scales, reduce axes): from the parsed
        initializers or a numpy value; None when it lives on the device."""
        if not name:
            return None
        if name in self._inits:
            return self._inits[name]
        v = run.env.get(name)
        return np.asarray(v) if _const(v) else None

    def _static_req(self, run: _Run, name: str, node: OnnxNode) -> np.ndarray:
        v = self._static(run, name)
        if v is None:
            raise UnsupportedOp(
                f"{node.op_type} (node {node.name}): input {name!r} must be "
                "a static shape/index tensor but is data-dependent")
        return v

    def _tensor(self, run: _Run, name: str,
                dtype: Optional[torch.dtype] = None
                ) -> Optional[torch.Tensor]:
        """Input ``name`` as a tensor on the run's device (in ``dtype`` when
        given); a numpy value is copied there once and kept (a small one
        by its value, so shapes that alternate keep theirs; a large one
        while its value stays the same)."""
        if not name:
            return None
        v = run.env[name]
        if isinstance(v, torch.Tensor):
            return v if dtype is None else v.to(dtype)
        v = np.asarray(v)
        small = v.size <= 64
        key = (name, str(run.device), dtype, v.dtype.str, v.shape,
               v.tobytes() if small else None)
        hit = self._consts.get(key)
        if hit is not None and (small or hit[0] is v
                                or np.array_equal(hit[0], v)):
            return hit[1]
        t = torch.from_numpy(np.array(_canonical(v)))
        t = t.to(device=run.device, dtype=dtype or t.dtype)
        self._consts[key] = (v, t)
        return t

    # ------------------------------------------------------------ forward

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, C, H, W) -> the graph's outputs in declared order."""
        if self.dtype != torch.float32 or x.device.type != "cuda":
            return self._run(x, self._buffers, None)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with full_f32_matmul():
                return self._run(x, self._buffers, None)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    def _run(self, x, bufs, shapes) -> List[torch.Tensor]:
        env = {n: bufs[k] for n, k in self._weights.items()}
        env[self.input_name] = x.to(self.dtype)
        run = _Run(env, bufs, x.device, shapes)
        run.maps.add(self.input_name)
        for step in self._steps:
            step(run)
        outs = []
        for name in self.graph.outputs:
            v = env[name]
            outs.append(v.float() if isinstance(v, torch.Tensor)
                        else self._tensor(run, name))
        return outs

    def trace_shapes(self, input_shape: Sequence[int]) -> Dict[str, Tuple]:
        """Every node output's shape for an NCHW input of ``input_shape``,
        from a forward on the "meta" device (nothing is computed)."""
        shapes: Dict[str, Tuple] = {}
        bufs = {k: v.to("meta") for k, v in self._buffers.items()}
        x = torch.empty(tuple(input_shape), dtype=torch.float32,
                        device="meta")
        self._run(x, bufs, shapes)
        return shapes

    # ----------------------------------------------------------- compile

    def _compile(self, node: OnnxNode) -> Callable[[_Run], None]:
        op = node.op_type
        ins, outs = list(node.inputs), list(node.outputs)
        if op not in SUPPORTED_OPS:
            def unsupported(run):
                raise UnsupportedOp(f"{op} (node {node.name})")
            return unsupported
        if op == "Constant":
            value = self._constant_value(node)

            def constant(run):
                run.env[outs[0]] = value
                if run.shapes is not None:
                    run.shapes[outs[0]] = tuple(np.shape(value))
            return constant
        self._handled = set()
        body = getattr(self, "_c_" + op, None)
        body = body(node) if body is not None else self._generic(node)
        # the initializers the step reads as they are, from the run's env
        for i in ins:
            if i in self._inits and i not in self._handled:
                self._weight(i)
        # a node whose inputs are all numpy runs in numpy (not Conv, and
        # never on an initializer, which lives on the device)
        foldable = (op != "Conv" and bool(ins)
                    and not any(i in self._inits for i in ins))

        def step(run):
            env = run.env
            if foldable and all(i == "" or _const(env[i]) for i in ins):
                folded = self._fold_numpy(node, env)
                if folded is not None:
                    for o, v in zip(outs, folded):
                        env[o] = np.asarray(v)
                    if run.shapes is not None:
                        for o in outs:
                            run.shapes[o] = tuple(np.shape(env[o]))
                    return
            body(run)
            if op in _MAPS or (op in _KEEP_MAP and ins[0] in run.maps):
                run.maps.add(outs[0])
            if run.shapes is not None:
                for o in outs:
                    if o in env:
                        run.shapes[o] = tuple(np.shape(env[o]))
        return step

    @staticmethod
    def _constant_value(node: OnnxNode) -> np.ndarray:
        if "value" not in node.attrs:
            raise UnsupportedOp(f"Constant (node {node.name}) without a "
                                "tensor value")
        return np.asarray(node.attrs["value"])

    # Conv and the normalizations: their weights prepared at load

    def _c_Conv(self, node):
        ins, out, attrs = node.inputs, node.outputs[0], node.attrs
        groups = int(attrs.get("group", 1))
        strides = _pair(attrs.get("strides"))
        dil = _pair(attrs.get("dilations"))
        w_key = (self._prepared(ins[1], dtype=self.dtype)
                 if ins[1] in self._inits else None)
        b_name = ins[2] if len(ins) > 2 and ins[2] else None
        b_key = (self._prepared(b_name, fn=lambda t: t.reshape(1, -1, 1, 1),
                                dtype=self.dtype)
                 if b_name in self._inits else None)

        def conv(run):
            x = self._tensor(run, ins[0], self.dtype)
            w = (run.bufs[w_key] if w_key is not None
                 else self._tensor(run, ins[1], self.dtype))
            (pt, pb), (pl, pr) = _resolve_pads(
                attrs, x.shape[2:4], w.shape[2:4], strides, dil)
            if pt == pb and pl == pr:
                pad = (pt, pl)
            else:
                x, pad = F.pad(x, (pl, pr, pt, pb)), (0, 0)
            y = F.conv2d(x, w, None, strides, pad, dil, groups)
            if b_name is not None:
                b = (run.bufs[b_key] if b_key is not None else self._tensor(
                    run, b_name, self.dtype).reshape(1, -1, 1, 1))
                y = y + b
            run.env[out] = y
        return conv

    def _c_BatchNormalization(self, node):
        ins, out = node.inputs, node.outputs[0]
        eps = float(node.attrs.get("epsilon", 1e-5))

        def inv_add(scale, bias, mean, var):
            k = scale / torch.sqrt(var + eps)
            return k, bias - mean * k

        keys = None
        if all(i in self._inits for i in ins[1:5]):
            self._handled.update(ins[1:5])
            arrs = [torch.from_numpy(_canonical(self._inits[i]).astype(
                np.float32)) for i in ins[1:5]]
            k, a = inv_add(*arrs)
            keys = (self._buffer(k.to(self.dtype)),
                    self._buffer(a.to(self.dtype)))

        def bn(run):
            x = self._tensor(run, ins[0])
            if keys is not None:
                k, a = run.bufs[keys[0]], run.bufs[keys[1]]
            else:
                k, a = inv_add(*(self._tensor(run, i).float()
                                 for i in ins[1:5]))
                k, a = k.to(self.dtype), a.to(self.dtype)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            x, k, a = _promote(x, k.reshape(shape), a.reshape(shape))
            run.env[out] = x * k + a
        return bn

    def _c_InstanceNormalization(self, node):
        ins, out = node.inputs, node.outputs[0]
        eps = float(node.attrs.get("epsilon", 1e-5))

        def inorm(run):
            x = self._tensor(run, ins[0])
            axes = tuple(range(2, x.dim()))
            mean = x.mean(axes, keepdim=True)
            var = (x - mean).square().mean(axes, keepdim=True)
            y = (x - mean) * torch.rsqrt(var + eps)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            s = self._tensor(run, ins[1], self.dtype).reshape(shape)
            b = self._tensor(run, ins[2], self.dtype).reshape(shape)
            y, s, b = _promote(y, s, b)
            run.env[out] = y * s + b
        return inorm

    def _c_PRelu(self, node):
        ins, out = node.inputs, node.outputs[0]
        key = (self._prepared(ins[1], fn=lambda t: t.reshape(-1),
                              dtype=self.dtype)
               if ins[1] in self._inits else None)

        def prelu(run):
            x = self._tensor(run, ins[0])
            s = (run.bufs[key] if key is not None else
                 self._tensor(run, ins[1], self.dtype).reshape(-1))
            s = s.reshape((1, -1) + (1,) * (x.dim() - 2) if x.dim() > 1
                          else (-1,))
            s, x = _promote(s, x)
            run.env[out] = torch.where(x >= 0, x, s * x)
        return prelu

    def _c_Gemm(self, node):
        return self._matmul(node)

    def _c_MatMul(self, node):
        return self._matmul(node)

    def _matmul(self, node):
        ins, out, attrs = node.inputs, node.outputs[0], node.attrs
        gemm = node.op_type == "Gemm"
        trans_a = gemm and bool(int(attrs.get("transA", 0)))
        trans_b = gemm and bool(int(attrs.get("transB", 0)))
        alpha = float(attrs.get("alpha", 1.0))
        beta = float(attrs.get("beta", 1.0))
        b_key = (self._prepared(ins[1], dtype=self.dtype)
                 if ins[1] in self._inits else None)
        c_name = ins[2] if gemm and len(ins) > 2 and ins[2] else None
        c_key = (self._prepared(c_name, dtype=self.dtype)
                 if c_name in self._inits else None)

        def matmul(run):
            a = self._tensor(run, ins[0], self.dtype)
            b = (run.bufs[b_key] if b_key is not None
                 else self._tensor(run, ins[1], self.dtype))
            if not gemm:
                run.env[out] = torch.matmul(a, b)
                return
            if trans_a:
                a = a.T
            y = F.linear(a, b) if trans_b else a @ b
            y = y * alpha
            if c_name is not None:
                c = (run.bufs[c_key] if c_key is not None
                     else self._tensor(run, c_name, self.dtype))
                y = y + beta * c
            run.env[out] = y
        return matmul

    # element-wise

    def _generic(self, node):
        op = node.op_type
        if op in _BINARY:
            return self._binary(node)
        if op in _KEEP_MAP:
            return self._unary(node)
        return getattr(self, "_r_" + op)(node)

    def _unary(self, node):
        op, ins, out, attrs = (node.op_type, node.inputs, node.outputs[0],
                               node.attrs)
        alpha = float(attrs.get("alpha", 0.01 if op == "LeakyRelu" else 0.2))
        beta = float(attrs.get("beta", 0.5))
        fn = {
            "Relu": lambda v: torch.clamp_min(v, 0),
            "LeakyRelu": lambda v: torch.where(v >= 0, v, alpha * v),
            "Sigmoid": torch.sigmoid, "Exp": torch.exp, "Tanh": torch.tanh,
            "Sqrt": torch.sqrt, "Neg": torch.neg, "Abs": torch.abs,
            "Softplus": lambda v: torch.logaddexp(v, torch.zeros_like(v)),
            "Erf": torch.erf,
            "HardSigmoid": lambda v: torch.clamp(alpha * v + beta, 0, 1),
            "HardSwish": lambda v: v * torch.clamp(v / 6 + 0.5, 0, 1),
            "Identity": lambda v: v, "Dropout": lambda v: v,
        }[op]

        def unary(run):
            v = run.env[ins[0]]
            # Identity and Dropout pass a numpy constant on as it is
            run.env[out] = (v if op in ("Identity", "Dropout") and _const(v)
                            else fn(self._tensor(run, ins[0])))
        return unary

    def _binary(self, node):
        ins, out = node.inputs, node.outputs[0]
        fn = _BINARY[node.op_type]

        def binary(run):
            a, b = run.env[ins[0]], run.env[ins[1]]
            am, bm = ins[0] in run.maps, ins[1] in run.maps
            if am != bm:
                # the JAX executor's conv layout meets a constant: a scalar
                # or per-channel factor is cast to the compute dtype there
                nh, other = (a, ins[1]) if am else (b, ins[0])
                rs = tuple(np.shape(run.env[other]))
                c = nh.shape[1]
                scalar = all(d == 1 for d in rs)
                chan = ((len(rs) == 1 and rs[0] == c)
                        or (len(rs) >= 2 and rs[1] == c and all(
                            d == 1 for i, d in enumerate(rs) if i != 1)))
                if scalar or chan:
                    vec = self._tensor(run, other, self.dtype)
                    if scalar:
                        vec = vec.reshape(())
                    run.env[out] = fn(nh, vec) if am else fn(vec, nh)
                    run.maps.add(out)
                    return
            elif am:
                run.env[out] = fn(a, b)
                run.maps.add(out)
                return
            x, y = _promote(self._tensor(run, ins[0]),
                            self._tensor(run, ins[1]))
            run.env[out] = fn(x, y)
        return binary

    def _c_Concat(self, node):
        ins, out = node.inputs, node.outputs[0]
        axis = int(node.attrs.get("axis", 0))

        def concat(run):
            parts = _promote(*(self._tensor(run, i) for i in ins if i))
            run.env[out] = torch.cat(parts, dim=axis)
            if axis == 1 and all(i in run.maps for i in ins):
                run.maps.add(out)
        return concat

    # pooling and resize

    def _r_GlobalAveragePool(self, node):
        ins, out = node.inputs, node.outputs[0]

        def gap(run):
            run.env[out] = self._tensor(run, ins[0]).mean((2, 3),
                                                          keepdim=True)
        return gap

    def _r_MaxPool(self, node):
        return self._pool(node)

    def _r_AveragePool(self, node):
        return self._pool(node)

    def _pool(self, node):
        op, ins, out, attrs = (node.op_type, node.inputs, node.outputs[0],
                               node.attrs)
        kernel = _pair(attrs.get("kernel_shape"))
        strides = _pair(attrs.get("strides"))
        ceil = bool(int(attrs.get("ceil_mode", 0)))
        cip = bool(int(attrs.get("count_include_pad", 0)))
        if _pair(attrs.get("dilations")) != (1, 1):
            raise UnsupportedOp(f"{op} (node {node.name}) with dilations")

        def pool(run):
            x = self._tensor(run, ins[0])
            hw_pads = _resolve_pads(attrs, x.shape[2:4], kernel, strides,
                                    (1, 1))
            if ceil:
                # legal only where ceil == floor: the floor shape otherwise
                # would silently break parity
                for size, k, s, (p0, p1) in zip(x.shape[2:4], kernel,
                                                strides, hw_pads):
                    if (int(size) + p0 + p1 - k) % s:
                        raise UnsupportedOp(
                            f"{op} ceil_mode=1 changes the output size "
                            f"(in={size}, k={k}, s={s}, pads=({p0},{p1}))")
            (pt, pb), (pl, pr) = hw_pads
            padded = any((pt, pb, pl, pr))
            if op == "MaxPool":
                if padded:
                    x = F.pad(x, (pl, pr, pt, pb), value=-float("inf"))
                run.env[out] = F.max_pool2d(x, kernel, strides)
                return
            if padded:
                x = F.pad(x, (pl, pr, pt, pb))
            total = F.avg_pool2d(x, kernel, strides, divisor_override=1)
            if cip or not padded:
                run.env[out] = total / float(kernel[0] * kernel[1])
                return
            run.env[out] = total / self._pool_count(
                run, x, kernel, strides, hw_pads)
        return pool

    def _pool_count(self, run, x, kernel, strides, hw_pads):
        """The real (unpadded) cells under each window, made on the
        device once for each geometry."""
        key = (str(run.device), x.dtype, tuple(x.shape[2:4]), kernel,
               strides, hw_pads)
        cnt = self._counts.get(key)
        if cnt is None:
            (pt, pb), (pl, pr) = hw_pads
            h, w = x.shape[2] - pt - pb, x.shape[3] - pl - pr
            ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                    device=run.device), (pl, pr, pt, pb))
            cnt = F.avg_pool2d(ones, kernel, strides, divisor_override=1)
            self._counts[key] = cnt
        return cnt

    def _r_Resize(self, node):
        return self._resize(node)

    def _r_Upsample(self, node):
        return self._resize(node)

    def _resize(self, node):
        """Nearest with integer scales, from ``scales`` or ``sizes``
        (Resize(X, roi, scales, sizes); Upsample(X, scales))."""
        op, ins, out, attrs = (node.op_type, node.inputs, node.outputs[0],
                               node.attrs)
        mode = attrs.get("mode", "nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()

        def resize(run):
            x = self._tensor(run, ins[0])
            scales = None
            if op == "Upsample":
                arr = self._static(run, ins[1]) if len(ins) > 1 else None
                if arr is not None and arr.size == 4:
                    scales = arr.astype(np.float64)
            else:
                arr = self._static(run, ins[2]) if len(ins) > 2 else None
                if arr is not None and arr.size == 4:
                    scales = arr.astype(np.float64)
                elif len(ins) > 3:
                    sizes = self._static(run, ins[3])
                    if sizes is not None and sizes.size == 4:
                        scales = np.asarray(
                            [1.0, 1.0, float(sizes[2]) / x.shape[2],
                             float(sizes[3]) / x.shape[3]])
            if scales is None and "scales" in attrs:
                scales = np.asarray(attrs["scales"], np.float64)
            if scales is None or scales.size != 4:
                raise UnsupportedOp("Resize without static scales")
            sh, sw = int(round(scales[2])), int(round(scales[3]))
            if (mode != "nearest" or sh < 1 or sw < 1
                    or abs(scales[2] - sh) > 1e-6
                    or abs(scales[3] - sw) > 1e-6
                    or scales[0] != 1 or scales[1] != 1):
                raise UnsupportedOp(f"Resize mode={mode} scales={scales}")
            n, c, h, w = x.shape
            run.env[out] = x[:, :, :, None, :, None].expand(
                n, c, h, sh, w, sw).reshape(n, c, h * sh, w * sw)
        return resize

    # layout and shape ops, in ONNX's own layout

    def _r_Shape(self, node):
        ins, out = node.inputs, node.outputs[0]

        def shape(run):
            run.env[out] = np.asarray(tuple(np.shape(run.env[ins[0]])),
                                      np.int64)
        return shape

    def _r_Reshape(self, node):
        ins, out = node.inputs, node.outputs[0]

        def reshape(run):
            x = self._tensor(run, ins[0])
            target = [int(s) for s in self._static_req(
                run, ins[1], node).reshape(-1).tolist()]
            # ONNX: 0 copies the corresponding input dim (allowzero=0)
            target = [x.shape[i] if s == 0 and i < x.dim() else s
                      for i, s in enumerate(target)]
            run.env[out] = x.reshape(target)
        return reshape

    def _r_Flatten(self, node):
        ins, out = node.inputs, node.outputs[0]
        axis = int(node.attrs.get("axis", 1))

        def flatten(run):
            x = self._tensor(run, ins[0])
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            run.env[out] = x.reshape(lead, -1)
        return flatten

    def _axes(self, run, node, name_idx: int = 1):
        axes = node.attrs.get("axes")
        ins = node.inputs
        if axes is None and len(ins) > name_idx and ins[name_idx]:
            axes = self._static_req(run, ins[name_idx], node
                                    ).reshape(-1).tolist()
        return None if axes is None else [int(a) for a in axes]

    def _r_Squeeze(self, node):
        ins, out = node.inputs, node.outputs[0]

        def squeeze(run):
            x = self._tensor(run, ins[0])
            axes = self._axes(run, node)
            run.env[out] = (x.squeeze(tuple(axes)) if axes
                            else x.squeeze())
        return squeeze

    def _r_Unsqueeze(self, node):
        ins, out = node.inputs, node.outputs[0]

        def unsqueeze(run):
            y = self._tensor(run, ins[0])
            for a in sorted(self._axes(run, node)):
                y = y.unsqueeze(a)
            run.env[out] = y
        return unsqueeze

    def _r_Transpose(self, node):
        ins, out = node.inputs, node.outputs[0]
        perm = node.attrs.get("perm")

        def transpose(run):
            x = self._tensor(run, ins[0])
            p = ([int(i) for i in perm] if perm
                 else list(range(x.dim()))[::-1])
            run.env[out] = x.permute(p)
        return transpose

    def _slice_args(self, run, node):
        ins, attrs = node.inputs, node.attrs
        if len(ins) > 1:     # opset 10+: starts/ends/axes/steps inputs
            starts = self._static_req(run, ins[1], node).reshape(-1)
            ends = self._static_req(run, ins[2], node).reshape(-1)
            axes = (self._static_req(run, ins[3], node).reshape(-1)
                    if len(ins) > 3 and ins[3] else np.arange(len(starts)))
            steps = (self._static_req(run, ins[4], node).reshape(-1)
                     if len(ins) > 4 and ins[4] else
                     np.ones(len(starts), np.int64))
        else:
            starts = np.asarray(attrs["starts"])
            ends = np.asarray(attrs["ends"])
            axes = np.asarray(attrs.get("axes", range(len(starts))))
            steps = np.ones(len(starts), np.int64)
        return [(int(ax), int(st) if st > -_INT_MAX else None,
                 int(en) if abs(en) < _INT_MAX else None, int(sp))
                for st, en, ax, sp in zip(starts, ends, axes, steps)]

    def _r_Slice(self, node):
        ins, out = node.inputs, node.outputs[0]

        def slice_(run):
            y = self._tensor(run, ins[0])
            for ax, st, en, sp in self._slice_args(run, node):
                y = _slice(y, ax % y.dim(), st, en, sp)
            run.env[out] = y
        return slice_

    def _r_Gather(self, node):
        ins, out = node.inputs, node.outputs[0]
        axis = int(node.attrs.get("axis", 0))

        def gather(run):
            x = self._tensor(run, ins[0])
            ax = axis % x.dim()
            idx = run.env[ins[1]]
            if _const(idx) and np.ndim(idx) == 0:
                i = int(idx)
                run.env[out] = x.select(ax, i + x.shape[ax] if i < 0 else i)
                return
            if _const(idx):
                flat = np.asarray(idx).reshape(-1).astype(np.int64)
                shape = np.shape(idx)
                ti = self._tensor(run, ins[1]).reshape(-1).long()
                if (flat < 0).any():
                    ti = torch.where(ti < 0, ti + x.shape[ax], ti)
            else:
                shape = tuple(idx.shape)
                ti = idx.reshape(-1).long()
                ti = torch.where(ti < 0, ti + x.shape[ax], ti)
            y = x.index_select(ax, ti)
            run.env[out] = y.reshape(*x.shape[:ax], *shape,
                                     *x.shape[ax + 1:])
        return gather

    def _r_Split(self, node):
        ins, outs = node.inputs, node.outputs
        axis = int(node.attrs.get("axis", 0))

        def split(run):
            x = self._tensor(run, ins[0])
            sizes = node.attrs.get("split")
            if sizes is None and len(ins) > 1 and ins[1]:
                sizes = self._static_req(run, ins[1], node).reshape(-1)
            if sizes is None:
                n, dim = len(outs), x.shape[axis]
                if dim % n:
                    raise UnsupportedOp(
                        f"Split (node {node.name}): {dim} into {n} parts")
                sizes = [dim // n] * n
            parts = torch.split(x, [int(s) for s in sizes], dim=axis)
            for o, p in zip(outs, parts):
                run.env[o] = p
        return split

    def _r_Expand(self, node):
        ins, out = node.inputs, node.outputs[0]

        def expand(run):
            x = self._tensor(run, ins[0])
            shape = [int(s) for s in
                     self._static_req(run, ins[1], node).reshape(-1)]
            run.env[out] = torch.broadcast_to(
                x, np.broadcast_shapes(tuple(x.shape), tuple(shape)))
        return expand

    def _r_Softmax(self, node):
        ins, out = node.inputs, node.outputs[0]
        axis = int(node.attrs.get("axis", -1))

        def softmax(run):
            x = self._tensor(run, ins[0])
            e = torch.exp(x - x.amax(axis, keepdim=True))
            run.env[out] = e / e.sum(axis, keepdim=True)
        return softmax

    def _r_ReduceMean(self, node):
        return self._reduce(node, torch.mean)

    def _r_ReduceSum(self, node):
        return self._reduce(node, torch.sum)

    def _reduce(self, node, fn):
        ins, out = node.inputs, node.outputs[0]
        keep = bool(node.attrs.get("keepdims", 1))

        def reduce(run):
            x = self._tensor(run, ins[0])
            axes = self._axes(run, node)
            dims = tuple(axes) if axes else tuple(range(x.dim()))
            run.env[out] = fn(x, dim=dims, keepdim=keep)
        return reduce

    def _r_Cast(self, node):
        ins, out = node.inputs, node.outputs[0]
        to = _torch_dtype(TENSOR_DTYPES.get(int(node.attrs.get("to", 1)),
                                            np.float32))

        def cast(run):
            run.env[out] = self._tensor(run, ins[0]).to(to)
        return cast

    def _r_Clip(self, node):
        ins, out, attrs = node.inputs, node.outputs[0], node.attrs

        def clip(run):
            y = self._tensor(run, ins[0])
            for j, key, fn, scalar in ((1, "min", torch.maximum,
                                        torch.clamp_min),
                                       (2, "max", torch.minimum,
                                        torch.clamp_max)):
                if len(ins) > j and ins[j]:
                    y, bound = _promote(y, self._tensor(run, ins[j]))
                    y = fn(y, bound)
                elif attrs.get(key) is not None:
                    y = scalar(y, float(attrs[key]))
            run.env[out] = y
        return clip

    def _r_Where(self, node):
        return self._select(node, torch.where)

    def _r_Equal(self, node):
        return self._select(node, torch.eq)

    def _r_Greater(self, node):
        return self._select(node, torch.gt)

    def _r_Less(self, node):
        return self._select(node, torch.lt)

    def _select(self, node, fn):
        ins, out = node.inputs, node.outputs[0]
        where = node.op_type == "Where"

        def select(run):
            vals = [self._tensor(run, i) for i in ins]
            if where:
                vals = [vals[0].bool()] + _promote(*vals[1:])
            else:
                vals = _promote(*vals)
            run.env[out] = fn(*vals)
        return select

    def _r_ConstantOfShape(self, node):
        ins, out = node.inputs, node.outputs[0]
        val = np.asarray(node.attrs.get("value", np.zeros(1, np.float32)))

        def constant_of_shape(run):
            shape = [int(s) for s in
                     self._static_req(run, ins[0], node).reshape(-1)]
            run.env[out] = np.full(shape, val.reshape(-1)[0])
        return constant_of_shape

    def _r_Range(self, node):
        ins, out = node.inputs, node.outputs[0]

        def range_(run):
            s, e, d = (self._static_req(run, i, node).reshape(())
                       for i in ins)
            run.env[out] = np.arange(s, e, d)
        return range_

    # ------------------------------------------------------ numpy folding

    @staticmethod
    def _fold_numpy(node, env) -> Optional[List[np.ndarray]]:
        """Execute a node whose inputs are all numpy, in numpy; None where
        the op has no numpy form here (it then runs on the device)."""
        op = node.op_type
        ins = [env[i] if i else None for i in node.inputs]
        attrs = node.attrs
        try:
            if op == "Shape":
                return [np.asarray(ins[0].shape, np.int64)]
            if op == "Gather":
                return [np.take(ins[0], ins[1].astype(np.int64),
                                axis=int(attrs.get("axis", 0)))]
            if op == "Unsqueeze":
                axes = attrs.get("axes")
                if axes is None and len(ins) > 1:
                    axes = ins[1].reshape(-1).tolist()
                y = ins[0]
                for a in sorted(int(a) for a in axes):
                    y = np.expand_dims(y, a)
                return [y]
            if op == "Squeeze":
                axes = attrs.get("axes")
                if axes is None and len(ins) > 1 and ins[1] is not None:
                    axes = ins[1].reshape(-1).tolist()
                return [np.squeeze(ins[0], axis=tuple(int(a) for a in axes)
                                   if axes else None)]
            if op == "Concat":
                return [np.concatenate([i for i in ins if i is not None],
                                       axis=int(attrs.get("axis", 0)))]
            if op == "Cast":
                return [ins[0].astype(
                    TENSOR_DTYPES.get(int(attrs.get("to", 1)), np.float32))]
            if op in ("Add", "Sub", "Mul", "Div"):
                fn = {"Add": np.add, "Sub": np.subtract,
                      "Mul": np.multiply, "Div": np.divide}[op]
                return [fn(ins[0], ins[1])]
            if op == "Reshape":
                return [ins[0].reshape([int(s) for s in ins[1].reshape(-1)])]
            if op == "Slice" and len(ins) > 1:
                starts = ins[1].reshape(-1)
                ends = ins[2].reshape(-1)
                axes = (ins[3].reshape(-1) if len(ins) > 3
                        and ins[3] is not None else np.arange(len(starts)))
                steps = (ins[4].reshape(-1) if len(ins) > 4
                         and ins[4] is not None
                         else np.ones(len(starts), np.int64))
                sl = [slice(None)] * ins[0].ndim
                for st, en, ax, sp in zip(starts, ends, axes, steps):
                    sl[int(ax)] = slice(
                        int(st) if st > -_INT_MAX else None,
                        int(en) if abs(en) < _INT_MAX else None, int(sp))
                return [ins[0][tuple(sl)]]
            if op == "Range":
                return [np.arange(ins[0].reshape(()), ins[1].reshape(()),
                                  ins[2].reshape(()))]
            if op == "ConstantOfShape":
                val = attrs.get("value", np.zeros(1, np.float32))
                return [np.full([int(s) for s in ins[0].reshape(-1)],
                                np.asarray(val).reshape(-1)[0])]
        except Exception:
            return None
        return None


def onnx_model(path: str, dtype: torch.dtype = torch.float32,
               device=None) -> OnnxModel:
    """``OnnxModel`` of the file at ``path``; the device is resolved before
    the file is read, so a missing card raises first."""
    device = resolve_device(device)
    return OnnxModel(load_onnx(path), dtype=dtype, device=device)
