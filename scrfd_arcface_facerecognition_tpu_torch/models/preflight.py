"""Release-file preflight: a bad graph fails with a named diagnosis.

Before a released file is run, ``preflight_graph`` classifies what is
wrong with it instead of letting a parser traceback or an
``UnsupportedOp`` deep in a forward say it. The port's counterpart of the
JAX package's ``models/preflight.py``, reading through the port's own
``onnx_proto.load_onnx`` and ``config_from_graph``.

Classes (``ReleaseFileError.kind``):
  missing_file | empty_file | not_onnx | corrupt_or_truncated |
  unsupported_op | wrong_graph_kind | output_arity |
  config_inference_failed

A det_500m graph under the name det_10g.onnx is not an error: the
architecture comes from the bytes (``config_from_graph``), so any
SCRFD-family graph loads under any det_* name. Only swaps across kinds
(an embedder under a det name, or the other way) are caught.
"""
from __future__ import annotations

import os
from typing import Dict

from .config_from_graph import ConfigInferenceError, detect_family
from .onnx_exec import SUPPORTED_OPS
from .onnx_proto import OnnxGraph, load_onnx


class ReleaseFileError(Exception):
    """A release file failed preflight; ``.kind`` names the class."""

    def __init__(self, kind: str, path: str, detail: str):
        self.kind = kind
        self.path = path
        self.detail = detail
        super().__init__(f"[{kind}] {os.path.basename(path)}: {detail}")


def preflight_graph(path: str, expect_kind: str) -> Dict:
    """Check one release file; raise ReleaseFileError naming the class of
    the defect, or return facts about it.

    expect_kind: 'det' (SCRFD: 6, 9 or 15 outputs) or 'rec' (an embedder:
    one output). Returns {'family', 'n_nodes', 'n_outputs',
    'unsupported': []}.
    """
    if expect_kind not in ("det", "rec"):
        raise ValueError(f"expect_kind must be det|rec, got {expect_kind!r}")
    if not os.path.exists(path):
        raise ReleaseFileError("missing_file", path,
                               "file does not exist: did the download "
                               "finish?")
    size = os.path.getsize(path)
    if size == 0:
        raise ReleaseFileError("empty_file", path,
                               "0 bytes: a truncated download")
    try:
        graph = load_onnx(path)
    except Exception as e:
        msg = str(e)
        kind = ("not_onnx" if "no graph found" in msg
                else "corrupt_or_truncated")
        raise ReleaseFileError(
            kind, path, f"protobuf parse failed after {size} bytes: {msg}; "
            "download it again and compare checksums") from e
    return preflight_parsed(graph, path, expect_kind)


def preflight_parsed(graph: OnnxGraph, path: str, expect_kind: str) -> Dict:
    """The checks of ``preflight_graph`` after parsing, for callers that
    already hold an OnnxGraph."""
    if not graph.nodes:
        raise ReleaseFileError("corrupt_or_truncated", path,
                               "graph parsed but contains no nodes")
    unsupported = sorted({n.op_type for n in graph.nodes
                          if n.op_type not in SUPPORTED_OPS})
    if unsupported:
        raise ReleaseFileError(
            "unsupported_op", path,
            f"graph uses op(s) the executor cannot run: "
            f"{', '.join(unsupported)}; a newer export opset? Extend "
            "models/onnx_exec.py for these ops")
    n_out = len(graph.outputs)
    try:
        family = detect_family(graph)
    except ConfigInferenceError as e:
        raise ReleaseFileError(
            "output_arity", path,
            f"{n_out} outputs match no supported family: {e}") from e
    actual_kind = "det" if family == "scrfd" else "rec"
    if actual_kind != expect_kind:
        want = ("a detector (SCRFD, >=6 outputs)" if expect_kind == "det"
                else "a recognition embedder (1 output)")
        raise ReleaseFileError(
            "wrong_graph_kind", path,
            f"expected {want} but the bytes are a {family} graph with "
            f"{n_out} output(s): files swapped under expected names?")
    # SCRFD ships 3 strides x 2 or 3 heads (or 5 strides x 3)
    if expect_kind == "det" and n_out not in (6, 9, 15):
        raise ReleaseFileError(
            "output_arity", path,
            f"SCRFD-family graph with {n_out} outputs (expected 6, 9, or "
            "15 = strides x (cls, box[, kps])): unsupported head layout")
    # the importer's architecture inference must succeed as well
    try:
        from .config_from_graph import infer_config

        infer_config(graph)
    except ConfigInferenceError as e:
        raise ReleaseFileError(
            "config_inference_failed", path,
            f"family {family} recognized but architecture inference "
            f"failed: {e}; the executor path still runs the file") from e
    return {"family": family, "n_nodes": len(graph.nodes),
            "n_outputs": n_out, "unsupported": []}
