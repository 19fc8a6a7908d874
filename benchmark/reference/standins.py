"""The plain reference's models: what every model family shares.

A configuration's model entry (its ``detector``, its ``embedder``) names
its ``family``; the family's file, ``reference/models/<family>.py`` in the
folder the harness runs from, is found by that name (``core.family``) and
holds:

- ``MODULE``, the frozen module class, with its blocks: a copy of the
  repository's stand-in (``tests/torch_export.py``) where there is one,
  so that a later edit of the test helpers cannot move the yardstick;
- ``NOT_SIZES``, every key of the entry that is not one of ``MODULE``'s
  constructor sizes (``family`` and ``variant`` among them);
- ``prepare(model, spec)``, what follows the seeded draw;
- ``small(spec)``, the entry cut to a size the CPU runs in seconds, its
  widths kept.

So a configuration of a new architecture is a family file, a
configuration file, a limits file and an entry: no file here changes.

``build`` makes a module from a configuration's sizes with weights drawn
from a seed on the device, in three calls (every parameter, every
BatchNorm running variance, every running mean), at the scales the
stand-ins use (``N(0, 0.1^2)`` parameters, variances in [0.75, 1.25),
means ``N(0, 0.1^2)``), then prepares it as its family says.
``calibrate_norms_`` then sets the BatchNorm statistics from the cell's
own inputs, so that the outputs depend on the frame. The benchmark hands
these weights to the program through an ONNX file (``export_onnx``) and
keeps the module as the reference.

Imports torch and the harness's lookup of files (``benchmark.core``); the
family files import torch alone. Neither imports anything of the program,
of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .. import core


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


def sizes(spec: dict) -> dict:
    """A model entry's constructor sizes: its keys but its family's
    ``NOT_SIZES``, lists as tuples."""
    skip = core.family(spec["family"]).NOT_SIZES
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in spec.items() if k not in skip}


def architecture(spec: dict) -> nn.Module:
    """The module a configuration's model entry describes: its
    ``family``'s ``MODULE`` at the entry's sizes."""
    return core.family(spec["family"]).MODULE(**sizes(spec))


def small(spec: dict) -> dict:
    """The model entry cut to a size the CPU runs in seconds, as its
    family cuts it."""
    return core.family(spec["family"]).small(spec)


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
    from ``seed`` there (no host copy of the parameters), then prepared by
    its family (``prepare``)."""
    with torch.device("meta"):
        model = architecture(spec)
    model = model.to_empty(device=device)
    for name, b in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            b.zero_()
    seed_weights_(model, seed)
    core.family(spec["family"]).prepare(model, spec)
    return model.eval().requires_grad_(False)
