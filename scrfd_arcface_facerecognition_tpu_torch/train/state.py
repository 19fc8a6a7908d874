"""What the trainers share: optax's clipped SGD with momentum written out,
and a train state's parts, its tensors by name and the gap between two
states.

The update is optax's ``chain(clip_by_global_norm(5), add_decayed_weights
(wd), sgd(lr, momentum=0.9))``: the global norm over every trained tensor,
decay on every tensor, the trace ``g + 0.9 * trace``, then ``p - lr *
trace`` (the caller reads the learning rate at the step before the
increment).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, NamedTuple

import torch
from torch import nn

from ..models.layers import RoundedWeights, set_compute_dtype

MAX_GRAD_NORM = 5.0
MOMENTUM = 0.9


@torch.no_grad()
def sgd_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                traces: List[torch.Tensor], lr: float,
                weight_decay: float) -> torch.Tensor:
    """optax's chain on the tensors in place: clip the gradients by their
    global norm, add decayed weights, the momentum trace, ``p - lr *
    trace``. Returns the global norm before the clip."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm),
                         MAX_GRAD_NORM / norm)
    torch._foreach_mul_(grads, factor)
    torch._foreach_add_(grads, params, alpha=weight_decay)
    torch._foreach_mul_(traces, MOMENTUM)
    torch._foreach_add_(traces, grads)
    torch._foreach_add_(params, traces, alpha=-lr)
    return norm


def check_trainable(model: nn.Module, dtype: torch.dtype) -> None:
    """Raise unless ``model`` computes in float32 (as the JAX trainers do)
    and ``dtype``, the precision of a trainer's state and step, is float32
    or float64."""
    for m in model.modules():
        if isinstance(m, RoundedWeights) and m.compute_dtype != torch.float32:
            raise ValueError(
                "the trainer trains at float32 compute, as the JAX trainer "
                f"does; this model computes in {m.compute_dtype} (round a "
                "trained module for serving with set_compute_dtype)")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: float32 or float64")


def module_from(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` in ``dtype`` holding ``state_dict`` (strict; BN's
    batch counters, which Flax does not keep, may be missing)."""
    module = copy.deepcopy(model).to(dtype)
    sd = dict(state_dict)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = value
    module.load_state_dict(sd, strict=True)
    return module


def placed_module(module: nn.Module, device: torch.device,
                  dtype: torch.dtype) -> nn.Module:
    """``module`` on ``device`` in ``dtype``, computing in it, in training
    mode with gradients on."""
    module = set_compute_dtype(module.to(device, dtype), dtype)
    return module.train().requires_grad_(True)


def state_parts(state: NamedTuple) -> Dict[str, Any]:
    """A train state's parts, copied to the CPU (what the trainers'
    ``state_from`` takes): a module's state dict, a tensor, a dict of
    tensors (the momentum) or the step, by field name. A state moves to
    another device or trainer through them."""
    out: Dict[str, Any] = {}
    for name, value in state._asdict().items():
        if isinstance(value, nn.Module):
            value = value.state_dict()
        if isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().clone()
        elif isinstance(value, Mapping):
            out[name] = {k: v.detach().cpu().clone()
                         for k, v in value.items()}
        else:
            out[name] = value
    return out


def state_tensors(parts: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state's tensors by name (from ``state_parts``): ``<field>.<key>``
    for a dict of tensors (an ArcFace state's ``backbone.<key>`` and
    ``trace.<name>``, a detector state's ``model.<key>``), ``<field>`` for
    a tensor (``head_w``); not the step nor BN's batch counters."""
    out: Dict[str, torch.Tensor] = {}
    for kind, value in parts.items():
        if isinstance(value, Mapping):
            out.update((f"{kind}.{k}", v) for k, v in value.items()
                       if not k.endswith("num_batches_tracked"))
        elif isinstance(value, torch.Tensor):
            out[kind] = value
    return out


def state_gaps(got: Mapping[str, Any], want: Mapping[str, Any],
               atol: float, rtol: float) -> Dict[str, float]:
    """How far two states' parts lie apart: for each tensor, the largest
    ``|got - want|`` as a share of ``atol + rtol * max |want|`` (each
    tensor within its bound when every share is at most 1)."""
    got, want = state_tensors(got), state_tensors(want)
    if sorted(got) != sorted(want):
        raise ValueError("the two states do not hold the same tensors")
    out = {}
    for name, w in want.items():
        w = w.detach().double()
        d = float((got[name].detach().double() - w).abs().max())
        out[name] = d / (atol + rtol * float(w.abs().max()))
    return out
