"""What the trainers share: optax's clipped SGD with momentum written out,
a train state's parts, its tensors by name and the gap between two
states, and the data-parallel half of a meshed step.

The update is optax's ``chain(clip_by_global_norm(5), add_decayed_weights
(wd), sgd(lr, momentum=0.9))``: the global norm over every trained tensor,
decay on every tensor, the trace ``g + 0.9 * trace``, then ``p - lr *
trace`` (the caller reads the learning rate at the step before the
increment). The tensors may lie on several devices (a meshed step's class
matrix shards): the norm is taken on the first one's device.

A meshed step (``DataSlots``) runs the forward one thread a 'data' slot
(``parallel.collectives``): the slots on the master weights' device run
the master module itself, the others a copy a device
(``parallel.data_parallel.Replicas``, made again after every update). One
backward from the global loss gives the master's gradients and the
copies'; the copies' are added onto the master's in slot order, and the
update runs once, on the master.
"""
from __future__ import annotations

import copy
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Sequence, Tuple)

import torch
from torch import nn

from ..models.layers import RoundedWeights, set_compute_dtype
from ..parallel.collectives import SlotGroup, ordered_sum, run_slots
from ..parallel.data_parallel import Replicas, distinct_devices, split_batch
from ..parallel.mesh import Mesh, Slot

MAX_GRAD_NORM = 5.0
MOMENTUM = 0.9


@torch.no_grad()
def sgd_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                traces: List[torch.Tensor], lr: float,
                weight_decay: float) -> torch.Tensor:
    """optax's chain on the tensors in place: clip the gradients by their
    global norm, add decayed weights, the momentum trace, ``p - lr *
    trace``. Returns the global norm before the clip."""
    groups: Dict[torch.device, List[int]] = {}
    for i, p in enumerate(params):
        groups.setdefault(p.device, []).append(i)
    home = params[0].device
    norms: List[torch.Tensor] = [None] * len(params)
    for dev, idx in groups.items():
        for i, n in zip(idx, torch._foreach_norm([grads[i] for i in idx])):
            norms[i] = n.to(home)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    factor = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm),
                         MAX_GRAD_NORM / norm)
    for dev, idx in groups.items():
        g, p, t = ([x[i] for i in idx] for x in (grads, params, traces))
        torch._foreach_mul_(g, factor.to(dev))
        torch._foreach_add_(g, p, alpha=weight_decay)
        torch._foreach_mul_(t, MOMENTUM)
        torch._foreach_add_(t, g)
        torch._foreach_add_(p, t, alpha=-lr)
    return norm


class ColumnShards(NamedTuple):
    """A (D, C) matrix split by columns over the slots of a mesh axis:
    ``cols[j]`` holds columns [j * per, (j + 1) * per) on
    ``slots[j].device`` (the JAX package's ``P(None, 'model')``)."""
    cols: Tuple[torch.Tensor, ...]
    slots: Tuple[Slot, ...]

    @property
    def per(self) -> int:
        return self.cols[0].shape[1]

    @classmethod
    def split(cls, mat: torch.Tensor, slots: Sequence[Slot],
              dtype: torch.dtype) -> "ColumnShards":
        """``mat`` (D, C), C a multiple of the slot count, split in column
        order; each shard a copy of its own on its slot's device."""
        n = len(slots)
        if mat.shape[1] % n:
            raise ValueError(f"{mat.shape[1]} columns do not split over "
                             f"{n} slots")
        per = mat.shape[1] // n
        return cls(tuple(mat[:, j * per:(j + 1) * per].detach().to(
            s.device, dtype, copy=True).contiguous()
            for j, s in enumerate(slots)), tuple(slots))

    def joined(self) -> torch.Tensor:
        """The whole matrix on the CPU, detached."""
        return torch.cat([c.detach().cpu() for c in self.cols], dim=1)


class DataSlots:
    """The data-parallel half of a meshed step over ``mesh``'s 'data'
    axis: which module each slot runs, one thread a slot, and the
    replicas' gradients summed onto the master's."""

    def __init__(self, mesh: Mesh):
        self.slots = mesh.axis_slots("data")
        self._replicas = Replicas()
        self.last_group = None        # the last step's SlotGroup

    def split(self, x, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(B, ...) -> one part a slot, on its device, in ``dtype``; B must
        divide by the slot count."""
        return split_batch(torch.as_tensor(x).to(dtype=dtype), self.slots)

    def modules(self, master: nn.Module
                ) -> Tuple[List[nn.Module], List[nn.Module]]:
        """(the module of each slot, the replicas in slot order): the
        master on its own device, a copy on each other device."""
        home = next(master.parameters()).device
        others = [d for d in distinct_devices(self.slots) if d != home]
        copies = self._replicas.on(master, others) if others else {}
        return ([master if s.device == home else copies[s.device]
                 for s in self.slots], [copies[d] for d in others])

    def run(self, fn: Callable[[int], Any]) -> List[Any]:
        """``fn(rank)`` one thread a slot, their exchanges in one group."""
        self.last_group = SlotGroup([s.device for s in self.slots])
        return run_slots(fn, self.last_group)

    @staticmethod
    def grads(loss: torch.Tensor, master: nn.Module,
              replicas: Sequence[nn.Module], extra: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
        """The gradients of ``loss`` for the master's parameters (each
        replica's added onto them in order) and for ``extra``."""
        params = list(master.parameters())
        rep = [list(r.parameters()) for r in replicas]
        flat = params + list(extra) + [p for ps in rep for p in ps]
        got = list(torch.autograd.grad(loss, flat))
        n, k = len(params), len(params) + len(extra)
        out = got[:k]
        for r in range(len(replicas)):
            g = got[k + r * n:k + (r + 1) * n]
            out[:n] = [ordered_sum([a, b], a.device)
                       for a, b in zip(out[:n], g)]
        return out


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
    tensors (the momentum) or the step, by field name; a class matrix
    sharded over a mesh as the whole matrix. A state moves to another
    device, mesh or trainer through them."""
    out: Dict[str, Any] = {}
    for name, value in state._asdict().items():
        if isinstance(value, nn.Module):
            value = value.state_dict()
        if isinstance(value, (torch.Tensor, ColumnShards)):
            out[name] = host_copy(value)
        elif isinstance(value, Mapping):
            out[name] = {k: host_copy(v) for k, v in value.items()}
        else:
            out[name] = value
    return out


def host_copy(t) -> torch.Tensor:
    """A tensor, or the whole matrix of ``ColumnShards``, copied to the
    CPU."""
    if isinstance(t, ColumnShards):
        return t.joined()
    return t.detach().cpu().clone()


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
