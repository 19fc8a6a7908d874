"""Frame data-parallelism: batches split over the slots of a mesh axis.

Counterpart of the JAX package's ``parallel/data_parallel.py``. There,
``jax.device_put`` with a ``NamedSharding`` places a batch and jit
partitions the fused program over it. Here the batch is split into one
tensor a slot (:class:`ShardedFrames`), ``FacePipeline`` runs each part on
its slot with that device's replica of the weights (``replicate``, kept
fresh by :class:`Replicas`), and joins the outputs in frame order. Frames
are independent, so no shard waits for another.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .mesh import Mesh, Slot


class ShardedFrames(NamedTuple):
    """A (B, H, W, 3) u8 frame batch split over ``axis`` of ``mesh``:
    ``parts[i]`` holds frames [i * B / n, (i + 1) * B / n) on
    ``slots[i].device``."""
    parts: Tuple[torch.Tensor, ...]
    slots: Tuple[Slot, ...]
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self.parts),
                *self.parts[0].shape[1:])


def split_batch(frames, slots: List[Slot]) -> Tuple[torch.Tensor, ...]:
    """(B, ...) numpy array or tensor -> one contiguous part a slot, on its
    device. A host array bound for a card is pinned once, so each part's
    copy is queued without making the host wait."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    n = len(slots)
    if frames.shape[0] % n:
        raise ValueError(f"batch {frames.shape[0]} not divisible by the "
                         f"{n} slots")
    if (frames.device.type == "cpu"
            and any(s.device.type == "cuda" for s in slots)):
        frames = frames.pin_memory()
    per = frames.shape[0] // n
    return tuple(frames[i * per:(i + 1) * per]
                 .to(s.device, non_blocking=True).contiguous()
                 for i, s in enumerate(slots))


def shard_frames(frames, mesh: Mesh, axis: str = "data") -> ShardedFrames:
    """Place (B, H, W, 3) (or one (H, W, 3)) u8 frames batch-split over
    the mesh's ``axis``; B must divide by the axis's size."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    if frames.dim() == 3:
        frames = frames[None]
    slots = mesh.axis_slots(axis)
    return ShardedFrames(split_batch(frames, slots), tuple(slots), mesh,
                         axis)


def distinct_devices(slots: Iterable[Slot]) -> List[torch.device]:
    """The slots' devices, each once, in slot order."""
    out: List[torch.device] = []
    for s in slots:
        if s.device not in out:
            out.append(s.device)
    return out


def _copy_to(obj, device: torch.device):
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _copy_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_to(v, device) for v in obj)
    return obj


def replicate(obj, mesh: Mesh) -> Dict[torch.device, Any]:
    """A copy of a module, a tensor or a tree of them on each distinct
    device of the mesh (one a device, not one a slot: slots that share a
    device share its copy), keyed by device."""
    return {d: _copy_to(obj, d) for d in distinct_devices(mesh.devices.flat)}


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:         # an inference tensor keeps no counter
        return None


class SourceKey:
    """What a copy was made from: the source object and each of its
    tensors (held, so that a new tensor can never pass for a freed one)
    with its version counter, which every in-place write moves.

    The JAX package keys its placement cache on the source trees'
    identity, which is enough for immutable arrays. A torch module changes
    in place (``load_state_dict``, an optimizer step), so identity alone
    would keep serving stale copies. (A tensor made under
    ``inference_mode`` keeps no counter; only its identity is compared.)
    """

    def __init__(self, obj):
        self.src = obj
        self.key = [(t, _version(t)) for t in _tensors(obj)]

    def matches(self, obj) -> bool:
        if obj is not self.src:
            return False
        now = _tensors(obj)
        return (len(now) == len(self.key)
                and all(t is k and _version(t) == v
                        for t, (k, v) in zip(now, self.key)))


class Replicas:
    """Copies of one source on several devices, made again whenever the
    source is no longer what they were copied from (:class:`SourceKey`)."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.made_from: Optional[SourceKey] = None
        self.copies: Dict[torch.device, Any] = {}

    def on(self, obj, devices: Iterable[torch.device]
           ) -> Dict[torch.device, Any]:
        """{device: copy of ``obj``} for each of ``devices``."""
        if self.made_from is None or not self.made_from.matches(obj):
            self.made_from = SourceKey(obj)
            self.copies = {}
        for d in devices:
            if d not in self.copies:
                self.copies[d] = _copy_to(obj, d)
        return self.copies
