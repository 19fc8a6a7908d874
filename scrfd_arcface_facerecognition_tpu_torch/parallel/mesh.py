"""Device meshes and the multi-process bootstrap.

Counterpart of the JAX package's ``parallel/mesh.py``. Like it, the port
drives every device of a mesh from ONE process: a shard is a tensor on its
slot's device, and what the JAX package's collectives move between
devices the port moves with copies (``.to(device)``, over NVLink between
cards). ``torch.distributed`` enters only where a deployment leaves the
one process (``initialize_distributed``).

A mesh position is a :class:`Slot`: an id and the torch device its work
runs on. ``card_slots()`` gives one slot a CUDA card. ``device_slots(device,
n)`` gives ``n`` slots that share one device, as the JAX tests' virtual CPU
devices share the CPU (``--xla_force_host_platform_device_count``): the
CPU tests mesh over 8 ``cpu`` slots, and a one-card machine meshes over
slots of ``cuda:0``. Slots that share a device share its work queue, so
their times are no scaling figure.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Slot:
    """One mesh position: ``id`` is unique among the slots of a mesh;
    ``device`` is where the position's tensors live and its work runs."""
    id: int
    device: torch.device


def _indexed(device) -> torch.device:
    """``device`` checked (a CUDA one needs a card) and, for CUDA, with
    its index (``cuda`` is ``cuda:0``), as a tensor's ``.device`` has it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def card_slots() -> List[Slot]:
    """One slot for each CUDA card of this process; raises without one.
    A CPU mesh is asked for explicitly: ``device_slots("cpu", n)``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; a mesh over the CPU takes "
            "explicit slots: devices=device_slots('cpu', n)")
    return [Slot(i, torch.device("cuda", i)) for i in range(n)]


def device_slots(device, n: int) -> List[Slot]:
    """``n`` slots that share ``device`` (ids 0..n-1)."""
    dev = _indexed(device)
    return [Slot(i, dev) for i in range(n)]


def training_slots(device: str = "cuda",
                   slots: Optional[int] = None) -> List[Slot]:
    """The slots a training tool meshes over: ``slots`` slots that share
    ``device`` when given (a one-card machine's, or the CPU's, stand-in
    for several devices); else every CUDA card for ``"cuda"``, and one
    slot for any other device."""
    if slots:
        return device_slots(device, slots)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return card_slots()
    return [Slot(0, _indexed(dev))]


def local_device_count() -> int:
    """CUDA cards attached to this process (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class Mesh:
    """An n-d array of slots with named axes (``jax.sharding.Mesh``).

    ``devices`` is the object array of :class:`Slot`; ``shape`` maps each
    axis name to its size, in order.
    """

    def __init__(self, slots: np.ndarray, axis_names: Sequence[str]):
        self.devices = slots
        self.axis_names = tuple(axis_names)
        if slots.ndim != len(self.axis_names):
            raise ValueError(f"{slots.ndim}-d slots, axes {self.axis_names}")
        ids = [s.id for s in slots.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(f"slot ids repeat in the mesh: {ids}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_slots(self, axis: str) -> List[Slot]:
        """The slots along ``axis`` with every other axis at its first
        index: where the shards of an array split on ``axis`` are held.
        (JAX keeps a copy of each shard at every index of the other axes;
        one process needs one.)"""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])


def _slot_array(slots: Sequence[Slot], shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(slots), dtype=object)
    for i, s in enumerate(slots):
        arr[i] = s
    return arr.reshape(shape)


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[Slot]] = None) -> Mesh:
    """A mesh over ``devices`` (default: the CUDA cards; raises without
    one).

    make_mesh() -> 1-D 'data' mesh over all cards.
    make_mesh((2, 4), ('data', 'model'), device_slots('cpu', 8)) -> 2x4.
    """
    slots = list(devices if devices is not None else card_slots())
    for s in slots:
        _indexed(s.device)                 # a CUDA slot needs a card
    if axis_sizes is None:
        axis_sizes = (len(slots),)
    n = int(np.prod(axis_sizes))
    if n > len(slots):
        raise ValueError(f"mesh needs {n} devices, have {len(slots)}")
    return Mesh(_slot_array(slots[:n], tuple(axis_sizes)), axis_names)


def make_hybrid_mesh(ici_axis_sizes: Tuple[int, ...],
                     axis_names: Sequence[str],
                     dcn_axis: str = "replica",
                     num_slices: Optional[int] = None,
                     devices: Optional[Sequence[Slot]] = None) -> Mesh:
    """A mesh (dcn_axis, *axis_names) whose leading axis strides across
    equal contiguous groups of ``devices`` (default: the CUDA cards).

    The JAX package takes the groups from a TPU's slice index where the
    runtime reports one; torch reports none, so the groups are always the
    contiguous split (the JAX package's fallback).

    make_hybrid_mesh((2, 4), ("data", "model"), num_slices=2, devices=...)
        -> a (2, 2, 4) mesh with axes ("replica", "data", "model").
    """
    slots = list(devices if devices is not None else card_slots())
    n_ici = int(np.prod(ici_axis_sizes))
    if num_slices is None:
        num_slices = max(1, len(slots) // n_ici)
    per = len(slots) // num_slices
    if per < n_ici:
        raise ValueError(f"slice has {per} devices, ici mesh needs {n_ici}")
    groups = [slots[i * per:i * per + n_ici] for i in range(num_slices)]
    return make_mesh((num_slices, *ici_axis_sizes),
                     (dcn_axis, *tuple(axis_names)),
                     devices=[s for g in groups for s in g])


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 300.0) -> bool:
    """Join a multi-process group (``torch.distributed``): the counterpart
    of the JAX package's ``jax.distributed.initialize`` bootstrap.

    The coordinator ("host:port"), the process count and this process's
    rank come from the arguments or from the environment torch's launchers
    set (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK). The backend is
    ``nccl`` with a card and ``gloo`` without, unless given. Returns True
    when a group of more than one process is up; False when there is
    nothing to join (no coordinator or no process count) or the group has
    one process. A group that is already up is reported, not joined again.
    """
    dist = torch.distributed
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id or 0,
        timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1
