"""Exchanges between the data slots of a mesh inside one training step.

The port's stand-in for the collectives GSPMD inserts into the JAX
package's sharded training step. One process drives every slot, as
elsewhere in ``parallel/``: a step's forward runs one Python thread a data
slot (as ``torch.nn.parallel.parallel_apply`` runs replicas), each on its
part of the batch. Where the JAX program needs a value of the whole batch
(BatchNorm's statistics), the threads meet at an exchange: each hands in
its part, waits at a barrier for the others, and takes the sum of every
part, added in slot order on its own device with ``.to(device)`` and
``+``. The sum is then the same number on every slot, and autograd carries
gradients back through it across devices, so the caller runs ONE backward
from the global loss after the threads have joined.

An exchange made inside a block that ``models.layers.remat_call``
recomputes in the backward pass is recorded, and the recomputation takes
the recorded sum instead of exchanging again (it runs in autograd's
thread, where the other slots are not waiting).

Failures are never hidden: an exception in a slot's thread breaks the
barrier for the others and is raised again in the caller; a barrier that
waits longer than the group's ``timeout_s`` raises ``TimeoutError``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from ..device import on_device

BARRIER_TIMEOUT_S = 300.0

_local = threading.local()


class _Aborted(Exception):
    """Raised in a slot whose barrier was broken by another slot's
    failure; the caller raises that failure instead."""


class SlotGroup:
    """The data slots of one step: ``devices[r]`` is where rank r's part
    lives. Its exchanges are numbered in call order, which is the same in
    every slot (each runs the same module)."""

    def __init__(self, devices: Sequence[torch.device],
                 timeout_s: float = BARRIER_TIMEOUT_S):
        self.devices = list(devices)
        self.size = len(self.devices)
        self.timeout_s = timeout_s
        self._barrier = threading.Barrier(self.size, timeout=timeout_s)
        self._lock = threading.Lock()
        self._rounds: List[List[Optional[torch.Tensor]]] = []
        self._failed = False
        # seconds each rank spent waiting at the barrier
        self.waited_s = [0.0] * self.size

    @property
    def exchanges(self) -> int:
        return len(self._rounds)

    def abort(self) -> None:
        self._failed = True
        self._barrier.abort()

    def _wait(self, rank: int) -> None:
        t = time.perf_counter()
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            if self._failed:
                raise _Aborted() from None
            raise TimeoutError(
                f"a slot waited longer than {self.timeout_s} s at an "
                "exchange: another slot did not reach it") from None
        finally:
            self.waited_s[rank] += time.perf_counter() - t

    def all_sum(self, rank: int, k: int, part: torch.Tensor) -> torch.Tensor:
        """Exchange ``k``: the sum of every rank's ``part``, added in rank
        order on ``part``'s device."""
        with self._lock:
            while len(self._rounds) <= k:
                self._rounds.append([None] * self.size)
            self._rounds[k][rank] = part
        self._wait(rank)
        return ordered_sum(self._rounds[k], part.device)


class SlotContext:
    """What a thread knows of the step it runs in: its group and rank, the
    count of its exchanges, and where a recomputed block records or
    replays them."""

    def __init__(self, group: Optional[SlotGroup], rank: int, size: int):
        self.group = group
        self.rank = rank
        self.size = size
        self.count = 0
        self.record: Optional[List[Tuple[torch.Tensor, bool]]] = None
        self.replay: Optional[Iterator[Tuple[torch.Tensor, bool]]] = None

    @property
    def leader(self) -> bool:
        """Rank 0 moves what moves once a step (BatchNorm's running
        statistics): it runs the master copy of the weights."""
        return self.rank == 0

    def all_sum(self, part: torch.Tensor) -> torch.Tensor:
        """The sum of ``part`` over every slot of the step."""
        if self.replay is not None:
            value, grad = next(self.replay)
            # a leaf that requires grad where the exchanged sum did: the
            # recomputation then saves the tensors the forward saved
            return value.to(part.device).detach().requires_grad_(grad)
        k, self.count = self.count, self.count + 1
        out = self.group.all_sum(self.rank, k, part)
        if self.record is not None:
            self.record.append((out.detach(), out.requires_grad))
        return out


def current() -> Optional[SlotContext]:
    """The calling thread's slot in a meshed step, or None outside one."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def _context(ctx: Optional[SlotContext]) -> Iterator[None]:
    prev = current()
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


def remat_contexts():
    """(forward, recompute) context managers for one checkpointed block
    (``torch.utils.checkpoint``'s ``context_fn``): in a meshed step the
    forward records the block's exchanges and the recomputation replays
    them, in order; outside one both do nothing."""
    ctx = current()
    if ctx is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    recorded: List[Tuple[torch.Tensor, bool]] = []

    @contextlib.contextmanager
    def record():
        prev, ctx.record = ctx.record, recorded
        try:
            yield
        finally:
            ctx.record = prev

    @contextlib.contextmanager
    def replay():
        again = SlotContext(None, ctx.rank, ctx.size)
        again.replay = iter(recorded)
        with _context(again):
            yield

    return record(), replay()


def run_slots(fn: Callable[[int], Any], group: SlotGroup) -> List[Any]:
    """``fn(rank)`` for every rank of ``group``, one thread each, under the
    caller's grad mode and on the rank's device; their results in rank
    order. The first exception a thread raises is raised here (the other
    threads are released from their barriers first)."""
    grad = torch.is_grad_enabled()
    results: List[Any] = [None] * group.size
    errors: List[Optional[BaseException]] = [None] * group.size

    def work(rank: int) -> None:
        try:
            with _context(SlotContext(group, rank, group.size)), \
                    torch.set_grad_enabled(grad), \
                    on_device(group.devices[rank]):
                results[rank] = fn(rank)
        except BaseException as e:       # re-raised by the caller below
            errors[rank] = e
            group.abort()

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"slot-{r}")
               for r in range(group.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None and not isinstance(e,
                                                                   _Aborted)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise RuntimeError("a slot's barrier was broken with no failure")
    return results


def ordered_sum(parts: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """``parts`` added in order on ``device`` (a step's per-slot loss sums
    and counts)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out
