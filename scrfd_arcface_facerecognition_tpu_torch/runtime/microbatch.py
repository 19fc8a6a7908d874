"""Dynamic micro-batching: concurrent single-item calls -> shared batches.

The card earns its throughput on batches: one 16-image detect + embed call
costs little more than a 1-image one, but a web server handles requests
one image at a time on separate threads (request handlers calling
``app.get(image)``). Without coalescing, N concurrent requests issue N
batch-1 calls.

MicroBatcher is the classic dynamic-batching collector: callers block in
``submit()``, a collector thread drains the queue for at most
``max_wait_ms`` (or until ``max_batch``), groups compatible requests,
issues ONE batched call, and distributes per-item results. The latency
cost is bounded by ``max_wait_ms``. Grouping is by an explicit ``key``
(e.g. the ``max_num`` argument): items with different keys never share a
call; mixing shapes is the batch function's job (FaceAnalysis.get_batch
shape-buckets internally).

Shutdown protocol: ``_lock`` orders every enqueue against the close
sentinel, so no entry can ever land BEHIND the sentinel: the collector
serves everything already queued, then exits at the sentinel. A
``submit()`` racing ``close()`` either wins the lock (and is served) or
raises MicroBatcherClosed; it can never hang.

Host code only (the standard library), a copy of the JAX package's
``runtime/microbatch.py`` that this package keeps as its own.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

_SENTINEL = object()


class MicroBatcherClosed(RuntimeError):
    """submit() was called on a closed MicroBatcher."""


class MicroBatcher:
    """Coalesce concurrent `submit(item)` calls into `batch_fn(items)`.

    batch_fn: Callable[[List[item], **key_kwargs], Sequence[result]] —
        must return one result per item, in order.
    max_batch: hard cap on items per batched call.
    max_wait_ms: how long the collector waits for followers after the
        first item of a batch arrives. 0 still batches whatever is
        already queued (pure opportunistic coalescing).
    """

    def __init__(self, batch_fn: Callable[..., Sequence[Any]],
                 max_batch: int = 32, max_wait_ms: float = 4.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_fn = batch_fn
        self.max_batch = int(max_batch)
        # original constructor value, kept for exact same-args re-enable
        # checks (FaceAnalysis.enable_microbatch) — the clamped/scaled
        # max_wait_s does not round-trip through ms float math
        self.max_wait_ms = float(max_wait_ms)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        # observability + test oracle: how much coalescing actually happens
        self.n_items = 0
        self.n_batches = 0
        self.max_batch_seen = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # ---------------------------------------------------------------- API

    def submit(self, item: Any, key: Hashable = None,
               key_kwargs: Optional[Dict[str, Any]] = None,
               timeout: Optional[float] = None) -> Any:
        """Block until the batched call containing `item` completes and
        return this item's result (or raise the batch's exception).

        key: items batch together only when their keys are equal.
        key_kwargs: kwargs passed to batch_fn for this key's group (must
        be deterministic per key — the first seen wins for the group).
        timeout: seconds to wait for the result; raises
        concurrent.futures.TimeoutError past it. A waiter must never hang
        forever on a batch_fn that blocks or a daemon collector torn down
        at interpreter shutdown — pass a timeout wherever the caller has
        a latency bound (the webapp serving path does).
        """
        return self.submit_async(item, key, key_kwargs).result(
            timeout=timeout)

    def submit_async(self, item: Any, key: Hashable = None,
                     key_kwargs: Optional[Dict[str, Any]] = None) -> Future:
        """Non-blocking enqueue: returns the item's Future. Lets ONE
        caller thread land several items (e.g. the two images of a
        compare request) in the SAME batch window instead of serializing
        two windows through blocking submit()s."""
        fut: Future = Future()
        # the lock orders this enqueue against close()'s sentinel: either
        # we enqueue BEFORE the sentinel (guaranteed served) or we see
        # _closed and raise — a post-sentinel orphan is impossible
        with self._lock:
            if self._closed:
                raise MicroBatcherClosed("MicroBatcher is closed")
            self._q.put((item, key, dict(key_kwargs or {}), fut))
        return fut

    def close(self, join_timeout: float = 5.0, abort: bool = False) -> bool:
        """Stop accepting work. Default: everything already queued still
        gets served, then the collector exits. abort=True: queued entries
        that have not started a batch are FAILED with MicroBatcherClosed
        instead of served, so no waiter can stay blocked behind a stuck
        batch_fn at shutdown. Returns False when the collector is still
        draining a slow in-flight batch past `join_timeout` (it finishes
        and exits on its own — nothing is dropped or errored)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_SENTINEL)
            if abort:
                # fail everything still queued (the collector skips
                # cancelled/finished futures); entries already inside a
                # running batch_fn get their real result/exception
                drained = []
                while True:
                    try:
                        e = self._q.get_nowait()
                    except queue.Empty:
                        break
                    drained.append(e)
                for e in drained:
                    if e is _SENTINEL:
                        continue
                    e[3].set_exception(
                        MicroBatcherClosed("MicroBatcher aborted"))
                self._q.put(_SENTINEL)
        self._thread.join(timeout=join_timeout)
        return not self._thread.is_alive()

    # ---------------------------------------------------------- collector

    def _loop(self) -> None:
        while True:
            head = self._q.get()
            if head is _SENTINEL:
                return
            batch = [head]
            deadline = time.monotonic() + self.max_wait_s
            done = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    nxt = (self._q.get_nowait() if remaining <= 0
                           else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    done = True   # nothing can follow the sentinel
                    break
                batch.append(nxt)
            self._run(batch)
            if done:
                return

    def _run(self, entries: List) -> None:
        groups: Dict[Hashable, List] = {}
        for e in entries:
            groups.setdefault(e[1], []).append(e)
        for key_entries in groups.values():
            items = [e[0] for e in key_entries]
            kwargs = key_entries[0][2]
            try:
                results = self.batch_fn(items, **kwargs)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items")
            except BaseException as ex:   # noqa: BLE001 — deliver to waiters
                for e in key_entries:
                    e[3].set_exception(ex)
                continue
            self.n_items += len(items)
            self.n_batches += 1
            self.max_batch_seen = max(self.max_batch_seen, len(items))
            for e, r in zip(key_entries, results):
                e[3].set_result(r)
