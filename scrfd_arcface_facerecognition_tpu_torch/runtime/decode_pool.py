"""Multi-process video decode pool: N cameras -> shared memory -> batches.

The port's own copy of the JAX package's ``runtime/decode_pool.py``.
Decoding runs in worker processes, outside the consumer's interpreter
lock: each worker decodes its streams' frames straight into slots of one
shared-memory block (``read_into`` where the capture has it, else one copy
of the frame), and only slot indices cross between processes, through
small per-stream queues. The consumer copies each round's frames out of
the slots into one (n_live, H, W, 3) uint8 batch.

Each stream owns a fixed quota of slots and its own free / filled FIFO
pair, so a fast camera cannot take a slow one's slots, and a stream's
frames arrive in order.

Iteration yields ``(batch, stream_ids)``, one frame of every stream in the
round, as ``runtime/video.py`` ``MultiStreamReader`` does. A stream that
ends, or stalls past ``timeout_ms`` after it has delivered, drops out;
iteration ends when none is left.

A stream that has not delivered yet is connecting. Within ``timeout_ms``
of the pool's start it holds a round, so the first round of cameras that
open together is complete. After that it holds none: a round is served as
soon as every stream that has delivered has delivered again, and the
connecting stream joins the round after its first frame. It drops out if
its worker dies or ``startup_timeout_ms`` passes. (The JAX pool makes
every round wait out ``timeout_ms`` while a stream connects, so one
camera that never connects holds the healthy ones to one round per
timeout.)

Workers start through the ``forkserver`` method (``spawn`` where it is
missing) with an empty preload list: a process that has initialized CUDA
must not fork. A worker imports numpy and this package's ``runtime``
modules, never torch (the package's exports load on first use). As with
any spawn or forkserver start, the calling script needs the
``if __name__ == "__main__":`` guard.

``opener`` turns a source into a cv2-shaped capture inside the worker
(``read() -> (ok, frame)``, ``release()``; ``read_into`` / ``height`` /
``width`` and ``fps`` or ``get(5)`` where it has them). ``None`` means
``runtime.video.open_capture``. Anything else must pickle by reference: a
function defined at the top level of an importable module.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue as _queue
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _decode_into(cap, buf: np.ndarray, slot: int,
                 slot_bytes: int) -> Tuple[bool, int, int]:
    """Decode one frame into shared-memory slot ``slot``; -> (ok, h, w)."""
    view = buf[slot * slot_bytes:(slot + 1) * slot_bytes]
    read_into = getattr(cap, "read_into", None)
    if read_into is not None:
        h, w = cap.height, cap.width
        if h * w * 3 > slot_bytes:
            _warn_oversize(h, w, slot_bytes)
            return False, 0, 0
        ok = read_into(view[:h * w * 3].reshape(h, w, 3))
        return (True, h, w) if ok else (False, 0, 0)
    ok, frame = cap.read()
    if not ok or frame is None:
        return False, 0, 0
    h, w = frame.shape[:2]
    n = h * w * 3
    if n > slot_bytes:
        _warn_oversize(h, w, slot_bytes)
        return False, 0, 0
    np.copyto(view[:n].reshape(h, w, 3), frame)
    return True, h, w


def _warn_oversize(h: int, w: int, slot_bytes: int) -> None:
    # an end of stream with no word would look like an empty source
    logger.error(
        "decode pool: %dx%d frame needs %d bytes but slot_bytes=%d; the "
        "stream drops out; construct DecodePool with slot_bytes >= the "
        "largest source's h*w*3 (CLI: --slot-bytes)",
        w, h, h * w * 3, slot_bytes)


def _stream_fps(cap) -> float:
    """The source's frame rate (``fps``, else cv2's CAP_PROP_FPS = 5),
    24 where neither gives one."""
    fps = float(getattr(cap, "fps", 0.0) or 0.0)
    if fps <= 0:
        try:
            fps = float(cap.get(5))
        except Exception:       # a capture without get(): no rate known
            fps = 0.0
    return fps if fps > 0 else 24.0


def _release(cap) -> None:
    try:
        cap.release()
    except Exception:           # a capture's own release fault ends nothing
        pass


def _worker_main(sources: Sequence, stream_ids: Sequence[int],
                 shm_name: str, slot_bytes: int, free_qs: Dict,
                 filled_qs: Dict, stop_evt, opener: Optional[Callable]):
    """One worker's decode loop.

    Round-robins its streams. Per frame: a slot from the stream's own free
    queue (a short wait, then the next stream, so one backlogged stream
    never starves the others), the frame decoded into it, (slot, h, w,
    fps) on the stream's filled queue. A stream that ends, or whose source
    does not open, puts None once and leaves the rotation.
    """
    from multiprocessing import shared_memory

    if opener is None:
        from .video import open_capture as opener

    shm = shared_memory.SharedMemory(name=shm_name)
    buf = np.frombuffer(shm.buf, np.uint8)
    try:
        live: Dict[int, object] = {}
        fps_map: Dict[int, float] = {}
        for sid, src in zip(stream_ids, sources):
            try:
                live[sid] = opener(src)
                fps_map[sid] = _stream_fps(live[sid])
            except Exception:   # a source that does not open ends its stream
                logger.warning("decode pool: could not open %r", src,
                               exc_info=True)
                live.pop(sid, None)
                filled_qs[sid].put(None)
        while live and not stop_evt.is_set():
            for sid in list(live):
                cap = live[sid]
                try:
                    slot = free_qs[sid].get(timeout=0.05)
                except _queue.Empty:
                    continue    # the consumer lags on this stream
                ok, h, w = _decode_into(cap, buf, slot, slot_bytes)
                if not ok:
                    free_qs[sid].put(slot)
                    _release(cap)
                    del live[sid]
                    filled_qs[sid].put(None)
                    continue
                filled_qs[sid].put((slot, h, w, fps_map[sid]))
        for sid, cap in live.items():
            _release(cap)
            filled_qs[sid].put(None)
    finally:
        buf = None  # noqa: F841  (the view must go before close)
        try:
            shm.close()
        except BufferError:
            pass


class DecodePool:
    """N video sources decoded by worker processes into shared memory.

    workers: decode processes (default min(n_sources, cpu_count)).
    slots_per_stream: each stream's in-flight frame quota (default 4).
    slot_bytes: a slot's capacity (default 1080p BGR); a larger frame
    ends its stream with an error logged.
    timeout_ms: how long a round waits for a stream that has delivered.
    startup_timeout_ms: how long a stream may take to deliver its first
    frame while its worker is alive.
    opener: source -> cv2-shaped capture, run in the worker (see the
    module's docstring); None is ``runtime.video.open_capture``.
    """

    def __init__(self, sources: Sequence, workers: Optional[int] = None,
                 slot_bytes: Optional[int] = None,
                 slots_per_stream: int = 4, timeout_ms: int = 10000,
                 startup_timeout_ms: int = 120000,
                 start_method: Optional[str] = None,
                 opener: Optional[Callable] = None):
        from multiprocessing import shared_memory

        n = len(sources)
        if n == 0:
            raise ValueError("DecodePool needs at least one source")
        self.timeout_ms = timeout_ms
        self.startup_timeout_ms = max(startup_timeout_ms, timeout_ms)
        self.n_streams = n
        workers = max(1, min(workers or (os.cpu_count() or 1), n))
        slot_bytes = slot_bytes or 1920 * 1080 * 3
        self.slot_bytes = slot_bytes
        self.slots_per_stream = slots_per_stream

        if start_method is None:
            start_method = ("forkserver"
                            if "forkserver" in mp.get_all_start_methods()
                            else "spawn")
        if start_method == "fork":
            raise ValueError("DecodePool does not fork: a parent that "
                             "holds CUDA state must not (use forkserver or "
                             "spawn)")
        ctx = mp.get_context(start_method)
        if start_method == "forkserver":
            # the server's default preload list is ['__main__'], which
            # would run the caller's script in the server; a worker
            # imports what it needs itself
            ctx.set_forkserver_preload([])

        self._shm = shared_memory.SharedMemory(
            create=True, size=slot_bytes * slots_per_stream * n)
        self._buf = np.frombuffer(self._shm.buf, np.uint8)
        # stream sid owns slots [sid * q, (sid + 1) * q) and its own
        # free / filled FIFO pair
        self._free_qs = {sid: ctx.Queue() for sid in range(n)}
        self._filled_qs = {sid: ctx.Queue() for sid in range(n)}
        for sid in range(n):
            for k in range(slots_per_stream):
                self._free_qs[sid].put(sid * slots_per_stream + k)
        self._stop = ctx.Event()
        self._procs: List = []
        self._proc_of: Dict[int, object] = {}
        self._closed = False

        assign: List[Tuple[List, List[int]]] = [([], [])
                                                for _ in range(workers)]
        for sid, src in enumerate(sources):
            assign[sid % workers][0].append(src)
            assign[sid % workers][1].append(sid)
        self._t0 = time.monotonic()
        for srcs, sids in assign:
            if not srcs:
                continue
            p = ctx.Process(
                target=_worker_main,
                args=(srcs, sids, self._shm.name, slot_bytes,
                      {s: self._free_qs[s] for s in sids},
                      {s: self._filled_qs[s] for s in sids},
                      self._stop, opener),
                daemon=True)
            p.start()
            self._procs.append(p)
            for s in sids:
                self._proc_of[s] = p
        self.n_workers = len(self._procs)
        # seconds the workers' start calls took, and from the pool's start
        # to its first round
        self.start_s = time.monotonic() - self._t0
        self.first_round_s: Optional[float] = None
        self.frames_out = 0
        # each stream's own frame size (h, w) and rate, from its first
        # frame: a writer needs the stream's size, not the batch's
        self.stream_dims: Dict[int, Tuple[int, int]] = {}
        self.stream_fps: Dict[int, float] = {}

    # ------------------------------------------------------------ consume

    def _holds(self, sid: int, started: set, now: float) -> bool:
        """Whether a round waits for ``sid``: a stream that has delivered
        does; a connecting one only within timeout_ms of the pool's
        start."""
        return sid in started or now < self._t0 + self.timeout_ms / 1000

    def __iter__(self):
        live = set(range(self.n_streams))
        started: set = set()    # streams that have delivered (or ended)
        hard_deadline = self._t0 + self.startup_timeout_ms / 1000
        while live:
            got: Dict[int, Tuple[int, int, int, float]] = {}
            # every live stream is waited on at once, against one deadline
            # for the round, so several stalled cameras cost one timeout
            pending = set(live)
            deadline = time.monotonic() + self.timeout_ms / 1000
            while pending:
                progressed = False
                for sid in sorted(pending):
                    try:
                        msg = self._filled_qs[sid].get_nowait()
                    except _queue.Empty:
                        continue
                    progressed = True
                    pending.discard(sid)
                    started.add(sid)
                    if msg is None:
                        live.discard(sid)       # the stream ended
                    else:
                        got[sid] = msg
                if not pending:
                    break
                now = time.monotonic()
                # a stream whose worker is gone (its last messages read)
                # never delivers; a connecting one has until the startup
                # deadline
                lost = {s for s in pending
                        if (not self._proc_of[s].is_alive()
                            and self._filled_qs[s].empty())
                        or (s not in started and now >= hard_deadline)}
                if now >= deadline:
                    lost |= {s for s in pending if s in started}
                live -= lost
                pending -= lost
                if not pending:
                    break
                if got and (now >= deadline or not any(
                        self._holds(s, started, now) for s in pending)):
                    # serve what came; connecting streams join a later
                    # round
                    break
                if not progressed:
                    time.sleep(0.005)
            if not got:
                return          # every remaining stream ended or stalled
            yield self._assemble(got)

    def _assemble(self, got):
        ready = sorted(got)
        for s in ready:
            self.stream_dims.setdefault(s, (got[s][1], got[s][2]))
            self.stream_fps.setdefault(s, got[s][3])
        h = max(got[s][1] for s in ready)
        w = max(got[s][2] for s in ready)
        batch = np.zeros((len(ready), h, w, 3), np.uint8)
        for bi, sid in enumerate(ready):
            slot, fh, fw, _ = got[sid]
            start = slot * self.slot_bytes
            batch[bi, :fh, :fw] = self._buf[start:start + fh * fw * 3
                                            ].reshape(fh, fw, 3)
            self._free_qs[sid].put(slot)
        self.frames_out += len(ready)
        if self.first_round_s is None:
            self.first_round_s = time.monotonic() - self._t0
        # no view of the shared memory outlives this call: a suspended
        # generator holding one would keep the block exported past
        # release()
        return batch, ready

    @property
    def aggregate_fps(self) -> float:
        dt = time.monotonic() - self._t0
        return self.frames_out / dt if dt > 0 else 0.0

    # ------------------------------------------------------------ cleanup

    def release(self, join_timeout: float = 5.0):
        """Stop the workers and join them (terminating those past
        ``join_timeout``), then free the shared memory."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        deadline = time.monotonic() + join_timeout
        # drain the filled queues so a worker blocked on a put can leave
        while any(p.is_alive() for p in self._procs) \
                and time.monotonic() < deadline:
            for sid in range(self.n_streams):
                try:
                    self._filled_qs[sid].get_nowait()
                except _queue.Empty:
                    pass
            for p in self._procs:
                p.join(timeout=0.02)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        self._buf = None
        try:
            self._shm.close()
        except BufferError:
            pass                # a caller still holds a view; unlink anyway
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __del__(self):
        try:
            self.release(join_timeout=1.0)
        except Exception:       # interpreter shutdown: nothing to report to
            pass
