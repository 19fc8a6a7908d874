"""ctypes bindings to the native runtime: ``native/libsafr_native.so``
(the frame ring ``FramePipe``, the CRC-checked snapshot files, the
union-find) and ``native/libsafr_video.so`` (the ffmpeg decoder behind
``NativeVideoReader``).

The port's own copy of the JAX package's ``runtime/native.py``. It loads
the same libraries, built from ``native/src/*.cpp`` by ``make -C native``
at first use, so both packages write and read the same snapshot files.
Without a toolchain each binding has the original's pure-Python fallback;
the snapshot fallback writes the original's npz container. The video
library needs ffmpeg's development files and may not build (the Makefile
tolerates that); ``NativeVideoReader`` then raises and callers fall back
to cv2 (``runtime/video.py`` ``open_capture``).
"""
from __future__ import annotations

import ctypes
import os
import queue as _queue
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsafr_native.so")

_lib = None
_build_attempted = False
_lock = threading.Lock()


def build_native() -> bool:
    """Build libsafr_native.so via make. Returns True if the lib exists."""
    global _build_attempted
    with _lock:
        if os.path.exists(_LIB_PATH):
            return True
        if _build_attempted:
            return os.path.exists(_LIB_PATH)
        _build_attempted = True
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        return os.path.exists(_LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    # framepipe
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.fp_destroy.argtypes = [ctypes.c_void_p]
    lib.fp_push.restype = ctypes.c_int
    lib.fp_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_size_t, ctypes.c_int]
    lib.fp_pop.restype = ctypes.c_int
    lib.fp_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.fp_close.argtypes = [ctypes.c_void_p]
    lib.fp_size.restype = ctypes.c_int
    lib.fp_size.argtypes = [ctypes.c_void_p]
    lib.fp_closed.restype = ctypes.c_int
    lib.fp_closed.argtypes = [ctypes.c_void_p]
    # zero-copy ring API (absent from an older build of the library)
    try:
        lib.fp_reserve.restype = ctypes.c_void_p
        lib.fp_reserve.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fp_commit.argtypes = [ctypes.c_void_p]
        lib.fp_peek.restype = ctypes.c_void_p
        lib.fp_peek.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]
        lib.fp_release.argtypes = [ctypes.c_void_p]
        lib.fp_zero_copy = True
    except AttributeError:
        lib.fp_zero_copy = False
    # snapshot
    lib.gs_write.restype = ctypes.c_int
    lib.gs_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int64, ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int64)]
    lib.gs_read_header.restype = ctypes.c_int
    lib.gs_read_header.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.gs_read.restype = ctypes.c_int
    lib.gs_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.c_int64, ctypes.c_int64]
    # unionfind
    lib.uf_groups.restype = ctypes.c_int64
    lib.uf_groups.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


# ------------------------------------------------------------- frame pipe


class FramePipe:
    """Bounded single-producer single-consumer queue of byte frames
    (native when the library loads, a ``queue.Queue`` otherwise)."""

    def __init__(self, slot_bytes: int, n_slots: int = 16):
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._q = lib.fp_create(slot_bytes, n_slots)
            if not self._q:
                raise RuntimeError("fp_create failed")
        else:
            self._q = None
            self._pyq: _queue.Queue = _queue.Queue(maxsize=n_slots)
            self._closed = False

    def push(self, data: bytes, timeout_ms: int = 10000) -> bool:
        if self._q is not None:
            return bool(self._lib.fp_push(self._q, data, len(data),
                                          timeout_ms))
        if self._closed or len(data) > self.slot_bytes:
            return False
        try:
            self._pyq.put(bytes(data), timeout=timeout_ms / 1000)
            return True
        except _queue.Full:
            return False

    def pop(self, timeout_ms: int = 10000) -> Optional[bytes]:
        """One frame's bytes, or None when the pipe is closed and drained;
        TimeoutError when nothing came within ``timeout_ms``."""
        if self._q is not None:
            buf = ctypes.create_string_buffer(self.slot_bytes)
            rc = self._lib.fp_pop(self._q, buf, timeout_ms)
            if rc == 1:
                return buf.raw
            if rc == -1:
                return None
            raise TimeoutError("fp_pop timed out")
        # short slices, so a closed and drained pipe answers at once
        deadline = time.monotonic() + timeout_ms / 1000
        while True:
            try:
                return self._pyq.get(timeout=min(
                    0.05, max(deadline - time.monotonic(), 0.001)))
            except _queue.Empty:
                if self._closed:
                    return None
                if time.monotonic() >= deadline:
                    raise TimeoutError("pop timed out")

    # ---- zero-copy API (native only; callers check zero_copy first)

    @property
    def zero_copy(self) -> bool:
        return self._q is not None and getattr(self._lib, "fp_zero_copy",
                                               False)

    def reserve_view(self, timeout_ms: int = 10000) -> Optional[np.ndarray]:
        """Producer: a uint8 view of the next write slot (decode into it),
        or None on timeout or close. commit() publishes it."""
        ptr = self._lib.fp_reserve(self._q, timeout_ms)
        if not ptr:
            return None
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            (self.slot_bytes,))

    def commit(self) -> None:
        self._lib.fp_commit(self._q)

    def peek_view(self, timeout_ms: int = 10000):
        """Consumer: (rc, view); rc 1: the view is valid until
        release_slot(), rc 0: timeout, rc -1: closed and drained."""
        rc = ctypes.c_int()
        ptr = self._lib.fp_peek(self._q, timeout_ms, ctypes.byref(rc))
        if rc.value != 1 or not ptr:
            return rc.value, None
        view = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            (self.slot_bytes,))
        return 1, view

    def release_slot(self) -> None:
        self._lib.fp_release(self._q)

    def close(self) -> None:
        if self._q is not None:
            self._lib.fp_close(self._q)
        else:
            self._closed = True

    def size(self) -> int:
        if self._q is not None:
            return self._lib.fp_size(self._q)
        return self._pyq.qsize()

    def __del__(self):
        try:
            if getattr(self, "_q", None) is not None:
                self._lib.fp_destroy(self._q)
                self._q = None
        except (AttributeError, TypeError):
            pass     # interpreter shutdown: the library may be gone


# --------------------------------------------------------------- unionfind


def uf_group_roots(n: int, pairs: np.ndarray) -> np.ndarray:
    """(M, 2) int pair indices -> (n,) root per item (min-id root)."""
    pairs = np.ascontiguousarray(np.asarray(pairs, np.int64).reshape(-1, 2))
    lib = _load()
    if lib is not None:
        out = np.empty(n, np.int64)
        lib.uf_groups(
            n, pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(pairs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out
    # Python fallback
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            lo, hi = (ra, rb) if ra < rb else (rb, ra)
            parent[hi] = lo
    return np.asarray([find(i) for i in range(n)], np.int64)


# ---------------------------------------------------------------- snapshot


def snapshot_write(path: str, embeddings: np.ndarray, ids: np.ndarray) -> None:
    emb = np.ascontiguousarray(embeddings, np.float32)
    ids = np.ascontiguousarray(ids, np.int64)
    rows, dim = emb.shape
    lib = _load()
    if lib is not None:
        rc = lib.gs_write(path.encode(),
                          emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          rows, dim,
                          ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise IOError(f"gs_write failed: {rc}")
        return
    np.savez(path + ".npz", embeddings=emb, ids=ids)
    os.replace(path + ".npz", path)


def snapshot_read(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is not None:
        rows = ctypes.c_int64()
        dim = ctypes.c_int64()
        rc = lib.gs_read_header(path.encode(), ctypes.byref(rows),
                                ctypes.byref(dim))
        if rc != 0:
            raise IOError(f"gs_read_header failed: {rc}")
        emb = np.empty((rows.value, dim.value), np.float32)
        ids = np.empty(rows.value, np.int64)
        rc = lib.gs_read(path.encode(),
                         emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         rows.value, dim.value)
        if rc == -4:
            raise IOError("snapshot changed between header and payload "
                          "read (concurrent rewrite) — retry the load")
        if rc != 0:
            raise IOError(f"gs_read failed (corrupt snapshot?): {rc}")
        return emb, ids
    data = np.load(path, allow_pickle=False)
    return data["embeddings"], data["ids"]


# ------------------------------------------------------------ video decoder

_VIDEO_LIB_PATH = os.path.join(_NATIVE_DIR, "libsafr_video.so")
_video_lib = None
_video_build_attempted = False

# the decoder's colour conversion writes whole 16-pixel groups: a frame
# whose width is not a multiple of 16 gets up to 15 pixels (45 bytes)
# written past its end (24 bytes measured at widths 200-248); the reader
# decodes such frames into this much room beyond the frame
DECODE_SLACK = 64

# cv2's capture property ids (videoio's CAP_PROP_*), answered without cv2
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5


def _load_video():
    global _video_lib, _video_build_attempted
    if _video_lib is not None:
        return _video_lib
    if not os.path.exists(_VIDEO_LIB_PATH) and not _video_build_attempted:
        # build_native() stops once the core library exists, so the video
        # target needs its own make
        _video_build_attempted = True
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "video"],
                           check=False, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            pass
    if not os.path.exists(_VIDEO_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_VIDEO_LIB_PATH)
    except OSError:
        return None  # ffmpeg's runtime libraries are absent
    lib.vdec_open.restype = ctypes.c_void_p
    lib.vdec_open.argtypes = [ctypes.c_char_p]
    lib.vdec_info.restype = ctypes.c_int
    lib.vdec_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_double)]
    lib.vdec_read.restype = ctypes.c_int
    lib.vdec_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64]
    lib.vdec_close.argtypes = [ctypes.c_void_p]
    _video_lib = lib
    return lib


class NativeVideoReader:
    """File or RTSP URL -> BGR24 uint8 frames through the ffmpeg decoder.

    The surface of a cv2 capture (``read() -> (ok, frame)``, ``get``,
    ``isOpened``, ``release``), so ``BatchedFrameReader`` and the realtime
    app take either. Construction raises RuntimeError when the decoder
    library is unavailable. ``get`` answers width, height and fps by cv2's
    numeric property ids itself, so it needs no cv2.
    """

    def __init__(self, source: str):
        lib = _load_video()
        if lib is None:
            raise RuntimeError("libsafr_video.so unavailable")
        self._lib = lib
        self._h = lib.vdec_open(str(source).encode())
        if not self._h:
            raise RuntimeError(f"cannot open video source: {source}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        lib.vdec_info(self._h, ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(fps))
        self.width, self.height, self.fps = w.value, h.value, fps.value

    def _decode(self, buf: np.ndarray) -> bool:
        rc = self._lib.vdec_read(
            self._h, buf.ctypes.data_as(ctypes.c_void_p),
            self.height * self.width * 3)
        return rc == 1

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if self._h is None:
            return False, None
        need = self.height * self.width * 3
        buf = np.empty(need + DECODE_SLACK, np.uint8)
        if self._decode(buf):
            return True, buf[:need].reshape(self.height, self.width, 3)
        return False, None

    def read_into(self, buf: np.ndarray) -> bool:
        """Decode the next frame into ``buf`` (uint8, C-contiguous, at
        least height * width * 3 bytes), e.g. a ring slot: straight in
        where the decoder writes no further than the frame (a width that
        is a multiple of 16), else through a buffer with room and one
        copy."""
        if self._h is None:
            return False
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("read_into needs a C-contiguous buffer")
        need = self.height * self.width * 3
        if buf.nbytes < need:
            raise ValueError(f"buffer too small: {buf.nbytes} < {need}")
        if self.width % 16 == 0:
            return self._decode(buf)
        room = np.empty(need + DECODE_SLACK, np.uint8)
        if not self._decode(room):
            return False
        buf.reshape(-1)[:need] = room[:need]
        return True

    def isOpened(self) -> bool:  # cv2's name
        return self._h is not None

    def get(self, prop) -> float:
        return {CAP_PROP_FRAME_WIDTH: float(self.width),
                CAP_PROP_FRAME_HEIGHT: float(self.height),
                CAP_PROP_FPS: float(self.fps)}.get(prop, 0.0)

    def release(self) -> None:
        if self._h is not None:
            self._lib.vdec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.release()
        except (AttributeError, TypeError):
            pass     # interpreter shutdown: the library may be gone
