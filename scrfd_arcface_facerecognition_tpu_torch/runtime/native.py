"""ctypes bindings to the native runtime (native/libsafr_native.so), the
part of them the gallery uses: the CRC-checked snapshot files and the
union-find.

The port's own copy of the JAX package's ``runtime/native.py`` (which also
binds the frame ring and the video decoder, left to later slices). It loads
the same library, built from ``native/src/*.cpp`` by ``make -C native`` at
first use, so both packages write and read the same snapshot files. Without
a toolchain each binding has the original's pure-Python fallback; the
snapshot fallback writes the original's npz container.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

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
