"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` exports a plain C launch function and
is compiled with nvcc for Hopper (``sm_90a``) into its own shared library
under ``build/torch_kernels/`` at the repository root, then loaded with
ctypes. Nothing here runs at import time: a library is built at its first
use, or ahead of time with ``build_all()``, which starts one nvcc per
source, all at once. The file name carries a hash of the source and the
flags, so an edited source is never served by a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "warp_align": "warp_align.cu",
    "pq_adc": "pq_adc.cu",
    "warp_band": "warp_band.cu",
    "conv3x3": "conv3x3.cu",
}

# --fmad=false: the kernels round every product and sum on its own, as the
# plain PyTorch versions they are held against do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own toolkit lookup (CUDA_HOME, CUDA_PATH, the default
    # install location)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> Path:
    return CSRC_DIR / SOURCES[name]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    running build (process, temporary output, final output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, build) -> None:
    if build is None:
        return
    proc, tmp, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> Dict[str, float]:
    """Build every kernel, one nvcc per source, all started together;
    returns the seconds each build took (0.0 for one already built)."""
    t0 = time.perf_counter()
    builds = {n: _start_build(n) for n in SOURCES}
    secs = {}
    try:
        for n, b in builds.items():
            _finish_build(n, b)
            secs[n] = 0.0 if b is None else time.perf_counter() - t0
    finally:
        # a failed build leaves no other nvcc running behind it
        for b in builds.values():
            if b is not None and b[0].poll() is None:
                b[0].kill()
                b[0].wait()
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        _finish_build(name, _start_build(name))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
