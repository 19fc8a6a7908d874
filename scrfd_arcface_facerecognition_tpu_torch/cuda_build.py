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
from typing import Dict, Tuple

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


def nvcc_command(src: Path, out: Path) -> list:
    """The nvcc command that builds the source ``src`` into the shared
    library ``out``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def _compile(jobs: Dict[str, Tuple[Path, Path]]) -> Dict[str, float]:
    """Run nvcc on each job's (source, shared library), all started
    together; returns the seconds until each one finished. Raises on the
    first failure, and leaves no nvcc running behind it."""
    t0 = time.perf_counter()
    procs, secs = {}, {}
    try:
        for what, (src, out) in jobs.items():
            procs[what] = subprocess.Popen(nvcc_command(src, out),
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)
        for what, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {what} "
                                   f"(exit {proc.returncode}):\n{log}")
            secs[what] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return secs


def _build(names) -> Dict[str, float]:
    """Build the named kernels whose libraries do not exist yet, each into
    a temporary file moved into place once it is whole."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = {n: out.with_suffix(f".{os.getpid()}.tmp")
           for n, out in todo.items()}
    secs = _compile({n: (source_path(n), tmp[n]) for n in todo})
    for n, out in todo.items():
        os.replace(tmp[n], out)
    return {n: secs.get(n, 0.0) for n in names}


def build_all() -> Dict[str, float]:
    """Build every kernel, one nvcc per source, all started together;
    returns the seconds each build took (0.0 for one already built)."""
    return _build(SOURCES)


def build_variants(name: str, sources: Dict[str, str]) -> Dict[str, Path]:
    """Build edited copies of kernel ``name``'s source (variant name ->
    source text) into ``BUILD_DIR/ablate/``, one nvcc each, all started
    together; returns each variant's shared library."""
    out = BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for v, text in sources.items():
        cu = out / f"{name}_{v}.cu"
        cu.write_text(text)
        jobs[v] = (cu, (out / f"lib{name}_{v}.so").resolve())
    _compile({f"{name} variant {v}": job for v, job in jobs.items()})
    return {v: lib for v, (_, lib) in jobs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        _build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
