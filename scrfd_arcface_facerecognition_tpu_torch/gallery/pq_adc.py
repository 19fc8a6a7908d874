"""PQ asymmetric-distance scores: the wrapper of kernel K2.

Counterpart of the JAX package's Pallas kernel ``adc_scores_mxu``
(``gallery/pq.py``). ``score[q, g] = sum_m lut[q, m, codes[g, m]]``, summed
in f32 in the order m = 0..M-1. The CUDA kernel (``csrc/pq_adc.cu``) looks
the entries up in shared memory; its source note gives its bound on an H100
and its design.

Precision, as ``PQGallery.search`` names it:

- ``"hilo"``: the exact f32 LUT (the TPU's hi/lo bf16 split approximates
  it);
- ``"hi"``: the LUT rounded to bf16 (round to nearest even) and summed in
  f32, the sum the TPU's single bf16 pass takes.

``pq_adc_scores`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``adc_scores_plain``) for CPU tensors, and only for them;
there is no fallback from one to the other. ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

NAME = "pq_adc"
PRECISIONS = ("hilo", "hi")
launches = 0
_launch_fn = None


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"pq_adc: precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")


def adc_scores_plain(lut: torch.Tensor, codes: torch.Tensor,
                     precision: str = "hilo") -> torch.Tensor:
    """The plain version: a scan over the M subspaces.

    lut (Q, M, K) f32, codes (G, M) u8 -> (Q, G) f32. The live state is one
    (Q, G) accumulator and one (G,) index column; a one-shot gather would
    hold (Q, M, G).
    """
    _check_precision(precision)
    if precision == "hi":
        lut = lut.to(torch.bfloat16).to(torch.float32)
    q, m, _ = lut.shape
    acc = torch.zeros((q, codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for j in range(m):
        acc = acc + lut[:, j].index_select(1, codes[:, j].long())
    return acc


def launch_function(lib: ctypes.CDLL):
    """``pq_adc_launch`` of a library built from ``csrc/pq_adc.cu``, typed
    for ctypes."""
    fn = lib.pq_adc_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind():
    """The C launch function, built and loaded at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ..cuda_build import library

        _launch_fn = launch_function(library(NAME))
    return _launch_fn


def pq_adc_scores(lut: torch.Tensor, codes: torch.Tensor,
                  precision: str = "hilo") -> torch.Tensor:
    """(Q, M, K) f32 LUTs x (G, M) u8 codes -> (Q, G) f32 scores.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise. Codes must be < K.
    """
    _check_precision(precision)
    if lut.device.type == "cpu":
        return adc_scores_plain(lut, codes, precision)
    if lut.device.type != "cuda":
        raise ValueError(f"pq_adc: unsupported device {lut.device}")
    if lut.dtype != torch.float32 or lut.dim() != 3:
        raise ValueError("pq_adc: lut must be (Q, M, K) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    q, m, k = lut.shape
    if (codes.dtype != torch.uint8 or codes.dim() != 2
            or codes.shape[1] != m):
        raise ValueError(f"pq_adc: codes must be (G, {m}) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if codes.device != lut.device:
        raise ValueError("pq_adc: lut and codes on different devices")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_adc: inputs must be contiguous")
    if k > 256:
        raise ValueError(f"pq_adc: K={k} > 256 does not fit uint8 codes")
    g = codes.shape[0]
    out = torch.empty((q, g), dtype=torch.float32, device=lut.device)
    if q == 0 or g == 0:
        return out
    fn = _bind()
    # the C launcher works on the current device (the launch, and any
    # shared-memory attribute or limit it sets or reads): make the tensor's
    # device current, so that a shard on another card is launched there
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        rc = fn(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), q, m, k,
                g, int(precision == "hi"), stream)
    if rc != 0:
        raise RuntimeError(f"pq_adc kernel launch failed: CUDA error {rc} "
                           f"(Q={q}, M={m}, K={k}, G={g}, {precision})")
    global launches
    launches += 1
    return out
