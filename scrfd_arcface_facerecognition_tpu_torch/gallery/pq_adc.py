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

``pq_adc_topk`` is a search's top-k over one shard's codes, in two
calls that a caller may time apart: ``adc_candidates`` scores and
``merge_candidates`` selects. On the card, for k up to ``KMAX``, the
selection is fused into K2: the kernel tests each score of its final slab
against its warp's running k-th best, under the row mask, and keeps no
(Q, G) scores; a second small kernel merges the warps' lists.
``topk_launches`` counts the fused kernel's launches. A larger k, and CPU
tensors, take the chain (``topk_plain``): the scores, invalid rows to
-inf, a stable descending top-k. Both give the same answer bit for bit,
ties and NaNs in the same order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.nms import stable_top_k

NAME = "pq_adc"
PRECISIONS = ("hilo", "hi")
KMAX = 32              # the fused top-k's k at most: one list entry a lane
launches = 0
topk_launches = 0
_launch_fn = None
_topk_fns = None


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


def _check_inputs(lut: torch.Tensor, codes: torch.Tensor) -> None:
    """What the kernel takes: (Q, M, K) f32 LUTs and (G, M) u8 codes,
    contiguous, on one device, K <= 256."""
    if lut.dtype != torch.float32 or lut.dim() != 3:
        raise ValueError("pq_adc: lut must be (Q, M, K) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    m, k = lut.shape[1], lut.shape[2]
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
    _check_inputs(lut, codes)
    q, m, k = lut.shape
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


class Candidates(NamedTuple):
    """One shard's candidates for a search's top k, between the scoring
    and the merge.

    Fused (the card, k <= KMAX): each warp's list of its k best, ``s``
    (Q, lists, k) f32 and ``rows`` (Q, lists, k) int32 (rows of the
    codes), ``valid`` None. Otherwise: every row's score ``s`` (Q, G),
    ``rows`` None, and the (G,) bool ``valid`` that the merge applies.
    ``k``: the answers a query gets, min(k, G)."""
    s: torch.Tensor
    rows: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    k: int


def topk_functions(lib: ctypes.CDLL):
    """``pq_adc_topk_sizes``, ``pq_adc_topk_launch`` and
    ``pq_topk_merge_launch`` of a library built from ``csrc/pq_adc.cu``,
    typed for ctypes."""
    sizes = lib.pq_adc_topk_sizes
    fused, merge = lib.pq_adc_topk_launch, lib.pq_topk_merge_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    sizes.argtypes = [p, i, i, i, ll, i, ip, ip]
    fused.argtypes = [p, p, p, p, i, p, p, i, i, i, ll, i, i, i, p]
    merge.argtypes = [p, p, i, i, i, i, ll, p, p, p]
    sizes.restype = fused.restype = merge.restype = ctypes.c_int
    return sizes, fused, merge


def _bind_topk():
    """The fused top-k's C functions, built and loaded at first use."""
    global _topk_fns
    if _topk_fns is None:
        from ..cuda_build import library

        _topk_fns = topk_functions(library(NAME))
    return _topk_fns


def adc_candidates(lut: torch.Tensor, codes: torch.Tensor,
                   valid: torch.Tensor, k: int, precision: str = "hilo"
                   ) -> Candidates:
    """The scoring half of ``pq_adc_topk``: (Q, M, K) f32 LUTs x (G, M)
    u8 codes, (G,) bool ``valid`` -> the shard's ``Candidates``.

    CUDA tensors with 1 <= k <= KMAX launch K2 with the selection fused in
    (on the current stream, or raise); otherwise the scores of every row
    (``pq_adc_scores``: K2 on the card, its plain version on the CPU).
    Codes must be < K."""
    _check_precision(precision)
    if k < 0:
        raise ValueError(f"pq_adc_topk: k must be >= 0, got {k}")
    g = codes.shape[0]
    if lut.device.type != "cuda" or not 1 <= k <= KMAX:
        return Candidates(pq_adc_scores(lut, codes, precision), None, valid,
                          min(k, g))
    _check_inputs(lut, codes)
    if (valid.dtype != torch.bool or valid.shape != (g,)
            or valid.device != lut.device or not valid.is_contiguous()):
        raise ValueError(f"pq_adc_topk: valid must be a contiguous ({g},) "
                         f"bool tensor on {lut.device}, got "
                         f"{tuple(valid.shape)} {valid.dtype} on "
                         f"{valid.device}")
    if g >= 2 ** 31 - 1:
        raise ValueError(f"pq_adc_topk: G={g} rows do not fit int32 rows")
    q, m, kt = lut.shape
    sizes, fused, _ = _bind_topk()
    hi = int(precision == "hi")
    part_rows, lists = ctypes.c_int(0), ctypes.c_int(0)
    # the launches work on the current device: make the tensors' current
    with torch.cuda.device(lut.device):
        rc = sizes(codes.data_ptr(), q, m, kt, g, hi, ctypes.byref(part_rows),
                   ctypes.byref(lists))
        if rc != 0:
            raise RuntimeError(f"pq_adc top-k sizes failed: CUDA error {rc} "
                               f"(Q={q}, M={m}, K={kt}, G={g}, {precision})")
        part = torch.empty((part_rows.value, g), dtype=torch.float32,
                           device=lut.device)
        cand_s = torch.empty((q, lists.value, k), dtype=torch.float32,
                             device=lut.device)
        cand_i = torch.empty((q, lists.value, k), dtype=torch.int32,
                             device=lut.device)
        if q == 0 or g == 0:
            return Candidates(cand_s, cand_i, None, min(k, g))
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        rc = fused(lut.data_ptr(), codes.data_ptr(), valid.data_ptr(),
                   part.data_ptr(), part_rows.value, cand_s.data_ptr(),
                   cand_i.data_ptr(), q, m, kt, g, hi, k, lists.value,
                   stream)
    if rc != 0:
        raise RuntimeError(f"pq_adc top-k launch failed: CUDA error {rc} "
                           f"(Q={q}, M={m}, K={kt}, G={g}, k={k}, "
                           f"{precision})")
    global topk_launches
    topk_launches += 1
    return Candidates(cand_s, cand_i, None, min(k, g))


def merge_candidates(c: Candidates, row_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selecting half of ``pq_adc_topk``: a shard's ``Candidates`` ->
    the (Q, c.k) best scores and their rows + ``row_offset`` (int64), NaN
    first, then the higher score, then the lower row. The fused lists are
    merged by ``pq_topk_merge`` on the card; the scores of every row have
    the invalid rows set to -inf and take a stable descending top-k."""
    if c.rows is None:
        s, i = stable_top_k(torch.where(c.valid[None], c.s, -torch.inf),
                            c.k)
        return s, i + row_offset
    q, lists, k = c.s.shape
    top_s = torch.empty((q, c.k), dtype=torch.float32, device=c.s.device)
    top_i = torch.empty((q, c.k), dtype=torch.int64, device=c.s.device)
    if q == 0 or c.k == 0:
        return top_s, top_i
    _, _, merge = _bind_topk()
    with torch.cuda.device(c.s.device):
        stream = torch.cuda.current_stream(c.s.device).cuda_stream
        rc = merge(c.s.data_ptr(), c.rows.data_ptr(), q, lists, k, c.k,
                   row_offset, top_s.data_ptr(), top_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pq_topk merge launch failed: CUDA error {rc} "
                           f"(Q={q}, lists={lists}, k={k})")
    return top_s, top_i


def pq_adc_topk(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                k: int, precision: str = "hilo", row_offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, M, K) f32 LUTs x (G, M) u8 codes, (G,) bool ``valid`` -> the
    (Q, min(k, G)) best scores and their rows + ``row_offset`` (int64):
    ``adc_candidates`` then ``merge_candidates``. On the card, k <= KMAX
    is the top-k fused into K2."""
    return merge_candidates(adc_candidates(lut, codes, valid, k, precision),
                            row_offset)


def topk_plain(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
               k: int, precision: str = "hilo", row_offset: int = 0,
               scores=adc_scores_plain) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain the fused top-k replaces, on any device: ``scores(lut,
    codes, precision)``, rows whose ``valid`` is False to -inf, a stable
    descending top-k of min(k, G), rows + ``row_offset``. The default
    scorer is the plain version, independent of K2; ``pq_adc_scores``
    gives the unfused search's path on the card."""
    return merge_candidates(Candidates(
        scores(lut, codes, precision), None, valid,
        min(k, codes.shape[0])), row_offset)
