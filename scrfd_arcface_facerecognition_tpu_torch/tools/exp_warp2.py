"""Kernel K3: the 5-pass band-mix face warp, and its experiment's path.

Counterpart of the JAX repository's ``tools/exp_warp2.py`` (Pallas
``warp_crops_band``, body ``_band_kernel`` / ``_band_mix``), the production
warp's predecessor: the similarity warp of each crop as five resampling
passes over a Q x Q working canvas,

    scale-y(sigma), scale-x(sigma), shear-x(u), shear-y(v), shear-x(u),

each a hat-weighted mix of an aligned band of source rows,

    dst[i, l] = sum_r max(0, 1 - |pos(i, l) - r|) * src[r, l],
    pos(i, l) = alpha * i + beta * l + gamma,

over the rows r of the band [j0, j0 + band) that each 8-row output group
reads. The bands (32 / 40 / 48 / 72 / 48 rows) truncate the taps of crops
outside the envelope (``WarpParams.fallback``), and the passes differ from
single-pass bilinear by O(tan phi) in tap placement, so K3's contract is
the five passes themselves, not K1's exact warp.

``warp_crops_band`` launches the CUDA kernel (``csrc/warp_band.cu``, all
five passes in one launch, one block per crop) for CUDA
tensors and runs the plain PyTorch version (``warp_crops_band_plain``, a
transcription of ``_band_mix``) for CPU tensors, and only for them.
``launches`` counts the kernel's launches. ``fused_plan`` states the
window arithmetic the kernel relies on to keep the passes in shared
memory: which positions of each pass the crop depends on, and which p3
rows each pass-4 group reads from the kernel's ring of ``RING`` rows.

The script's path: ``make_workload`` (the same numpy draws as the JAX
script, so one seed gives both packages the same frames and matrices),
``check`` (K3 against the exact bilinear warp) and ``run`` / ``main``
(K3 against the port's production warp K1 at 16 x 1080p frames and 320
crops, timed on the card)::

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_warp2 [--check]
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.resize import letterbox, tight_letterbox_plan
from ..ops.warp import invert_affine, warp_affine_flat
from ..ops.warp_align import warp_align_crops
from ..ops.warp_params import (C0, CQ, LANE_OFF, OUT, PW, Q, SIGMA_MAX,
                               WarpParams, _f32_to_i64, planarize,
                               prepare_warp_params)
from . import device_ms

NAME = "warp_band"
G = 8                # output rows per band-mix group
BAND_SRC = 32        # pass-1 band (u8 source, 16-aligned)
BAND_SCALE = 40      # pass-2 band (8-aligned)
BAND_HX = 48         # shear-x bands (passes 3 and 5)
BAND_VY = 72         # shear-y band (pass 4)
# the fused kernel's ring of p3 rows y: one pass-4 window, since a group's
# rows are produced only after the group before it has read the ring
RING = BAND_VY
G4 = LANE_OFF // G   # the first pass-4 group whose rows the crop keeps (5)
NG4 = OUT // G       # pass-4 groups the crop keeps (14)
PLAN_COLS = 8 + 2 * NG4
launches = 0
_launch_fn = None
_occupancy_fn = None

RowsOf = Callable[[torch.Tensor], torch.Tensor]


def band_start(alpha: torch.Tensor, beta_min: torch.Tensor,
               gamma: torch.Tensor, base: torch.Tensor, src_rows: int,
               band: int, align: int) -> torch.Tensor:
    """The band start j0 of the groups whose first output row is ``base``:
    floor((alpha * base + beta_min) + gamma) - 1 in f32 (converted as XLA
    converts: saturating, NaN to 0), clipped to [0, src_rows - band] and
    aligned down to ``align``; int64, broadcast over the arguments."""
    j0 = _f32_to_i64(torch.floor(alpha * base + beta_min + gamma)) - 1
    j0 = j0.clamp(0, max(src_rows - band, 0))
    return torch.div(j0, align, rounding_mode="floor") * align


def _band_mix(rows_of: RowsOf, n_out: int, src_rows: int, width: int,
              band: int, alpha: torch.Tensor, beta: torch.Tensor,
              gamma: torch.Tensor, align: int) -> torch.Tensor:
    """One band-mix pass over F crops, in the reference's f32 operation
    order: (F, 3, n_out, width) from ``rows_of(idx)``, which returns the
    source rows idx (F, groups) as (F, 3, groups, width) f32."""
    f, dev = alpha.shape[0], alpha.device
    ng = n_out // G
    basef = torch.arange(ng, dtype=torch.float32, device=dev) * G
    row_ids = torch.arange(G, dtype=torch.float32, device=dev)
    lane_ids = torch.arange(width, dtype=torch.float32, device=dev)
    al, be, ga = (t[:, None, None, None] for t in (alpha, beta, gamma))
    pos = (al * (basef[:, None, None] + row_ids[:, None])
           + be * lane_ids) + ga                             # (F, ng, G, W)
    beta_min = torch.minimum(beta * 0.0, beta * float(width - 1))
    j0 = band_start(alpha[:, None], beta_min[:, None], gamma[:, None], basef,
                    src_rows, band, align)
    j0f = j0.to(torch.float32)
    acc = torch.zeros((f, 3, ng, G, width), dtype=torch.float32, device=dev)
    for r in range(band):
        w = torch.clamp_min(
            1.0 - torch.abs(pos - (j0f + r)[:, :, None, None]), 0.0)
        acc = acc + rows_of(j0 + r)[:, :, :, None, :] * w[:, None]
    return acc.reshape(f, 3, n_out, width)


def _rows_f32(src: torch.Tensor) -> RowsOf:
    """Row gatherer of an (F, 3, rows, W) f32 tensor (a view is fine)."""
    ar = torch.arange(src.shape[0], device=src.device)[:, None]

    def rows_of(idx):
        return src[ar, :, idx].permute(0, 2, 1, 3)

    return rows_of


def _rows_u8(src: torch.Tensor, b: torch.Tensor, ox: torch.Tensor) -> RowsOf:
    """Row gatherer of the PW-lane windows [ox, ox + PW) of planar u8
    frames (B, 3, H, W), zero past the frame's width; a frame index
    outside [0, B) reads an all-zero frame."""
    nb, _, _, w = src.shape
    pad = max((-w) % 128, PW - w)
    src = F.pad(src, (0, pad))
    valid = ((b >= 0) & (b < nb)).to(torch.float32)[:, None, None, None]
    bc = b.clamp(0, max(nb - 1, 0))[:, None, None]
    cols = ox[:, None, None] + torch.arange(PW, device=src.device)

    def rows_of(idx):
        v = src[bc, :, idx[:, :, None], cols]                # (F, ng, W, 3)
        return v.permute(0, 3, 1, 2).to(torch.float32) * valid

    return rows_of


def warp_crops_band_plain(frames_planar: torch.Tensor,
                          canvas_planar: torch.Tensor,
                          params: WarpParams) -> torch.Tensor:
    """The plain version: the five band passes, (F, 112, 112, 3) f32 crops
    (y, x, BGR) in the caller's crop order."""
    f = params.iparams.shape[0]
    dev = frames_planar.device
    ip = params.iparams.to(torch.int64)
    b, level, ox = ip[:, 0], ip[:, 1], ip[:, 3]
    fp = params.fparams
    sigma, u, v, my, mx = (fp[:, k] for k in range(5))
    zero = torch.zeros_like(sigma)
    one = torch.ones_like(sigma)

    # pass 1, scale-y: rows y of the canvas, lanes x of the source window
    a1 = torch.zeros((f, 3, Q, PW), dtype=torch.float32, device=dev)
    for at_level, src in ((level == 0, frames_planar),
                          (level != 0, canvas_planar)):
        sel = torch.nonzero(at_level).flatten()
        if sel.numel() == 0:
            continue
        s = sigma[sel]
        a1[sel] = _band_mix(_rows_u8(src, b[sel], ox[sel]), Q, src.shape[2],
                            PW, BAND_SRC, s, zero[sel], my[sel] - s * CQ,
                            align=16)
    # pass 2, scale-x: rows x, lanes y
    p2 = _band_mix(_rows_f32(a1.transpose(-1, -2)), Q, PW, Q, BAND_SCALE,
                   sigma, zero, mx - sigma * CQ, align=8)
    # pass 3, shear-x(u): rows x, lanes y
    p3 = _band_mix(_rows_f32(p2), Q, Q, Q, BAND_HX, one, u, -u * CQ, align=8)
    # pass 4, shear-y(v): rows y, lanes x
    p4 = _band_mix(_rows_f32(p3.transpose(-1, -2)), Q, Q, Q, BAND_VY, one, v,
                   -v * CQ, align=8)
    # pass 5, shear-x(u) onto the crop's rows: rows x, lanes y
    p5 = _band_mix(_rows_f32(p4.transpose(-1, -2)), OUT, Q, Q, BAND_HX, one,
                   u, (CQ - C0) - u * CQ, align=8)
    crops = p5[:, :, :, LANE_OFF:LANE_OFF + OUT]             # (F, C, X, Y)
    return crops.permute(0, 3, 2, 1).contiguous()            # (F, Y, X, C)


# --------------------------------------------------------------------------
# the work the crops need (for K3's bound)


def _taps(alpha, beta, gamma, n_out: int, lanes: torch.Tensor, width: int,
          src_rows: int, band: int, align: int, nonzero: bool = True):
    """The taps of one pass's outputs (F, n_out, len(lanes)): source rows
    floor(pos) and floor(pos) + 1 that lie inside the group's band window
    and (with ``nonzero``) have a non-zero hat weight, as (2, F, n_out, L)
    int64 rows and (2, F, n_out, L) bool ok. A NaN position has no taps."""
    dev = alpha.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    lf = lanes.to(device=dev, dtype=torch.float32)
    al, be, ga = (t[:, None, None] for t in (alpha, beta, gamma))
    pos = (al * i[:, None] + be * lf) + ga
    beta_min = torch.minimum(beta * 0.0, beta * float(width - 1))
    base = torch.div(i, G, rounding_mode="floor") * G
    j0 = band_start(alpha[:, None], beta_min[:, None], gamma[:, None], base,
                    src_rows, band, align)[:, :, None]
    t0 = torch.floor(pos)
    rows, oks = [], []
    for k in (0.0, 1.0):
        r = t0 + k
        ok = (r >= j0) & (r < j0 + band) & (r < src_rows)
        if nonzero:
            ok &= 1.0 - torch.abs(pos - r) > 0.0
        rows.append(torch.where(ok, r, 0.0).to(torch.int64))
        oks.append(ok)
    return torch.stack(rows), torch.stack(oks)


def _mark(dst: torch.Tensor, ok: torch.Tensor, *idx: torch.Tensor) -> None:
    """dst[idx] = True where ok, over the broadcast of idx and ok."""
    *idx, ok = torch.broadcast_tensors(*idx, ok)
    dst[tuple(t[ok] for t in idx)] = True


def needed_masks(params: WarpParams):
    """The intermediate positions the crops depend on, traced back from
    pass 5's kept outputs through each pass's taps with non-zero weight:
    bool masks of p4 (F, y, x), p3 (F, x, y), p2 (F, x, y) and pass 1's
    a1 (F, y, lane)."""
    f = params.iparams.shape[0]
    dev = params.fparams.device
    sigma, u, v, _, mx = (params.fparams[:, k] for k in range(5))
    zero, one = torch.zeros_like(sigma), torch.ones_like(sigma)
    fi = torch.arange(f, device=dev)[:, None, None]
    lanes_q = torch.arange(Q, device=dev)

    # pass 5 output (x = i, y = l) reads p4[y = l, x = tap]
    n4 = torch.zeros((f, Q, Q), dtype=torch.bool, device=dev)
    kept = torch.arange(LANE_OFF, LANE_OFF + OUT, device=dev)
    r, ok = _taps(one, u, (CQ - C0) - u * CQ, OUT, kept, Q, Q, BAND_HX, 8)
    for k in range(2):
        _mark(n4, ok[k], fi, kept, r[k])
    # pass 4 output (y = i, x = l) reads p3[x = l, y = tap]
    n3 = torch.zeros_like(n4)
    r, ok = _taps(one, v, -v * CQ, Q, lanes_q, Q, Q, BAND_VY, 8)
    for k in range(2):
        _mark(n3, ok[k] & n4, fi, lanes_q, r[k])
    # pass 3 output (x = i, y = l) reads p2[x = tap, y = l]
    n2 = torch.zeros_like(n4)
    r, ok = _taps(one, u, -u * CQ, Q, lanes_q, Q, Q, BAND_HX, 8)
    for k in range(2):
        _mark(n2, ok[k] & n3, fi, r[k], lanes_q)
    # pass 2 output (x = i, y = l) reads pass 1's a1[y = l, x = tap]
    n1 = torch.zeros((f, Q, PW), dtype=torch.bool, device=dev)
    r, ok = _taps(sigma, zero, mx - sigma * CQ, Q, lanes_q, Q, PW,
                  BAND_SCALE, 8)
    for k in range(2):
        _mark(n1, ok[k] & n2, fi, lanes_q, r[k])
    return n4, n3, n2, n1


def needed(frames_planar: torch.Tensor, canvas_planar: torch.Tensor,
           params: WarpParams):
    """What the crops depend on (``needed_masks``): the per-pass counts
    of needed outputs (pass 5's 112 x 112 a crop first, pass 1's last) and
    the bool masks (B, H, W) of the frame and canvas pixels read (all 3
    channels of each). The crops do not change when any other source
    pixel does."""
    f = params.iparams.shape[0]
    dev = params.fparams.device
    ip = params.iparams.to(torch.int64)
    b, level, ox = ip[:, 0], ip[:, 1], ip[:, 3]
    sigma, my = params.fparams[:, 0], params.fparams[:, 3]
    zero = torch.zeros_like(sigma)
    lanes_q = torch.arange(Q, device=dev)
    n4, n3, n2, n1 = needed_masks(params)
    counts = [f * OUT * OUT] + [int(n.sum()) for n in (n4, n3, n2, n1)]

    # pass 1 output (y = i, lane l) reads source (b, tap, ox + l)
    hits = []
    lanes_w = torch.arange(PW, device=dev)
    for at_level, src in ((level == 0, frames_planar),
                          (level != 0, canvas_planar)):
        nb, _, rows, w = src.shape
        hit = torch.zeros((nb, rows, w), dtype=torch.bool, device=dev)
        sel = torch.nonzero(at_level).flatten()
        if sel.numel():
            s = sigma[sel]
            r, ok = _taps(s, zero[sel], my[sel] - s * CQ, Q, lanes_q[:1], PW,
                          rows, BAND_SRC, 16)
            col = ox[sel, None, None] + lanes_w
            bs = b[sel, None, None]
            use = n1[sel] & (col >= 0) & (col < w) & (bs >= 0) & (bs < nb)
            for k in range(2):
                _mark(hit, ok[k] & use, bs, r[k], col)
        hits.append(hit)
    return counts, hits[0], hits[1]


# --------------------------------------------------------------------------
# the fused kernel's window arithmetic


def _span(alpha, beta, gamma, i0, i1, l0, l1):
    """[floor(min pos), floor(max pos) + 2) of pos = (alpha * i + beta * l)
    + gamma over i in [i0, i1], l in [l0, l1], int64 over the broadcast of
    the arguments: both taps of every position in the box. f32 rounding is
    monotone, so pos is monotone in i and in l and the corners bound it."""
    def f32(t):
        return torch.as_tensor(t, device=alpha.device).to(torch.float32)

    pos = torch.stack(torch.broadcast_tensors(
        *[(alpha * f32(i) + beta * f32(l)) + gamma
          for i in (i0, i1) for l in (l0, l1)]))
    return (_f32_to_i64(torch.floor(pos.amin(0))),
            _f32_to_i64(torch.floor(pos.amax(0))) + 2)


def fused_plan(params: WarpParams) -> torch.Tensor:
    """The ranges the fused kernel computes each pass over, per crop, as
    (F, PLAN_COLS) int64 (the kernel writes the same table, in int32, when
    asked): columns 0-1 the p4 x lanes [L4lo, L4hi) pass 5 can tap, 2-3 the
    p2 x rows [L3lo, L3hi) pass 3 can tap, 4-5 the p3 rows y [Ylo, Yhi)
    passes 1-3 produce, 6 one for a crop written all NaN (a non-finite
    sigma, u or v, or a NaN my or mx; its other columns 0), 7 zero; then
    for each kept pass-4 group g (rows 8 (G4 + g) ..), the p3 rows
    [rd_lo, rd_hi) it can read, NG4 columns each.

    Each range is the union of the band windows of the groups that read
    it (``band_start``), cut to ``_span`` over the box of positions read,
    and to the canvas. The kernel produces p3 rows in order and reads group
    g's rows only after producing up to rd_hi(g), from a ring of ``RING``
    rows: the CPU tests hold these ranges to cover every tap."""
    sigma, u, v, my, mx = (params.fparams[:, k] for k in range(5))
    dev = sigma.device
    one = torch.ones_like(sigma)
    dead = (~(torch.isfinite(sigma) & torch.isfinite(u) & torch.isfinite(v))
            | my.isnan() | mx.isnan())
    bases = torch.arange(Q // G, dtype=torch.float32, device=dev) * G

    def j0s(beta, gamma, band):              # (F, Q // G), alpha = 1
        bm = torch.minimum(beta * 0.0, beta * float(Q - 1))
        return band_start(one[:, None], bm[:, None], gamma[:, None], bases,
                          Q, band, 8)

    g3, g4, g5 = -u * CQ, -v * CQ, (CQ - C0) - u * CQ
    j3 = j0s(u, g3, BAND_HX)
    j4 = j0s(v, g4, BAND_VY)[:, G4:G4 + NG4]
    j5 = j0s(u, g5, BAND_HX)[:, :OUT // G]
    # p4 lanes x that pass 5 (x_out in [0, OUT), y kept) can tap
    lo, hi = _span(one, u, g5, 0, OUT - 1, LANE_OFF, LANE_OFF + OUT - 1)
    l4lo = torch.maximum(j5[:, 0], lo)
    l4hi = torch.maximum(torch.minimum(j5[:, -1] + BAND_HX, hi).clamp(max=Q),
                         l4lo)
    has4 = l4hi > l4lo
    # p3 rows y that each pass-4 group (y in 8 rows, x in L4) can tap
    y0 = (G4 + torch.arange(NG4, device=dev)) * G
    lo, hi = _span(one[:, None], v[:, None], g4[:, None], y0, y0 + G - 1,
                   l4lo[:, None], l4hi[:, None] - 1)
    rd_lo = torch.maximum(j4, lo)
    rd_hi = torch.maximum(torch.minimum(j4 + BAND_VY, hi).clamp(max=Q), rd_lo)
    rd_lo = torch.where(has4[:, None], rd_lo, 0)
    rd_hi = torch.where(has4[:, None], rd_hi, 0)
    ylo, yhi = rd_lo.amin(1), rd_hi.amax(1)
    # p2 rows x that pass 3 (x in L4, y in [Ylo, Yhi)) can tap
    has3 = yhi > ylo
    lo, hi = _span(one, u, g3, l4lo, l4hi - 1, ylo, yhi - 1)
    first = j3.gather(1, (l4lo // G).clamp(0, Q // G - 1)[:, None])[:, 0]
    last = j3.gather(1, ((l4hi - 1) // G).clamp(0, Q // G - 1)[:, None])[:, 0]
    l3lo = torch.maximum(first, lo)
    l3hi = torch.maximum(torch.minimum(last + BAND_HX, hi).clamp(max=Q), l3lo)
    l3lo, l3hi = (torch.where(has3, t, 0) for t in (l3lo, l3hi))
    zero = torch.zeros_like(l4lo)
    plan = torch.cat([torch.stack([l4lo, l4hi, l3lo, l3hi, ylo, yhi, zero,
                                   zero], 1), rd_lo, rd_hi], 1)
    plan[dead] = 0
    plan[dead, 6] = 1
    return plan


def launch_function(lib: ctypes.CDLL):
    """``warp_band_launch`` of a library built from ``csrc/warp_band.cu``,
    typed for ctypes."""
    fn = lib.warp_band_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _bind():
    """The C launch function, built and loaded at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ..cuda_build import library

        _launch_fn = launch_function(library(NAME))
    return _launch_fn


def occupancy() -> Dict[str, int]:
    """The fused kernel on the current card, from the CUDA occupancy API:
    shared memory a block (bytes, dynamic and static), blocks an SM and
    registers a thread, at ``RING`` ring rows."""
    global _occupancy_fn
    if _occupancy_fn is None:
        from ..cuda_build import library

        fn = library(NAME).warp_band_occupancy
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _occupancy_fn = fn
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = _occupancy_fn(RING, *(ctypes.byref(x) for x in vals))
    if rc != 0:
        raise RuntimeError(f"warp_band occupancy query failed: CUDA error {rc}")
    return dict(smem_bytes=vals[0].value, blocks_per_sm=vals[1].value,
                regs=vals[2].value)


def warp_crops_band(frames_planar: torch.Tensor, canvas_planar: torch.Tensor,
                    params: WarpParams,
                    plan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 3, H, W) u8 frames, (B, 3, CH, CW) u8 letterbox canvases and
    their ``WarpParams`` -> (F, 112, 112, 3) f32 crops (y, x, BGR).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise. ``plan``, an (F, PLAN_COLS) int32 CUDA
    tensor, receives the ranges the kernel used (``fused_plan``'s table).
    """
    if frames_planar.device.type == "cpu":
        return warp_crops_band_plain(frames_planar, canvas_planar, params)
    if frames_planar.device.type != "cuda":
        raise ValueError(f"warp_band: unsupported device "
                         f"{frames_planar.device}")
    for name, t in (("frames", frames_planar), ("canvas", canvas_planar)):
        if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[1] != 3:
            raise ValueError(f"warp_band: {name} must be (B, 3, H, W) uint8, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if canvas_planar.shape[0] != frames_planar.shape[0]:
        raise ValueError("warp_band: frames and canvas batches differ")
    f = params.iparams.shape[0]
    if (params.iparams.shape != (f, 8) or params.iparams.dtype != torch.int32
            or params.fparams.shape != (f, 8)
            or params.fparams.dtype != torch.float32):
        raise ValueError("warp_band: params need (F, 8) int32 iparams and "
                         "(F, 8) float32 fparams")
    tensors = (frames_planar, canvas_planar, params.iparams, params.fparams)
    if any(t.device != frames_planar.device for t in tensors):
        raise ValueError("warp_band: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("warp_band: inputs must be contiguous")
    dev = frames_planar.device
    if plan is not None and (plan.shape != (f, PLAN_COLS)
                             or plan.dtype != torch.int32
                             or plan.device != dev
                             or not plan.is_contiguous()):
        raise ValueError(f"warp_band: plan must be a contiguous ({f}, "
                         f"{PLAN_COLS}) int32 tensor on {dev}")
    out = torch.empty((f, OUT, OUT, 3), dtype=torch.float32, device=dev)
    if f == 0:
        return out
    nb, _, fh, fw = frames_planar.shape
    _, _, ch, cw = canvas_planar.shape
    fn = _bind()
    # the C launcher works on the current device (the launch, and any
    # shared-memory attribute or limit it sets or reads): make the tensor's
    # device current, so that a shard on another card is launched there
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(frames_planar.data_ptr(), nb, fh, fw,
                canvas_planar.data_ptr(), ch, cw, params.iparams.data_ptr(),
                params.fparams.data_ptr(), f, RING, out.data_ptr(),
                None if plan is None else plan.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"warp_band kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


# --------------------------------------------------------------------------
# the experiment's path


def make_workload(rng: np.random.Generator, n_frames: int, n_faces: int,
                  fh: int = 1080, fw: int = 1920, device=None):
    """Random u8 frames, ``n_faces`` similarity crops (scale 0.5-1.7, +-0.2
    rad, centers 150 px inside the frame), the tight letterbox canvas and
    the crops' ``WarpParams``; the numpy draws of the JAX script, in its
    order. Returns (frames (B, H, W, 3) u8, canvas (B, CH, CW, 3) u8,
    matrices (F, 2, 3) f32, frame_idx (F,) int32, params) on ``device``."""
    dev = resolve_device(device)
    frames = torch.from_numpy(rng.integers(0, 255, (n_frames, fh, fw, 3),
                                           dtype=np.uint8)).to(dev)
    ms = []
    for _ in range(n_faces):
        sigma = rng.uniform(0.5, min(1.7, SIGMA_MAX - 0.05))
        ang = rng.uniform(-0.2, 0.2)
        cx = rng.uniform(150, fw - 150)
        cy = rng.uniform(150, fh - 150)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        t = np.array([C0, C0]) - rot @ np.array([cx, cy])
        ms.append(np.concatenate([rot, t[:, None]], axis=1))
    matrices = torch.from_numpy(np.stack(ms).astype(np.float32)).to(dev)
    frame_idx = torch.from_numpy(np.sort(rng.integers(0, n_frames, n_faces))
                                 .astype(np.int32)).to(dev)
    plan = tight_letterbox_plan((fh, fw), (640, 640))
    canvas = torch.clamp(torch.round(letterbox(frames, plan)), 0, 255
                         ).to(torch.uint8)
    prm = prepare_warp_params(matrices, frame_idx, (fh, fw), plan.det_scale,
                              canvas_hw=tuple(canvas.shape[1:3]))
    return frames, canvas, matrices, frame_idx, prm


def check(rng: Optional[np.random.Generator] = None, n_frames: int = 2,
          n_faces: int = 12, fh: int = 540, fw: int = 960,
          device=None) -> Dict[str, float]:
    """K3 against the exact single-pass bilinear warp on the crops inside
    the envelope: mean, 99th percentile and max |difference| in u8 units
    (the passes' tap placement differs by O(tan phi))."""
    rng = np.random.default_rng(7) if rng is None else rng
    frames, canvas, matrices, fidx, prm = make_workload(
        rng, n_frames, n_faces, fh=fh, fw=fw, device=device)
    exact = warp_affine_flat(frames, matrices, fidx)
    band = warp_crops_band(planarize(frames), planarize(canvas), prm)
    d = (band - exact).abs()[~prm.fallback].cpu().numpy()
    if d.size == 0:
        return dict(mean=0.0, p99=0.0, max=0.0, crops=0)
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=float(d.max()), crops=int((~prm.fallback).sum()))


def run(batch: int = 16, faces: int = 320, iters: int = 10,
        fh: int = 1080, fw: int = 1920, seed: int = 0,
        device=None) -> Dict[str, float]:
    """The script's path: the workload from ``seed``, K3 and the port's
    production warp K1 (``warp_align_crops``: exact bilinear, ArcFace
    input prep fused) on it, each timed; K3's difference from K1 on the
    crops inside the envelope, in u8 units."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    frames, canvas, matrices, fidx, prm = make_workload(
        rng, batch, faces, fh=fh, fw=fw, device=dev)
    fp, cp = planarize(frames), planarize(canvas)
    minv = invert_affine(matrices).contiguous()
    band_ms = device_ms(lambda: warp_crops_band(fp, cp, prm), iters, dev)
    k1_ms = device_ms(lambda: warp_align_crops(frames, minv, fidx), iters, dev)
    band = warp_crops_band(fp, cp, prm)
    k1 = warp_align_crops(frames, minv, fidx)
    # K1 writes (x - 127.5) / 127.5, RGB, NCHW: back to u8 units, BGR, NHWC
    k1_u8 = (k1 * 127.5 + 127.5).flip(1).permute(0, 2, 3, 1)
    ok = ~prm.fallback
    d = (band - k1_u8).abs()[ok]
    return dict(band_ms=band_ms, k1_ms=k1_ms, crops=faces,
                in_envelope=int(ok.sum()),
                max_vs_k1=float(d.max()) if d.numel() else 0.0,
                mean_vs_k1=float(d.mean()) if d.numel() else 0.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="K3 against exact bilinear at small frames")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--faces", type=int, default=320)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.check:
        r = check(device=args.device)
        print(f"K3 vs exact bilinear on {r['crops']} crops in the envelope: "
              f"mean {r['mean']:.4f}, p99 {r['p99']:.3f}, max {r['max']:.3f} "
              f"u8 (multi-pass resampling differs from single-pass "
              f"bilinear)")
        return
    r = run(args.batch, args.faces, args.iters, device=args.device)
    where = resolve_device(args.device)
    name = (torch.cuda.get_device_name(where) if where.type == "cuda"
            else "CPU, host clock")
    nf = r["crops"]
    for label, key in (("band kernel K3", "band_ms"),
                       ("production warp K1", "k1_ms")):
        print(f"{label:<20s} {r[key]:8.3f} ms  "
              f"({r[key] / nf * 1e3:6.2f} us/crop)  [{name}]")
    print(f"    K3 vs K1 on {r['in_envelope']} crops in the envelope: max "
          f"{r['max_vs_k1']:.4f} mean {r['mean_vs_k1']:.6f} u8")


if __name__ == "__main__":
    main()
