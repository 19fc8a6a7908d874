#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

from the repository root. Phases, each of which ends the run with a
non-zero exit if it fails:

1. toolchain: torch / CUDA versions, nvcc, whether triton imports, the
   card's name and power limit (nvidia-smi);
2. builds every hand-written kernel from ``csrc/`` with nvcc, in parallel;
3. kernel K1 (the face-crop warp, ``warp_align``) against its plain PyTorch
   version on the card: 16 synthetic 1080p frames and 320 crops covering
   rotations to 180 deg, scales 0.2-4, partly and wholly off-frame crops,
   degenerate and NaN matrices, plus frames narrower than 512 px, and the
   edge sets of ``K1_EDGES`` (no crop, one crop, an output width off the
   4-pixel quads, a height off the kernel's tile rows, a width of three
   112-column tiles, frame indices outside [0, B), frames smaller than a
   crop's footprint); max abs error in u8
   units (tolerance 1e-3, expected 0) and equal NaN positions; the
   kernel's occupancy (threads and rows a CTA, CTAs an SM); kernel /
   plain / affine_grid + grid_sample / bound times at 320 crops, and the
   kernel and its bound at 960 crops over 96 x 1080p frames (bench.py's
   batch);
4. the main path at full width: FacePipeline with det_10g + w600k_r50
   (seeded weights) on the card, a gallery of 128, 8 synthetic 1080p
   frames, three calls with max_num=10 and process_stream over two
   batches, with the kernel's launch count reset just before and read just
   after, per-stage CUDA-event times and the kernel's times at the shapes
   this path gave it, beside ``crop_matrices`` (the rest of the align +
   warp stage) at the same shapes;
5. the port on the card against the port on the CPU (small seeded config,
   TF32 off for convolutions and matmuls);
6. kernel K2 (the PQ distance scorer, ``pq_adc``) against its plain
   PyTorch version on the card, in both precisions: Q in {1, 3, 13, 16,
   80} queries (13 leaves a part-filled last chunk), G in {0, 1, 4097,
   2,000,000} code rows, K in {16, 256}, M=64 and M=12, NaN and inf LUT
   entries; then ``K2_EDGES``: codes views 3 and 5 bytes past 16-byte
   alignment, M=128 (three slabs of subspaces), K=99 (the LUT staged
   entry by entry; M=160 in two slabs); max abs difference
   relative to the largest |score| (tolerance 1e-6, expected 0) and the
   same NaN / inf positions;
7. the gallery path at full width: the main path's embeddings are the
   queries; AutoGallery(tier="pq") on the card takes 1,000,000 synthetic
   identity rows (the embeddings among them at known ids) in one
   add_batch, migrates (codec training, encoding, a 2,000,000-row
   PQGallery) and answers search_batch(k=5) with K2's launch count reset
   just before and read just after; recall@1 of noisy views after the
   exact rerank (>= 0.95), each embedding finds itself (cosine >= 0.9999),
   stage times, PQGallery.search(rerank=0), the dense GalleryStore at the
   same rows; K2's times at these shapes against its bound, its plain
   version and ``embedding_bag``, then on the tier's filled rows alone
   (the tier is scored whole, and half of it is empty) and at Q=1, 4, 16;
8. the PQ gallery on the card against the CPU at 20,000 rows (same codec,
   codes and queries): ids equal, scores within 1e-5;
9. kernel K3 (the 5-pass band-mix warp, ``warp_band``) on its experiment's
   path (``tools.exp_warp2.run``: 16 x 1080p frames, 320 crops, against
   K1), with its launch count reset just before and read just after; then
   against its plain version on that workload and on stress sets (scales
   to 8, level-1 canvas crops, rotations past the envelope and upside
   down, crops past the frame edge, 512-wide and 400-wide frames) and 12
   hand-made edge crops (NaN and infinite parameters, |v| = 1, frame
   indices outside [0, B)), max abs error in u8 units (tolerance 1e-3,
   expected 0), and the ranges the kernel used equal to
   ``exp_warp2.fused_plan``'s; kernel / plain / bound times at 320 crops
   and the kernel and bound at 80 (the bound from what the crops need,
   traced back through the passes' taps), the fused kernel's shared
   memory a block, blocks an SM and waves, the peak device memory of one
   call, and K3's deviation from exact bilinear;
10. kernel K4 (the narrow 3x3 conv on the tensor cores, ``conv3x3``) on
   its experiment's path (``tools.exp_pallas_conv.run``: B=64, H=96,
   W=160, Wp=256, C=F=56), with its launch count reset just before and
   read just after; against its plain version there and on ``K4_CASES``
   (C=3, F=16, H=8, Wp=21; C=72, F=88; Wp=300; NaN and inf pixels), ReLU
   on and off, scale and bias given and absent, within one bf16 step plus
   |scale| * 2^-12 * sum |w| |x| (``sum_tolerance_ratio`` at most 1, NaN
   positions and infinities equal); kernel / plain / bound times and
   cuDNN's bf16 conv2d on all Wp lanes (the same work) and on the W real
   lanes;
11. the main path on the torch stand-in weights: det_10g and w600k_r50
   stand-ins (``tests/torch_export.py``) exported to ONNX, loaded through
   the port's importer (``variables_from_onnx``) on the card, FacePipeline
   at bench.py's settings (conf 0.5, pre_nms 256, max_det 16, max_num 10,
   8 x 1080p frames, gallery 128), K1's launch count reset just before and
   read just after; faces per call, said as meeting or not meeting the
   expectation (more than 0, fewer than every slot; 0 fails), ms per
   call, stage times; K1 against its plain version on the path's crops;
   the path's crop matrices through WarpParams and K3 against its plain
   version;
12. the facade and the engines (``FACADE``): (a) ``FaceAnalysis`` with
   det_10g + w600k_r50 (seeded) on the card, ``get_batch`` on 8 x 1080p
   images (the static route), 8 more at 720 x 1280 (two static chunks of
   different shapes through ``process_stream``) and 8 one-off web shapes
   (the dynamic 256-px buckets), K1's launches counted around the call,
   faces per image, each group's route and ms per route; each one-off
   image's dynamic canvas within 1e-4 of the exact-shape ``letterbox``;
   K1 against its plain version on the inputs this call gave it (the
   first call for each frame-batch shape: both static chunks and every
   dynamic bucket);
   (b) ``enable_microbatch()`` and 16 threads each calling ``get()`` on one
   image, the results equal to the direct ``get_batch`` of the batches the
   collector formed (bbox atol 1e-2, embeddings atol 1e-3); (c)
   ``SmartFaceEngine`` on that facade with an injected image loader (no
   network, no cv2) over ``FACADE["visits"]`` visits: the result counts,
   the "no face" count split by the gate that gave it, ms per visit, the
   results file's size, K1 against its plain version on the run's
   inputs; then on the PQ tier with an identity-coded app
   (``IdentityApp``) over ``ENGINE_PQ``'s visits in batches, K2's
   launches counted (the gallery crosses to PQ mid-run), K2 against its
   plain version on the LUT and codes of every search the tier ran, the
   decisions (the SQLite rows and the clustering_results JSON, without
   timestamps) equal to the same run on the CPU; (d)
   ``FaceComparison.process_face_comparisons`` on ``FACADE["pairs"]``
   (image, refImage) pairs with the facade: the accuracy block well formed,
   ms per pair. Any ERROR record that the port logs during (c) or (d)
   fails the phase: the engine counts a visit whose decision raised as
   "no face", so the log is where such a fault shows;
13. one JSON line of every kernel's numbers.

The last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the package beside it, the script exits non-zero and prints no
result.
"""
import contextlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

TOL_U8 = 1e-3          # kernel vs plain, in u8 units (both round alike)
DEV = "cuda"
# phase sizes: (frames, height, width, crops) for phase 3; the main path's
# models, frame batch and frame size for phase 4
K1_CASE = (16, 1080, 1920, 320)
# phase 3: K1 at bench.py's batch (frames, height, width, crops), and its
# edge sets: (name, frames, height, width, crops, out_hw, frame index
# offset); the offset moves every other crop's frame index outside [0, B)
K1_BENCH = (96, 1080, 1920, 960)
K1_EDGES = (("no crop", 2, 64, 96, 0, (112, 112), 0),
            ("one crop", 2, 64, 96, 1, (112, 112), 0),
            ("odd out_hw", 3, 90, 150, 24, (112, 110), 0),
            ("odd band and quad", 3, 90, 150, 24, (13, 7), 0),
            ("three tile columns", 3, 90, 150, 12, (9, 230), 0),
            ("frame index outside", 3, 90, 150, 24, (112, 112), 5),
            ("frames smaller than a footprint", 4, 12, 20, 24, (112, 112), 0))
MAIN = dict(det="det_10g", rec="w600k_r50", frames=8, hw=(1080, 1920),
            max_num=10, gallery=128)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
WARP_FLOPS_PER_PIXEL = 60   # coordinates, weights, 12 taps, normalize
TOL_K2 = 1e-6          # K2 vs plain, relative to max |score| (expected 0)
BF16_FLOPS_PER_S = 989e12
K3_FLOPS_PER_POSITION = 26   # position, two taps' weights, 3 x 2 mul-adds
# phase 9: K3's path (frames, height, width, crops); phase 10: K4's shapes;
# phase 11: the stand-in main path at bench.py's settings
K3_CASE = (16, 1080, 1920, 320)
K4_SHAPES = dict(b=64, h=96, w=160, c=56, f=56, wp=256)
# phase 10: K4 against its plain version beyond the script's shapes: the
# odd case, C and F above 64 and off 16, Wp above one 256-position tile,
# and NaN / inf pixels
K4_CASES = (("odd", dict(b=2, h=8, w=20, c=3, f=16, wp=21)),
            ("wide", dict(b=2, h=16, w=36, c=72, f=88, wp=40)),
            ("long", dict(b=2, h=8, w=290, c=56, f=56, wp=300)),
            ("nonfinite", dict(b=2, h=16, w=60, c=56, f=56, wp=64)))
STANDIN = dict(frames=8, hw=(1080, 1920), max_num=10, gallery=128, conf=0.5,
               pre_nms=256, max_det=16)
# phase 6: the (Q, G, K) grid, and beyond it (M, K, G, byte offset of the
# codes view) for each Q: views that are not 16-byte aligned; M=128, which
# K2 stages in three slabs; K=99, whose LUT rows it stages entry by entry
# (one slab with 16-byte code loads, two with byte loads); phase 7: the
# gallery path (rows, synthetic identities, their per-dim noise, search
# k); phase 8: rows
K2_GRID = dict(q=(1, 3, 13, 16, 80), g=(0, 1, 4097, 2_000_000), k=(16, 256))
K2_EDGES = ((64, 256, 4097, 3), (64, 256, 2_000_000, 5), (128, 256, 4097, 0),
            (128, 256, 4097, 1), (64, 99, 4097, 0), (160, 99, 4097, 1))
GAL = dict(rows=1_000_000, idents=100_000, sigma=0.05, k=5)
GAL_CPU_ROWS = 20_000
# phase 12: the facade's groups (static: n x h x w; stream: a second static
# shape; one-off web shapes (h, w) for the dynamic buckets), the
# micro-batched images (16 distinct shapes), the clustering run's visits
# and image size, the verification pairs; then the PQ-tier engine run
# (visits over identities, in batches, the tier's training rows)
FACADE = dict(det="det_10g", rec="w600k_r50", det_size=(640, 640), max_det=16,
              static=(8, 1080, 1920), stream=(8, 720, 1280),
              oneoff=((300, 400), (480, 640), (1280, 720), (97, 131),
                      (1000, 1000), (600, 800), (250, 180), (768, 1024)),
              microbatch=[(200 + 24 * i, 260 + 16 * i) for i in range(16)],
              visits=200, visit_hw=(480, 640), pairs=50)
ENGINE_PQ = dict(visits=300, idents=120, batches=3, min_train_rows=64)
TOL_CANVAS = 1e-4       # dynamic canvas vs exact-shape letterbox
TOL_RECORD = 1e-5       # engine floats (similarities), card vs CPU


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Report:
    def __init__(self, card):
        self.card = card

    def say(self, msg):
        print(f"{msg}  [{self.card}]", flush=True)


def time_ms(torch, fn, iters=10, flush_bytes=64 << 20):
    """Mean device time of fn() over ``iters`` launches, each after a
    write that flushes the 50 MB L2, so every launch finds it cold. A
    device-side spin (about 5 ms) after the flush keeps the card busy
    while the host enqueues fn(), so the host's launch overhead is not
    counted as device time unless fn() takes longer than that to enqueue."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device=DEV)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(10_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def synthetic_frames(torch, rng, b, h, w):
    """Smooth u8 BGR frames (B, H, W, 3) on the card from a numpy seed."""
    base = torch.from_numpy(rng.uniform(0, 255, (b, 3, max(h // 16, 2),
                                                 max(w // 16, 2)))
                            .astype(np.float32)).to(DEV)
    big = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                          align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1
                                                            ).contiguous()


def warp_matrices(rng, n, h, w):
    """(n, 2, 3) src -> dst similarities: scale 0.2-4 source px per crop px,
    any rotation, centers up to 30 % outside the frame; then a singular
    matrix, a NaN one and a wholly off-frame one."""
    ms = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        sigma = rng.uniform(0.2, 4.0)
        ang = rng.uniform(-np.pi, np.pi)
        cx = rng.uniform(-0.3 * w, 1.3 * w)
        cy = rng.uniform(-0.3 * h, 1.3 * h)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        ms[i, :, :2] = rot
        ms[i, :, 2] = np.array([55.5, 55.5]) - rot @ np.array([cx, cy])
    ms[0] = 0.0
    ms[1, :, 2] = np.nan
    ms[2] = [[1, 0, -1e6], [0, 1, 0]]
    return ms


def tap_coords(torch, minv, oh=112, ow=112):
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32,
                                         device=minv.device),
                            torch.arange(ow, dtype=torch.float32,
                                         device=minv.device), indexing="ij")
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    return sx, sy


def warp_bound(torch, frames, minv, frame_idx):
    """Least time for K1's work: every distinct source byte the crops touch
    read once, the f32 crops written once, the matrices and indices read;
    or the arithmetic at the fp32 rate, whichever is larger."""
    b, h, w, _ = frames.shape
    f = minv.shape[0]
    sx, sy = tap_coords(torch, minv)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    base = frame_idx.to(torch.int64)[:, None, None] * h
    lins = []
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xt, yt = x0 + dx, y0 + dy
            inside = (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (yt <= h - 1)
            lin = (base + torch.where(inside, yt, 0).to(torch.int64)) * w \
                + torch.where(inside, xt, 0).to(torch.int64)
            lins.append(lin[inside])
    distinct = int(torch.unique(torch.cat(lins)).numel())
    nbytes = distinct * 3 + f * 3 * 112 * 112 * 4 + f * 6 * 4 + f * 4
    flops = f * 112 * 112 * WARP_FLOPS_PER_PIXEL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def grid_sample_yardstick(torch, frames, minv, frame_idx):
    """``affine_grid`` + ``grid_sample`` (bilinear, zero padding) computing
    the same crops, timed as a yardstick only: frames pre-converted to f32
    NCHW, each frame's crops stacked along the output height (padded with
    empty crops to one count per frame) so one call serves the batch; no
    normalize, no channel swap. Returns the call and its (F, 112, 112, 3)
    crops in the caller's order, for a sanity check."""
    nnf = torch.nn.functional
    b, h, w, _ = frames.shape
    src = frames.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    fi = frame_idx.cpu().numpy()
    per = max(int(np.bincount(fi, minlength=b).max()), 1)
    slot = np.zeros(len(fi), np.int64)
    seen = np.zeros(b, np.int64)
    for i, fr in enumerate(fi):
        slot[i], seen[fr] = seen[fr], seen[fr] + 1
    rows = torch.from_numpy(fi * per + slot).to(minv.device)
    # output pixel j = 56 * x_n + 55.5 (align_corners=False); source
    # x_n = (2 * sx + 1) / w - 1, with sx = m00 * j + m01 * i + m02
    theta = torch.zeros((b * per, 2, 3), device=minv.device)
    theta[:, :, 2] = 4.0                       # padding crops sample nothing
    for r, size in ((0, w), (1, h)):
        m0, m1, m2 = minv[:, r, 0], minv[:, r, 1], minv[:, r, 2]
        theta[rows, r, 0] = 2 / size * m0 * 56
        theta[rows, r, 1] = 2 / size * m1 * 56
        theta[rows, r, 2] = 2 / size * (m0 * 55.5 + m1 * 55.5 + m2) \
            + 1 / size - 1

    def call():
        grid = nnf.affine_grid(theta, (b * per, 3, 112, 112),
                               align_corners=False)
        return nnf.grid_sample(src, grid.view(b, per * 112, 112, 2),
                               mode="bilinear", padding_mode="zeros",
                               align_corners=False)

    out = call().view(b, 3, per, 112, 112).permute(0, 2, 3, 4, 1)
    return call, out.reshape(b * per, 112, 112, 3)[rows]


def compare_k1(torch, wa, frames, minv, frame_idx, out_hw=(112, 112)):
    """Kernel vs plain on the same card tensors: same NaN positions, and
    the max abs difference of the rest in u8 units."""
    got = wa.warp_align_crops(frames, minv, frame_idx, out_hw)
    want = wa.warp_align_plain(frames, minv, frame_idx, out_hw)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail("warp_align: NaN pattern differs from the plain version")
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) * 127.5 if fin.any() else 0.0
    if not err <= TOL_U8:
        fail(f"warp_align: max abs err {err} u8 > {TOL_U8}")
    return err, got


def k1_edges(torch, wa, rng):
    """K1 against its plain version on each set of ``K1_EDGES``; returns
    the largest error and a line for the report."""
    errs = []
    for name, nb, h, w, nc, out_hw, off in K1_EDGES:
        frames = synthetic_frames(torch, rng, nb, h, w)
        # warp_matrices' first three are degenerate: drawn only with room
        ms = (warp_matrices(rng, nc, h, w) if nc >= 3 else
              warp_matrices(rng, nc + 3, h, w)[3:])
        fidx = rng.integers(0, nb, nc).astype(np.int32)
        if off:     # every other crop's index below 0 or past B, in turn
            bad = fidx[::2]
            bad[0::2], bad[1::2] = -off, nb - 1 + off
        err, got = compare_k1(torch, wa, frames, wa_inputs(torch, ms),
                              torch.from_numpy(fidx).to(DEV), out_hw)
        if got.shape != (nc, 3, *out_hw):
            fail(f"K1 edge set {name}: shape {tuple(got.shape)}")
        errs.append((name, err))
    return max(e for _, e in errs), "; ".join(f"{n} {e:.6g}" for n, e in errs)


def k1_times(torch, wa, frames, minv, frame_idx):
    ms = time_ms(torch, lambda: wa.warp_align_crops(frames, minv, frame_idx))
    plain_ms = time_ms(torch, lambda: wa.warp_align_plain(frames, minv,
                                                          frame_idx))
    lib_call, _ = grid_sample_yardstick(torch, frames, minv, frame_idx)
    lib_ms = time_ms(torch, lib_call)
    bound_ms, bound_by, nbytes = warp_bound(torch, frames, minv, frame_idx)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)


class StageTimer:
    """Stage hook: CUDA events around every pipeline stage."""

    def __init__(self, torch):
        self.torch = torch
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        s = self.torch.cuda.Event(enable_timing=True)
        e = self.torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            yield
        finally:
            e.record()
            self.events.append((name, s, e))

    def totals(self):
        self.torch.cuda.synchronize()
        out = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def phase_kernel_vs_plain(torch, wa, rep):
    rng = np.random.default_rng(0)
    nb, h, w, nc = K1_CASE
    frames = synthetic_frames(torch, rng, nb, h, w)
    ms = warp_matrices(rng, nc, h, w)
    fidx = rng.permutation(np.arange(nc) % nb).astype(np.int32)
    minv = wa_inputs(torch, ms)
    fidx_t = torch.from_numpy(fidx).to(DEV)
    err, got = compare_k1(torch, wa, frames, minv, fidx_t)
    n_nan = int(torch.isnan(got).flatten(1).all(1).sum())
    if n_nan < 2:
        fail("the degenerate crops did not come out NaN")
    rep.say(f"K1 vs plain, {nb}x{h}x{w} frames, {nc} crops (scale 0.2-4, any "
            f"rotation, off-frame, {n_nan} degenerate/NaN crops): "
            f"max_abs_err {err:.6g} u8 (tolerance {TOL_U8})")
    # frames narrower than the TPU kernel's 512-px window
    frames_n = synthetic_frames(torch, rng, 4, 300, 400)
    ms_n = warp_matrices(rng, 40, 300, 400)
    fidx_n = torch.from_numpy(rng.integers(0, 4, 40).astype(np.int32)).to(DEV)
    err_n, _ = compare_k1(torch, wa, frames_n, wa_inputs(torch, ms_n), fidx_n)
    rep.say(f"K1 vs plain, 4x(300x400) frames, 40 crops: max_abs_err "
            f"{err_n:.6g} u8")
    err_e, said = k1_edges(torch, wa, rng)
    rep.say(f"K1 vs plain on its edge sets, max_abs_err u8: {said}")
    occ = wa.occupancy()
    rep.say(f"K1 launch: {occ['threads']} threads a CTA, {occ['rows']} output "
            f"rows a CTA ({-(-112 // occ['rows'])} CTAs a 112-row crop), "
            f"{occ['blocks_per_sm']} CTAs an SM (occupancy API), "
            f"{occ['regs']} registers a thread")
    t = k1_times(torch, wa, frames, minv, fidx_t)
    _, lib_crops = grid_sample_yardstick(torch, frames, minv, fidx_t)
    plain = wa.warp_align_plain(frames, minv, fidx_t)
    plain_u8 = (plain * 127.5 + 127.5).permute(0, 2, 3, 1).flip(-1)
    fin = torch.isfinite(plain_u8) & torch.isfinite(lib_crops)
    lib_err = float((plain_u8[fin] - lib_crops[fin]).abs().max())
    rep.say(f"K1 times at {nb}x{h}x{w} / {nc} crops: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, affine_grid + grid_sample "
            f"{t['library_ms']:.4f} ms (its max diff from the plain crops "
            f"{lib_err:.4g} u8), "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s)")
    # bench.py's batch: 96 frames, up to 960 crops
    nb, h, w, nc = K1_BENCH
    frames = synthetic_frames(torch, rng, nb, h, w)
    minv = wa_inputs(torch, warp_matrices(rng, nc, h, w))
    fidx_t = torch.from_numpy(
        rng.permutation(np.arange(nc) % nb).astype(np.int32)).to(DEV)
    err_b, _ = compare_k1(torch, wa, frames, minv, fidx_t)
    ms_b = time_ms(torch, lambda: wa.warp_align_crops(frames, minv, fidx_t))
    bound, by, nbytes = warp_bound(torch, frames, minv, fidx_t)
    rep.say(f"K1 at {nb}x{h}x{w} / {nc} crops: kernel {ms_b:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes} B at 3.35 TB/s), "
            f"max_abs_err {err_b:.6g} u8")
    return max(err, err_n, err_e, err_b)


def wa_inputs(torch, ms):
    from scrfd_arcface_facerecognition_tpu_torch import ops

    return ops.invert_affine(torch.from_numpy(ms).to(DEV)).contiguous()


def phase_main_path(torch, rep):
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, stages
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        bucket_slots)

    t0 = time.perf_counter()
    nb, (h, w), max_num, ng = (MAIN["frames"], MAIN["hw"], MAIN["max_num"],
                               MAIN["gallery"])
    pipe = FacePipeline(det_variant=MAIN["det"], rec_variant=MAIN["rec"],
                        gallery_capacity=ng, seed=0, device=DEV)
    rng = np.random.default_rng(0)
    pipe.set_gallery(rng.normal(size=(ng, 512)).astype(np.float32),
                     [f"p{i}" for i in range(ng)])
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    frames2 = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                            dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=max_num)            # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    rep.say(f"main path: {MAIN['det']} + {MAIN['rec']} seeded on "
            f"{pipe.device}, {nb}x{h}x{w} frames, gallery {ng}; setup + "
            f"warm-up {time.perf_counter() - t0:.2f} s")

    timer = StageTimer(torch)
    wa.launches = 0
    stages.set_stage_hook(timer)
    call_ms, outs = [], []
    for _ in range(3):
        t = time.perf_counter()
        out = pipe(frames, max_num=max_num)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    stage_ms = timer.totals()
    stream = list(pipe.process_stream([frames, frames2], max_num=max_num))
    torch.cuda.synchronize()
    stages.set_stage_hook(None)
    launches = wa.launches

    if launches == 0:
        fail("main path launched the warp kernel no time")
    for o in outs + stream:
        faces = int(o.valid.sum())
        if faces <= 0:
            fail("main path found no faces")
        if o.embeddings.shape != (nb, max_num, 512):
            fail(f"embeddings shape {tuple(o.embeddings.shape)}")
        ev = o.embeddings[o.valid]
        if not bool(torch.isfinite(ev).all()):
            fail("non-finite embeddings on valid slots")
        norms = ev.norm(dim=-1)
        if not bool(((norms - 1).abs() < 1e-3).all()):
            fail("valid embeddings are not unit-norm")
        if not bool((o.embeddings[~o.valid] == 0).all()):
            fail("invalid slots carry embeddings")
    faces = int(outs[-1].valid.sum())
    rep.say(f"main path: faces found {faces} per {nb}-frame call, "
            f"{int(stream[0].valid.sum())}/{int(stream[1].valid.sum())} in the "
            f"stream; K1 launches {launches} over 3 calls + 2 stream batches; "
            f"embeddings finite and unit-norm on valid slots; "
            f"matches {int((outs[-1].match_idx >= 0).sum())}")
    rep.say(f"main path: ms per {nb}x{h}x{w} call " + ", ".join(
        f"{m:.2f}" for m in call_ms) + f" (median {sorted(call_ms)[1]:.2f})")
    rep.say("main path per-stage device ms (mean of 3 calls): " + ", ".join(
        f"{k} {stage_ms.get(k, 0.0) / 3:.3f}" for k in stages.STAGES))

    # the kernel at the shapes this path gave it (last call)
    o = outs[-1]
    b, k = o.valid.shape
    bucket = pipe._round_bucket(faces, b * k)
    sel, fidx = bucket_slots(o.valid, bucket)
    kps = o.kps.reshape(b * k, 5, 2)[sel]
    minv = crop_matrices(kps)
    err, _ = compare_k1(torch, wa, frames, minv, fidx)
    t = k1_times(torch, wa, frames, minv, fidx)
    cm_ms = time_ms(torch, lambda: crop_matrices(kps))
    rep.say(f"K1 at the main path's shapes ({nb}x{h}x{w}, {bucket} crops): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"affine_grid + grid_sample {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} "
            f"ms by {t['bound_by']} ({t['bytes']} B), max_abs_err {err:.6g} u8; "
            f"crop_matrices (umeyama + inverse) on the same {bucket} faces "
            f"{cm_ms:.4f} ms")
    return launches, err, t, o.embeddings[o.valid].cpu().numpy()


@contextlib.contextmanager
def full_f32(torch):
    """TF32 off for convolutions and matmuls inside the block, the
    process's settings restored after it (the phases after it time the
    paths at PyTorch's defaults)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def phase_card_vs_cpu(torch, rep):
    """The port on the card against the port on the CPU; run it inside
    ``full_f32``."""
    from scrfd_arcface_facerecognition_tpu_torch.models.arcface import (
        ArcFaceConfig)
    from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import (
        SCRFDConfig)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder, FacePipeline)

    det_cfg = SCRFDConfig("small_det", 16, (1, 2, 1, 1), (16, 16, 32, 48),
                          neck_filters=16, head_stacks=2, head_filters=32,
                          gn_groups=8)
    emb_cfg = ArcFaceConfig("small_r", "iresnet", emb_dim=128,
                            stage_blocks=(1, 2, 2, 1),
                            stage_filters=(16, 32, 64, 64))
    rng = np.random.default_rng(1)
    frames = synthetic_frames(torch, rng, 2, 240, 320).cpu().numpy()
    gallery = rng.normal(size=(8, 128)).astype(np.float32)

    def build(device):
        det = Detector(config=det_cfg, input_size=(320, 320), seed=3,
                       conf_thres=0.5, pre_nms=64, max_det=8, device=device)
        emb = Embedder(config=emb_cfg, seed=4, device=device)
        return FacePipeline(detector=det, embedder=emb, gallery_capacity=16,
                            similarity_thresh=0.3, device=device)

    cpu, gpu = build("cpu"), build(DEV)
    first = cpu(frames, max_num=4)
    valid = first.valid.numpy()
    gal = np.concatenate([gallery, first.embeddings.numpy()[valid]], 0)
    for p in (cpu, gpu):
        p.set_gallery(gal, [str(i) for i in range(len(gal))])
    want = cpu(frames, max_num=4)
    got = [t.cpu() for t in gpu(frames, max_num=4)]
    tb, ts, tk, tv, tc, te, ti, tm = got
    if int(want.valid.sum()) == 0:
        fail("card-vs-CPU phase found no faces")
    if not (torch.equal(tv, want.valid) and torch.equal(tc, want.count)
            and torch.equal(ti, want.match_idx)):
        fail("card vs CPU: valid/count/match_idx differ")
    db = float((tb - want.boxes).abs().max())
    dk = float((tk - want.kps).abs().max())
    ds = float((ts - want.scores).abs().max())
    dm = float((tm - want.match_sim).abs().max())
    a, b = te[tv], want.embeddings[tv]
    cos = float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
    if not (db <= 1e-2 and dk <= 1e-2 and ds <= 1e-4 and dm <= 1e-4
            and cos >= 0.9999):
        fail(f"card vs CPU out of tolerance: boxes {db} kps {dk} scores {ds} "
             f"match_sim {dm} cos {cos}")
    rep.say(f"card vs CPU (TF32 off), {int(tv.sum())} faces, "
            f"{int((ti >= 0).sum())} matches: valid/count/match_idx equal; "
            f"max |d| boxes {db:.3g} px, kps {dk:.3g} px, scores {ds:.3g}, "
            f"match_sim {dm:.3g}; min embedding cosine {cos:.7f}")


class HostStageTimer:
    """Stage hook for the gallery: host clock around each stage, with the
    device synchronized on entry and exit, since the migration's stages mix
    host and device work."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.torch.cuda.synchronize()
            self.ms[name] = (self.ms.get(name, 0.0)
                             + (time.perf_counter() - t) * 1e3)


def compare_k2(torch, pq_adc, lut, codes, precision):
    """Kernel vs plain on the same card tensors: same NaN and inf positions,
    and the max abs difference of the rest, absolute and relative to the
    largest |score|."""
    got = pq_adc.pq_adc_scores(lut, codes, precision)
    want = pq_adc.adc_scores_plain(lut, codes, precision)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"pq_adc: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))):
        fail("pq_adc: NaN/inf pattern differs from the plain version")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((got[fin] - want[fin]).abs().max())
    rel = err / max(float(want[fin].abs().max()), 1e-30)
    if not rel <= TOL_K2:
        fail(f"pq_adc ({precision}): max abs err {err} = {rel} of max "
             f"|score| > {TOL_K2}")
    inf = torch.isinf(want)
    if not torch.equal(got[inf], want[inf]):
        fail("pq_adc: infinite scores differ in sign")
    return err, rel


def k2_lut(torch, rng, q, m, k):
    """A normal (Q, M, K) f32 LUT on the card; from Q=3 on, query 1 is
    NaN at one subspace and query 2 has infinite entries at another."""
    lut = rng.normal(size=(q, m, k)).astype(np.float32)
    if q >= 3:
        lut[1, 5, :] = np.nan
        lut[2, 7, : k // 2] = np.inf
    return torch.from_numpy(lut).to(DEV)


def k2_codes(torch, rng, g, m, k, offset=0):
    """Uniform (G, M) u8 codes on the card, a contiguous view starting
    ``offset`` bytes into its buffer."""
    codes = torch.from_numpy(rng.integers(0, k, (g, m), dtype=np.uint8))
    buf = torch.empty(g * m + offset, dtype=torch.uint8, device=DEV)
    view = buf[offset:].view(g, m)
    view.copy_(codes)
    if (view.data_ptr() % 16 == 0) != (offset % 16 == 0):
        fail(f"pq_adc: codes view at offset {offset} has the wrong "
             f"alignment")
    return view


def phase_k2_vs_plain(torch, pq_adc, rep):
    rng = np.random.default_rng(2)
    worst = (0.0, 0.0)
    n_cases = 0

    def check(lut, codes):
        nonlocal worst, n_cases
        for precision in pq_adc.PRECISIONS:
            err, rel = compare_k2(torch, pq_adc, lut, codes, precision)
            worst = max(worst, (err, rel), key=lambda x: x[1])
            n_cases += 1

    for m in (64, 12):
        for k in K2_GRID["k"]:
            g_max = max(K2_GRID["g"]) if m == 64 else 4097
            codes_all = k2_codes(torch, rng, g_max, m, k)
            for q in K2_GRID["q"]:
                lut = k2_lut(torch, rng, q, m, k)
                for g in K2_GRID["g"]:
                    if g <= g_max:
                        check(lut, codes_all[:g])
            del codes_all
    for m, k, g, offset in K2_EDGES:
        codes = k2_codes(torch, rng, g, m, k, offset)
        for q in K2_GRID["q"]:
            check(k2_lut(torch, rng, q, m, k), codes)
        del codes
    rep.say(f"K2 vs plain, {n_cases} cases (both precisions; Q "
            f"{K2_GRID['q']}, G {K2_GRID['g']}, K {K2_GRID['k']}, M 64 and "
            f"12, NaN and inf LUT entries; then (M, K, G, codes offset) "
            f"{K2_EDGES}: unaligned codes, three slabs, K % 4 != 0): NaN/inf "
            f"positions equal, max abs err {worst[0]:.6g} = {worst[1]:.3g} "
            f"of max |score| (tolerance {TOL_K2}, expected 0)")
    return worst[0]


def k2_bound(q, m, k, g, precision):
    """Least time for K2's work: code bytes, LUT bytes (2 a entry in "hi")
    and score bytes once at the HBM rate, or Q*G*M adds at the f32 rate."""
    nbytes = g * m + q * m * k * (2 if precision == "hi" else 4) + q * g * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = q * g * m / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def k2_times(torch, pq_adc, lut, codes, precision):
    """K2, its plain version and one embedding_bag call (the yardstick: the
    same (G, Q) sums over codes offset into an (M*K, Q) table) on the same
    card tensors; the yardstick's result is held to the plain version's."""
    q, m, k = lut.shape
    g = codes.shape[0]
    ms = time_ms(torch, lambda: pq_adc.pq_adc_scores(lut, codes, precision))
    plain_ms = time_ms(torch, lambda: pq_adc.adc_scores_plain(
        lut, codes, precision), iters=3)
    table = lut if precision == "hilo" else lut.to(torch.bfloat16).float()
    weight = table.permute(1, 2, 0).reshape(m * k, q).contiguous()
    idx = codes.long() + torch.arange(m, device=DEV)[None, :] * k
    nnf = torch.nn.functional

    def lib():
        return nnf.embedding_bag(idx, weight, mode="sum")

    library_ms = time_ms(torch, lib, iters=3)
    want = pq_adc.adc_scores_plain(lut, codes, precision)
    lib_rel = float((lib().T - want).abs().max() / want.abs().max())
    del idx, weight
    bound_ms, bound_by, nbytes = k2_bound(q, m, k, g, precision)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                lib_rel=lib_rel)


def identity_rows(rng, n, idents, dim, sigma, chunk=100_000):
    """(n, dim) unit rows, each a noisy view (per-dim noise sigma) of one of
    `idents` random unit centers, the identity drawn at random per row (so
    any id range spans the identities), made in chunks."""
    centers = rng.standard_normal((idents, dim), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    ident = rng.integers(0, idents, n)
    rows = np.empty((n, dim), np.float32)
    for i0 in range(0, n, chunk):
        blk = centers[ident[i0:i0 + chunk]]
        blk += sigma * rng.standard_normal(blk.shape, dtype=np.float32)
        blk /= np.linalg.norm(blk, axis=1, keepdims=True)
        rows[i0:i0 + chunk] = blk
    return rows, ident, centers


def median_ms(torch, fn, n=5):
    out, times = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[n // 2], times, out


def phase_gallery_path(torch, rep, main_emb):
    from scrfd_arcface_facerecognition_tpu_torch import stages
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        AutoGallery, GalleryStore, pq_adc)

    n, dim, k = GAL["rows"], main_emb.shape[1], GAL["k"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    rows, ident, centers = identity_rows(rng, n, GAL["idents"], dim,
                                         GAL["sigma"])
    main_q = main_emb / np.linalg.norm(main_emb, axis=1, keepdims=True)
    known = rng.choice(n, len(main_q), replace=False)
    rows[known] = main_q
    ident[known] = -1
    ids = np.arange(n, dtype=np.int64)
    # noisy views of enrolled identities, for recall@1
    probe = rng.choice(np.flatnonzero(ident >= 0), 256, replace=False)
    probe_ident = ident[probe]
    views = centers[probe_ident] + GAL["sigma"] * rng.standard_normal(
        (len(probe), dim), dtype=np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    cos = main_q @ main_q.T
    off = cos[~np.eye(len(cos), dtype=bool)]
    rep.say(f"gallery path: {n} synthetic rows of {GAL['idents']} "
            f"identities (noise {GAL['sigma']} a dim) made in "
            f"{time.perf_counter() - t0:.1f} s; {len(main_q)} main-path "
            f"embeddings enrolled at known ids (pairwise cosine mean "
            f"{off.mean():.4f}, max {off.max():.4f})")

    timer = HostStageTimer(torch)
    stages.set_stage_hook(timer)
    ag = AutoGallery(vector_size=dim, tier="pq", device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    added = ag.add_batch(ids, rows)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t) * 1e3
    mig = dict(timer.ms)
    if added != n or ag.tier != "pq" or ag.get_embedding_count() != n:
        fail(f"gallery: add_batch wrote {added}, tier {ag.tier}")
    cap = ag._pq.capacity
    if cap != 2 * n:
        fail(f"gallery: PQ capacity {cap} != {2 * n}")
    rep.say(f"gallery path: add_batch of {n} rows {add_ms:.0f} ms = dense "
            f"fill {add_ms - mig['pq_migrate']:.0f} ms + migration stall "
            f"{mig['pq_migrate']:.0f} ms (codec training on "
            f"{ag.pq_train_rows} rows x {ag.pq_train_iters} iterations "
            f"{mig['pq_train']:.0f} ms, encoding {n} rows "
            f"{mig['pq_encode']:.0f} ms); PQGallery capacity {cap} rows")

    # the path: search_batch, with K2's count reset just before
    timer.ms.clear()
    pq_adc.launches = 0
    search_ms, all_ms, hits = median_ms(
        torch, lambda: ag.search_batch(main_q, k=k))
    stage_ms = {s: timer.ms[s] / len(all_ms) for s in stages.GALLERY_STAGES
                if s in timer.ms}
    stages.set_stage_hook(None)
    probe_hits = ag.search_batch(views, k=k)
    launches = pq_adc.launches
    if launches == 0:
        fail("gallery path launched K2 no time")
    for i, h in enumerate(hits):
        if len(h) != k or h[0].id != known[i] or not h[0].score >= 0.9999:
            fail(f"gallery: main-path embedding {i} (id {known[i]}) found "
                 f"{[(x.id, x.score) for x in h[:2]]}")
    recall = float(np.mean([len(h) > 0 and ident[h[0].id] == want
                            for h, want in zip(probe_hits, probe_ident)]))
    if not recall >= 0.95:
        fail(f"gallery: recall@1 {recall} < 0.95")
    rep.say(f"gallery path: search_batch of {len(main_q)} queries, k={k}, "
            f"rerank {ag.pq_rerank} (K2 in 'hi'): median {search_ms:.2f} ms "
            f"of " + ", ".join(f"{x:.2f}" for x in all_ms)
            + "; stages (mean host ms a call, synchronized): " + ", ".join(
                f"{s} {v:.3f}" for s, v in stage_ms.items())
            + f"; K2 launches {launches} over 6 calls (5 of the embeddings, "
            f"1 of {len(probe)} noisy views); every embedding "
            f"finds itself first (min cosine "
            f"{min(h[0].score for h in hits):.7f}); recall@1 of "
            f"{len(probe)} noisy views {recall:.4f}")

    # the "hilo" mode: PQGallery.search without rerank
    q_norm = main_q.astype(np.float32)
    hilo_ms, _, (s0, i0) = median_ms(
        torch, lambda: ag._pq.search(q_norm, k=k), n=3)
    self_first = float(np.mean(i0[:, 0] == known))
    rep.say(f"gallery path: PQGallery.search(rerank=0, K2 in 'hilo') "
            f"median {hilo_ms:.2f} ms; ADC top-1 is the embedding itself for "
            f"{self_first:.3f} of the queries")

    # K2 at the path's shapes
    lut = ag._pq.codec.lut(q_norm)
    codes = ag._pq._codes
    errs, times = [], {}
    for precision in pq_adc.PRECISIONS:
        errs.append(compare_k2(torch, pq_adc, lut, codes, precision)[0])
        times[precision] = k2_times(torch, pq_adc, lut, codes, precision)
        t = times[precision]
        rep.say(f"K2 at the path's shapes (Q={lut.shape[0]}, M="
                f"{lut.shape[1]}, K={lut.shape[2]}, G={codes.shape[0]}, "
                f"{precision}): kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, embedding_bag "
                f"{t['library_ms']:.4f} ms (its max diff from the plain "
                f"scores {t['lib_rel']:.3g} of max |score|), bound "
                f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B "
                f"at 3.35 TB/s), max abs err vs plain {errs[-1]:.6g}")
    # the tier is scored whole: half its rows are empty (zero codes)
    filled = codes[:n]
    for precision in pq_adc.PRECISIONS:
        ms_n = time_ms(torch, lambda: pq_adc.pq_adc_scores(lut, filled,
                                                           precision))
        b_n = k2_bound(lut.shape[0], lut.shape[1], lut.shape[2], n,
                       precision)
        rep.say(f"K2 on the {n} filled rows only (G={n} of the tier's "
                f"{codes.shape[0]}; {precision}): kernel {ms_n:.4f} ms "
                f"(whole tier {times[precision]['ms']:.4f}), bound "
                f"{b_n[0]:.4f} ms by {b_n[1]}")
    for q in (1, 4, 16):
        lut_q = lut[:q].contiguous()
        for precision in pq_adc.PRECISIONS:
            ms_q = time_ms(torch, lambda: pq_adc.pq_adc_scores(
                lut_q, codes, precision))
            b_q = k2_bound(q, lut.shape[1], lut.shape[2], codes.shape[0],
                           precision)
            rep.say(f"K2 at Q={q} of the path's queries ({precision}): "
                    f"kernel {ms_q:.4f} ms, bound {b_q[0]:.4f} ms by "
                    f"{b_q[1]}")
    sc = torch.zeros((lut.shape[0], codes.shape[0]), device=DEV)
    sort_ms = time_ms(torch, lambda: torch.sort(sc, dim=-1, descending=True,
                                                stable=True), iters=3)
    topk_ms = time_ms(torch, lambda: torch.topk(sc, 32, dim=-1), iters=3)
    rep.say(f"gallery path: the stable top-k (a stable descending sort) of "
            f"the ({lut.shape[0]}, {codes.shape[0]}) scores {sort_ms:.3f} ms; "
            f"torch.topk(32) on them {topk_ms:.3f} ms (not tie-stable)")
    del sc, lut

    # the dense tier at the same rows
    t = time.perf_counter()
    dense = GalleryStore(vector_size=dim, capacity=1 << 20, device=DEV)
    dense.add_batch(ids, rows)
    torch.cuda.synchronize()
    dense_fill = time.perf_counter() - t
    dense_ms, _, dhits = median_ms(
        torch, lambda: dense.search_batch(main_q, k=k))
    same = np.mean([[a.id for a in x] == [b.id for b in y]
                    for x, y in zip(hits, dhits)])
    same1 = np.mean([x[0].id == y[0].id for x, y in zip(hits, dhits)])
    if not all(h[0].id == w for h, w in zip(dhits, known)):
        fail("dense gallery: an embedding does not find itself")
    rep.say(f"dense GalleryStore at the same {n} rows (f32, "
            f"{dense.capacity * dim * 4 / 1e9:.2f} GB on the card): fill "
            f"{dense_fill:.1f} s, search_batch median {dense_ms:.2f} ms; "
            f"the PQ tier's reranked top-{k} equals the dense top-{k} for "
            f"{same:.3f} of the queries, its top-1 for {same1:.3f}")
    del dense
    n_cpu = GAL_CPU_ROWS
    return dict(codec=ag._pq.codec, rows=rows[:n_cpu], ids=ids[:n_cpu],
                queries=np.concatenate([main_q, views[:48]]),
                launches=launches, err=max(errs), times=times["hi"])


def phase_gallery_card_vs_cpu(torch, rep, codec, mat, ids, queries):
    import tempfile
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        PQCodec, PQGallery)

    n = len(ids)
    card = PQGallery(codec, capacity=2 * n, keep_exact=True, device=DEV)
    card.add(ids, mat)
    cpu_codes = PQCodec(codec.centroids.cpu()).encode(mat)
    code_diff = int((cpu_codes != card._codes[:n].cpu()).sum())
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "pq.npz")
        card.snapshot(path)
        cpu = PQGallery.restore(path, device="cpu")
    worst = 0.0
    for kw in (dict(k=5, rerank=32), dict(k=5)):
        sc, ic = card.search(queries, **kw)
        sh, ih = cpu.search(queries, **kw)
        if not np.array_equal(ic, ih):
            fail(f"gallery card vs CPU ({kw}): ids differ in "
                 f"{int((ic != ih).sum())} places")
        worst = max(worst, float(np.abs(sc - sh).max()))
    if not worst <= 1e-5:
        fail(f"gallery card vs CPU: scores {worst} apart > 1e-5")
    rep.say(f"gallery card vs CPU at {n} rows, {len(queries)} queries "
            f"(codes carried across in the npz snapshot): ids equal with "
            f"rerank 32 ('hi') and without ('hilo'), scores at most "
            f"{worst:.3g} apart; encoding the same rows on the CPU gives "
            f"{code_diff} of {mat.shape[0] * codec.m} codes that differ "
            f"from the card's")


# ---------------------------------------------------------------- K3 and K4

def k3_bound(frames_planar, canvas_planar, prm):
    """Least time for K3's work, from what this run's crops depend on
    (``exp_warp2.needed``: traced back from the kept crop pixels through
    each pass's taps with non-zero weight): the f32 crops written once,
    the params and the needed source pixels (3 channels) read once; or
    K3_FLOPS_PER_POSITION for each needed output position of the five
    passes at the f32 rate."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    f = prm.iparams.shape[0]
    counts, hit_f, hit_c = exp_warp2.needed(frames_planar, canvas_planar, prm)
    src_px = int(hit_f.sum()) + int(hit_c.sum())
    nbytes = f * 3 * wp.OUT * wp.OUT * 4 + f * 16 * 4 + 3 * src_px
    positions = sum(counts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = positions * K3_FLOPS_PER_POSITION / FP32_FLOPS_PER_S * 1e3
    return dict(ms=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, src_px=src_px, positions=positions,
                flops=positions * K3_FLOPS_PER_POSITION)


def compare_k3(torch, exp_warp2, frames_planar, canvas_planar, prm):
    """K3 vs its plain version on the same card tensors: same NaN
    positions, and the max abs difference of the rest in u8 units; and the
    ranges the kernel used equal to ``fused_plan``'s."""
    f = prm.iparams.shape[0]
    plan = torch.full((f, exp_warp2.PLAN_COLS), -7, dtype=torch.int32,
                      device=DEV)
    got = exp_warp2.warp_crops_band(frames_planar, canvas_planar, prm,
                                    plan=plan)
    want = exp_warp2.warp_crops_band_plain(frames_planar, canvas_planar, prm)
    torch.cuda.synchronize()
    if not torch.equal(plan.long(), exp_warp2.fused_plan(prm)):
        bad = int((plan.long() != exp_warp2.fused_plan(prm)).any(1).sum())
        fail(f"warp_band: the kernel's ranges differ from fused_plan on "
             f"{bad} of {f} crops")
    if got.shape != want.shape:
        fail(f"warp_band: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail("warp_band: NaN pattern differs from the plain version")
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not err <= TOL_U8:
        fail(f"warp_band: max abs err {err} u8 > {TOL_U8}")
    return err


def k3_stress(torch, rng, nb, h, w, n):
    """Frames, canvas and WarpParams of n crops that leave the workload's
    envelope: scales to 8 source px a crop px (level 1, inside the canvas
    envelope and beyond it), rotations to 0.6 rad and upside down (fallback
    crops, compared all the same), centers near and past the frame edge."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp

    frames = synthetic_frames(torch, rng, nb, h, w)
    ms = np.zeros((n, 2, 3), np.float32)
    for k in range(n):
        sigma = rng.uniform(0.4, 8.0)
        u = rng.random()
        ang = (rng.uniform(-0.24, 0.24) if u < 0.6 else
               rng.uniform(-0.6, 0.6) if u < 0.85 else
               np.pi + rng.uniform(-0.3, 0.3))
        cx = rng.choice([rng.uniform(-60, 120), rng.uniform(w - 120, w + 60),
                         rng.uniform(0, w)])
        cy = rng.choice([rng.uniform(-60, 120), rng.uniform(h - 120, h + 60),
                         rng.uniform(0, h)])
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        ms[k, :, :2] = rot
        ms[k, :, 2] = np.array([wp.C0, wp.C0]) - rot @ np.array([cx, cy])
    fidx = torch.from_numpy(rng.integers(0, nb, n).astype(np.int32)).to(DEV)
    plan = ops.tight_letterbox_plan((h, w), (640, 640))
    canvas = ops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = wp.prepare_warp_params(torch.from_numpy(ms).to(DEV), fidx, (h, w),
                                 plan.det_scale,
                                 canvas_hw=tuple(canvas.shape[1:3]))
    return wp.planarize(frames), wp.planarize(canvas), prm


def k3_edges(torch, prm):
    """A copy of ``prm`` with hand-made crops in its first 12 rows: NaN and
    infinite sigma / u / v / my / mx (written all NaN, or zeros for my and
    mx at +-inf), |v| = 1 both ways, frame indices outside [0, B)."""
    nan, inf = float("nan"), float("inf")
    fp, ip = prm.fparams.clone(), prm.iparams.clone()
    for k, (col, val) in enumerate(((0, nan), (1, nan), (2, nan), (3, nan),
                                    (4, nan), (0, inf), (1, -inf), (2, inf),
                                    (3, inf), (4, -inf))):
        fp[k, col] = val
    fp[10, 1:3] = torch.tensor([-1.0, 1.0])
    fp[11, 1:3] = torch.tensor([1.0, -1.0])
    ip[10, 0], ip[11, 0] = -1, 1 << 20
    return prm._replace(iparams=ip, fparams=fp)


def phase_k3(torch, rep):
    """K3's path (the experiment script's run, counts reset just before and
    read just after), then K3 against its plain version on the workload and
    the stress sets, its times at the path's shapes and its deviation from
    exact bilinear."""
    from scrfd_arcface_facerecognition_tpu_torch.ops.warp_params import (
        planarize)
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    nb, h, w, nc = K3_CASE
    exp_warp2.launches = 0
    run = exp_warp2.run(batch=nb, faces=nc, iters=10, fh=h, fw=w, seed=0,
                        device=DEV)
    torch.cuda.synchronize()
    launches = exp_warp2.launches
    if launches == 0:
        fail("K3's path launched the band-mix kernel no time")
    rep.say(f"K3 path (tools.exp_warp2.run, {nb}x{h}x{w} frames, {nc} "
            f"crops, {run['in_envelope']} inside the envelope): K3 "
            f"{run['band_ms']:.4f} ms, K1 {run['k1_ms']:.4f} ms a call "
            f"(CUDA events, warm L2); K3 vs K1 max {run['max_vs_k1']:.4f} "
            f"mean {run['mean_vs_k1']:.4f} u8; K3 launches {launches}")

    frames, canvas, _, _, prm = exp_warp2.make_workload(
        np.random.default_rng(0), nb, nc, fh=h, fw=w, device=DEV)
    fp, cp = planarize(frames), planarize(canvas)
    errs = [compare_k3(torch, exp_warp2, fp, cp, prm)]
    rng = np.random.default_rng(9)
    cases = []
    for sb, sh, sw, sn in ((4, h, w, 120), (4, 384, 512, 60),
                           (2, 300, 400, 30)):
        sfp, scp, sprm = k3_stress(torch, rng, sb, sh, sw, sn)
        errs.append(compare_k3(torch, exp_warp2, sfp, scp, sprm))
        lv = sprm.iparams[:, 1]
        cases.append(f"{sb}x{sh}x{sw}: {sn} crops, {int((lv == 1).sum())} "
                     f"at level 1, {int(sprm.fallback.sum())} fallback")
    edges = k3_edges(torch, sprm)
    errs.append(compare_k3(torch, exp_warp2, sfp, scp, edges))
    dead = int(exp_warp2.fused_plan(edges)[:, 6].sum())
    rep.say(f"K3 vs plain: workload {errs[0]:.6g} u8; stress sets ("
            + "; ".join(cases) + f"): " + ", ".join(f"{e:.6g}" for e in
                                                    errs[1:4])
            + f" u8; the last set with 12 hand-made edge crops ({dead} "
            f"written all NaN): {errs[4]:.6g} u8 (tolerance {TOL_U8}, "
            f"expected 0); the kernel's ranges equal fused_plan's on every "
            f"crop")

    ms = time_ms(torch, lambda: exp_warp2.warp_crops_band(fp, cp, prm))
    plain_ms = time_ms(torch, lambda: exp_warp2.warp_crops_band_plain(
        fp, cp, prm), iters=2)
    bd = k3_bound(fp, cp, prm)
    # F = 80 crops of the same frames (make_workload's first 80 draws)
    fr80, cv80, _, _, prm80 = exp_warp2.make_workload(
        np.random.default_rng(0), nb, 80, fh=h, fw=w, device=DEV)
    fp80, cp80 = planarize(fr80), planarize(cv80)
    ms80 = time_ms(torch, lambda: exp_warp2.warp_crops_band(fp80, cp80,
                                                            prm80))
    bd80 = k3_bound(fp80, cp80, prm80)
    chk = exp_warp2.check(device=DEV)
    rep.say(f"K3 times at {nb}x{h}x{w} / {nc} crops (cold L2): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library n/a (no single "
            f"PyTorch call computes the five resampling passes), bound "
            f"{bd['ms']:.4f} ms by {bd['by']} ({bd['bytes']} B at 3.35 TB/s: "
            f"the crops, the params and {bd['src_px']} needed source pixels "
            f"x 3 channels; {bd['positions']} needed positions x "
            f"{K3_FLOPS_PER_POSITION} flops = {bd['flops']} at 67 TFLOP/s); "
            f"kernel / bound {ms / bd['ms']:.1f}; at 80 crops: kernel "
            f"{ms80:.4f} ms, bound {bd80['ms']:.4f} ms by {bd80['by']}")
    occ = exp_warp2.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = occ["blocks_per_sm"] * sms
    del fr80, cv80, fp80, cp80, prm80
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exp_warp2.warp_crops_band(fp, cp, prm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    rep.say(f"K3 fused (one launch a call, one block per crop): "
            f"{occ['smem_bytes']} B of shared memory a block (a ring of "
            f"{exp_warp2.RING} p3 rows), {occ['regs']} registers a thread, "
            f"{occ['blocks_per_sm']} blocks an SM (occupancy API) on {sms} "
            f"SMs: {nc / slots:.2f} waves at F = {nc}, "
            f"{80 / slots:.2f} at F = 80; peak device memory of one "
            f"call {peak} B above what was allocated before it (the "
            f"{nc * 3 * 112 * 112 * 4} B of crops); K3 vs exact bilinear "
            f"(check, noise frames, {chk['crops']} crops): mean "
            f"{chk['mean']:.4f}, p99 {chk['p99']:.3f}, max {chk['max']:.3f} "
            f"u8")
    return dict(launches=launches, err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bd["ms"], bound_by=bd["by"])


def k4_bound(b, c, h, wp, f):
    """Least time for K4's work: x and w3 read once (bf16), the affine read,
    y written once (bf16); or 2 * 9C * F flops an output position at the
    bf16 tensor-core rate."""
    nbytes = b * c * h * wp * 2 + 9 * c * f * 2 + 2 * f * 4 + b * f * h * wp * 2
    flops = 2 * b * h * wp * 9 * c * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def k4_case(torch, exp_pallas_conv, rng, shp, nonfinite=False):
    """K4's inputs at ``shp`` on the card (the script's workload), with a
    per-channel scale and bias; ``nonfinite`` puts a NaN pixel, a +inf
    pixel and a -inf pixel in x, the last on lane Wp - 1, whose right
    neighbour is lane 0."""
    x, w3, k = exp_pallas_conv.workload(rng, shp["b"], shp["h"], shp["w"],
                                        shp["c"], shp["f"], shp["wp"],
                                        device=DEV)
    if nonfinite:
        b, c, h, wp = x.shape
        x[0, c // 2, h // 2, wp // 3] = float("nan")
        x[b - 1, c - 1, 1, 0] = float("inf")
        x[b - 1, 0, h - 1, wp - 1] = -float("inf")
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, shp["f"]).astype(
        np.float32)).to(DEV)
    bi = torch.from_numpy(rng.normal(size=shp["f"]).astype(
        np.float32)).to(DEV)
    return x, w3, k, sc, bi


def phase_k4(torch, rep):
    """K4's path (the experiment script's run, counts reset just before and
    read just after), K4 against its plain version within the sum's
    tolerance at the script's shapes and the odd ones, and its times
    against cuDNN's bf16 conv on the W real lanes and on all Wp lanes."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_pallas_conv

    s = K4_SHAPES
    exp_pallas_conv.launches = 0
    run = exp_pallas_conv.run(dict(s), iters=30, device=DEV)
    torch.cuda.synchronize()
    launches = exp_pallas_conv.launches
    if launches == 0:
        fail("K4's path launched the conv kernel no time")
    if not 0 <= run["ratio"] <= 1:
        fail(f"K4's path: tolerance ratio {run['ratio']} from the plain "
             f"version (at most 1 passes, -1: NaN positions differ)")
    rep.say(f"K4 path (tools.exp_pallas_conv.run, B={s['b']} C={s['c']} "
            f"H={s['h']} W={s['w']} Wp={s['wp']} F={s['f']}): K4 "
            f"{run['ms']:.4f} ms ({run['gflop'] / run['ms']:.1f} TFLOP/s), "
            f"cuDNN bf16 conv2d {run['cudnn_wp_ms']:.4f} ms on all "
            f"{s['wp']} lanes, {run['cudnn_ms']:.4f} ms on {s['w']} (warm "
            f"L2); K4 vs plain tolerance ratio {run['ratio']:.4g} "
            f"({run['ulps']} bf16 steps); K4 vs cuDNN max abs "
            f"{run['cudnn_max_abs']:.4g} (scale {run['scale']:.2f}); K4 "
            f"launches {launches}")

    rng = np.random.default_rng(11)
    worst, worst_ulps, worst_abs, n_cases, lines = 0.0, 0, 0.0, 0, []
    for name, shp in (("script", s),) + K4_CASES:
        x, w3, k, sc, bi = k4_case(torch, exp_pallas_conv, rng, shp,
                                   nonfinite=name == "nonfinite")
        a = exp_pallas_conv.tap_abs_sum(x, w3)
        c_ratio, c_nan, c_inf = 0.0, 0, 0
        for relu in (False, True):
            for aff in ((None, None), (sc, bi)):
                got = exp_pallas_conv.conv3x3(x, w3, *aff, relu=relu)
                want = exp_pallas_conv.conv3x3_plain(x, w3, *aff, relu=relu)
                ratio = exp_pallas_conv.sum_tolerance_ratio(got, want, a,
                                                            aff[0])
                if not 0 <= ratio <= 1:
                    fail(f"conv3x3: tolerance ratio {ratio} from the plain "
                         f"version (case {name} {shp}, relu {relu}, affine "
                         f"{aff[0] is not None}; at most 1 passes, -1: NaN "
                         f"positions differ)")
                c_ratio = max(c_ratio, ratio)
                worst_ulps = max(worst_ulps,
                                 exp_pallas_conv.bf16_ulps(got, want))
                d = torch.nan_to_num((got.float() - want.float()).abs(),
                                     nan=0.0)
                worst_abs = max(worst_abs, float(d.max()))
                c_nan = max(c_nan, int(torch.isnan(want).sum()))
                c_inf = max(c_inf, int(torch.isinf(want).sum()))
                n_cases += 1
        if name == "nonfinite" and not (c_nan and c_inf):
            fail(f"conv3x3: the non-finite case gave {c_nan} NaN and "
                 f"{c_inf} infinite outputs; both expected")
        worst = max(worst, c_ratio)
        lines.append(f"{name} (B={shp['b']} C={shp['c']} H={shp['h']} "
                     f"W={shp['w']} Wp={shp['wp']} F={shp['f']}) "
                     f"{c_ratio:.4g}" + (f", {c_nan} NaN and {c_inf} inf "
                                         f"outputs agree" if c_nan else ""))
        if name == "script":
            kept = (x, w3, k, sc, bi)
    rep.say(f"K4 vs plain, {n_cases} cases (relu on and off; scale and "
            f"bias given and absent), worst tolerance ratio by shape: "
            + "; ".join(lines) + f". Worst ratio {worst:.4g} (at most 1 "
            f"passes: one bf16 step + |scale| * 2^-12 * sum |w||x|), at most "
            f"{worst_ulps} bf16 steps apart, max abs difference "
            f"{worst_abs:.6g}")

    x, w3, k, sc, bi = kept
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(DEV).to(
        torch.bfloat16)
    ms = time_ms(torch, lambda: exp_pallas_conv.conv3x3(x, w3, sc, bi, True))
    plain_ms = time_ms(torch, lambda: exp_pallas_conv.conv3x3_plain(
        x, w3, sc, bi, True), iters=2)
    lib_w_ms = time_ms(torch, lambda: exp_pallas_conv.cudnn_conv(
        x, kt, s["w"], sc, bi, True))
    lib_ms = time_ms(torch, lambda: exp_pallas_conv.cudnn_conv(
        x, kt, s["wp"], sc, bi, True))
    lib = exp_pallas_conv.cudnn_conv(x, kt, s["w"], sc, bi, True)
    ref = exp_pallas_conv.conv3x3(x, w3, sc, bi, True)[..., :s["w"]]
    lib_err = float((lib.float() - ref.float()).abs().max())
    bound_ms, bound_by, nbytes = k4_bound(s["b"], s["c"], s["h"], s["wp"],
                                          s["f"])
    flops = 2 * s["b"] * s["h"] * s["wp"] * 9 * s["c"] * s["f"]
    rep.say(f"K4 times at the script's shapes, affine + ReLU (cold L2): "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, cuDNN bf16 conv2d + affine + ReLU on all "
            f"{s['wp']} lanes (K4's work) {lib_ms:.4f} ms, on the {s['w']} "
            f"real lanes {lib_w_ms:.4f} ms (max abs {lib_err:.4g} from the "
            f"kernel there), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
            f"B at 3.35 TB/s; {flops} flops at 989 TFLOP/s bf16); kernel / "
            f"bound {ms / bound_ms:.1f}, kernel / cuDNN {ms / lib_ms:.2f}")
    return dict(launches=launches, err=worst_abs, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ------------------------------------------------ the stand-in main path

def standin_onnx(torch, build):
    """The det_10g and w600k_r50 torch stand-ins (``tests/torch_export.py``,
    crc32 seeds, the detector calibrated) exported to ONNX under ``build``,
    cached by the stand-ins' definition."""
    import importlib.util
    import zlib

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "tests", "torch_export.py")
    with open(src, "rb") as f:
        key = f"{zlib.crc32(f.read()):08x}"
    spec = importlib.util.spec_from_file_location("torch_export", src)
    te = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(te)
    out = {}
    os.makedirs(build, exist_ok=True)
    for name, side in (("det_10g", 640), ("w600k_r50", 112)):
        path = os.path.join(build, f"{name}_standin_{key}.onnx")
        if not os.path.exists(path):
            tm = te.seeded(te.STAND_INS[name](),
                           seed=zlib.crc32(name.encode()) % 1000)
            if name.startswith("det"):
                tm = te.calibrate_detector(tm)
            te.export_onnx(tm, torch.randn(1, 3, side, side), path + ".tmp")
            os.replace(path + ".tmp", path)
        out[name] = path
    return out


def standin_expectation(faces, slots):
    """The stand-in path's face-count expectation (more than 0 faces and
    fewer than every slot a call), said as met or NOT MET. Zero faces fails
    the phase; a full count is reported: the random-weight stand-ins score
    every frame alike, so they fill max_num on any content."""
    if faces <= 0:
        fail("stand-in path found no faces")
    if faces < slots:
        return (f"stand-in path: expectation met: {faces} faces, more than 0 "
                f"and fewer than the {slots} slots a call")
    return (f"stand-in path: expectation NOT MET: more than 0 and fewer than "
            f"{slots} faces a call expected, {faces} of {slots} found; the "
            f"random-weight stand-ins score every frame alike and fill "
            f"max_num on any content, so realistic counts need a trained "
            f"checkpoint")


def phase_standin_path(torch, rep):
    """The main path on the stand-in weights, loaded through the port's
    ONNX importer; K1's count reset just before the calls and read just
    after; then the path's crop matrices through WarpParams and K3."""
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, ops, stages
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        bucket_slots)
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    t0 = time.perf_counter()
    c = STANDIN
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "standins")
    paths = standin_onnx(torch, build)
    t_export = time.perf_counter() - t0
    det_cfg, det_v = variables_from_onnx(paths["det_10g"], name="det_10g")
    rec_cfg, rec_v = variables_from_onnx(paths["w600k_r50"], name="w600k_r50")
    t_import = time.perf_counter() - t0 - t_export
    det = Detector(config=det_cfg, variables=det_v, conf_thres=c["conf"],
                   pre_nms=c["pre_nms"], max_det=c["max_det"], device=DEV)
    emb = Embedder(config=rec_cfg, variables=rec_v, device=DEV)
    pipe = FacePipeline(detector=det, embedder=emb,
                        gallery_capacity=c["gallery"], device=DEV)
    nb, (h, w), max_num, ng = c["frames"], c["hw"], c["max_num"], c["gallery"]
    rng = np.random.default_rng(0)
    pipe.set_gallery(rng.normal(size=(ng, 512)).astype(np.float32),
                     [f"p{i}" for i in range(ng)])
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=max_num)                     # warm-up
    torch.cuda.synchronize()
    rep.say(f"stand-in path: {det_cfg.name} (stem {det_cfg.stem_filters}, "
            f"stages {tuple(det_cfg.stage_filters)}) + {rec_cfg.name} "
            f"(blocks {tuple(rec_cfg.stage_blocks)}) stand-ins exported in "
            f"{t_export:.1f} s, loaded through the port's ONNX importer in "
            f"{t_import:.1f} s; set-up + warm-up "
            f"{time.perf_counter() - t0:.1f} s")

    timer = StageTimer(torch)
    wa.launches = 0
    stages.set_stage_hook(timer)
    call_ms, outs = [], []
    for _ in range(3):
        t = time.perf_counter()
        out = pipe(frames, max_num=max_num)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    stage_ms = timer.totals()
    stages.set_stage_hook(None)
    launches = wa.launches
    if launches == 0:
        fail("stand-in path launched K1 no time")
    o = outs[-1]
    faces = int(o.valid.sum())
    expectation = standin_expectation(faces, nb * max_num)
    ev = o.embeddings[o.valid]
    if not bool(torch.isfinite(ev).all()) or not bool(
            ((ev.norm(dim=-1) - 1).abs() < 1e-3).all()):
        fail("stand-in path: valid embeddings not finite and unit-norm")
    cos = ev @ ev.T
    off = cos[~torch.eye(len(ev), dtype=torch.bool, device=ev.device)]
    per_frame = o.valid.sum(1).tolist()
    rep.say(f"stand-in path: faces found {faces} of {nb * max_num} slots per "
            f"{nb}-frame call ({per_frame} a frame), K1 launches {launches} "
            f"over 3 calls; embeddings finite "
            f"and unit-norm, pairwise cosine mean {float(off.mean()):.4f} max "
            f"{float(off.max()):.4f}; scores {float(o.scores[o.valid].min()):.4f}"
            f"-{float(o.scores[o.valid].max()):.4f}")
    rep.say(expectation)
    rep.say(f"stand-in path: ms per {nb}x{h}x{w} call " + ", ".join(
        f"{m:.2f}" for m in call_ms) + f" (median {sorted(call_ms)[1]:.2f}); "
        "per-stage device ms (mean of 3 calls): " + ", ".join(
            f"{k} {stage_ms.get(k, 0.0) / 3:.3f}" for k in stages.STAGES))

    b, k = o.valid.shape
    sel, fidx = bucket_slots(o.valid, faces)
    kps = o.kps.reshape(b * k, 5, 2)[sel]
    err1, _ = compare_k1(torch, wa, frames, crop_matrices(kps), fidx)
    rep.say(f"stand-in path's {faces} crops: K1 vs plain {err1:.6g} u8")

    # the path's crops through WarpParams and K3

    mats = ops.estimate_norm(kps, 112)                  # src -> dst
    plan = pipe.detector.plan((h, w), tight=True)
    canvas = ops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = wp.prepare_warp_params(mats, fidx, (h, w), plan.det_scale,
                                 canvas_hw=tuple(canvas.shape[1:3]))
    err = compare_k3(torch, exp_warp2, wp.planarize(frames),
                     wp.planarize(canvas), prm)
    inside = float((~prm.fallback).float().mean())
    lv1 = int((prm.iparams[:, 1] == 1).sum())
    sig = prm.fparams[:, 0]
    rep.say(f"stand-in path's {faces} crops through WarpParams: "
            f"{inside:.3f} inside the K3 envelope ({lv1} at level 1; sigma "
            f"{float(sig.min()):.3f}-{float(sig.max()):.3f}, |sin phi| max "
            f"{float(prm.fparams[:, 2].abs().max()):.3f}); K3 vs plain on "
            f"them {err:.6g} u8")
    return dict(err=err, err1=err1, faces=faces, launches=launches)

# ---------------------------------------------------------------------
# phase 12: the facade and the engines


def loader_image(source, hw):
    """A seeded synthetic BGR image for ``source`` (no network, no cv2)."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(source.encode()))
    return rng.integers(0, 256, (*hw, 3), dtype=np.uint8)


def identity_image(identity, jitter=0, h=240, w=320):
    """The identity-coded image: identity and jitter in pixels [0, 0] and
    [0, 1] of every channel."""
    img = np.full((h, w, 3), 128, np.uint8)
    img[0, 0, :] = identity
    img[0, 1, :] = jitter
    return img


def identity_embedding(identity, jitter=0, dim=512):
    """A fixed unit vector per identity; a jitter moves it to cosine about
    0.83 (above the grouping thresholds, below the duplicate one)."""
    v = np.random.default_rng(1000 + identity).normal(size=dim).astype(
        np.float32)
    if jitter:
        v = v / np.linalg.norm(v)
        v = v + np.random.default_rng(5000 + jitter).normal(
            scale=0.03, size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


class IdentityApp:
    """FaceAnalysis-shaped stand-in whose faces are read from the image's
    identity pixels: one face a image, its embedding
    ``identity_embedding``. ``get_batch`` is the port facade's routing."""

    MIN_STATIC_GROUP = 8

    def __init__(self, det_score=0.9, bbox=(100, 100, 200, 230)):
        self.det_score = det_score
        self.bbox = np.asarray(bbox, np.float32)
        self._microbatcher = None

    def prepare(self, ctx_id=0, det_size=(640, 640), det_thresh=0.5):
        pass

    def get(self, image, max_num=0):
        return self.get_batch([np.asarray(image)], max_num=max_num)[0]

    def get_batch(self, images, max_num=0):
        from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis

        return FaceAnalysis.get_batch(self, images, max_num=max_num)

    def _get_batch_direct(self, images, max_num=0):
        from scrfd_arcface_facerecognition_tpu_torch.apps import Face

        out = []
        for im in images:
            im = np.asarray(im)
            emb = identity_embedding(int(im[0, 0, 0]), int(im[0, 1, 0]))
            x1, y1, x2, y2 = self.bbox
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            kps = np.asarray([[cx - 30, cy - 30], [cx + 30, cy - 30],
                              [cx, cy], [cx - 30, cy + 30],
                              [cx + 30, cy + 30]], np.float32)
            out.append([Face(bbox=self.bbox.copy(), kps=kps,
                             det_score=self.det_score, embedding=emb * 10.0,
                             normed_embedding=emb)])
        return out


def engine_visits(n, url, box=True):
    """n visit records, visit i's image at ``url(i)``."""
    ok_box = {"width": 90, "height": 120, "top": 300, "left": 300}
    return {"visits": [{
        "id": i, "image": url(i), "customerId": f"cust_{i}",
        "entryTime": f"2025-01-0{1 + i % 9}T10:00:00", "branchId": "b1",
        "entryEventIds": ([{"box": ok_box, "event": "entry",
                            "fileName": f"f{i}.jpg", "camera": "cam1"}]
                          if box else [])} for i in range(n)]}


_PERSON = __import__("re").compile(r"^(Person_.*)_\d{9,}$")
# the columns SQLite fills from the clock (CURRENT_TIMESTAMP)
CLOCK_COLUMNS = ("created_at", "last_seen", "processed_at")


def without_clock(v):
    """A record value without what the clock wrote: the clock columns of
    dict rows and the time() suffix of person names."""
    if isinstance(v, str):
        return _PERSON.sub(r"\1_<t>", v)
    if isinstance(v, dict):
        return {k: without_clock(x) for k, x in v.items()
                if k not in CLOCK_COLUMNS}
    if isinstance(v, (list, tuple)):
        return [without_clock(x) for x in v]
    return v


def engine_record(engine):
    """What an engine decided, without timestamps: every SQLite table's
    rows in insertion order (without the clock columns), the
    clustering_results payloads in the order written (without job id and
    time), the gallery's ids."""
    import glob
    import sqlite3

    con = sqlite3.connect(engine.database_path)
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name "
            "NOT LIKE 'sqlite_%' ORDER BY name")]
        db = {}
        for t in tables:
            cur = con.execute(f"SELECT * FROM {t} ORDER BY rowid")
            cols = [d[0] for d in cur.description]
            db[t] = [without_clock(dict(zip(cols, row))) for row in cur]
    finally:
        con.close()
    files = sorted(glob.glob(os.path.join(engine.json_storage.output_dir,
                                          "clustering_results_*.json")),
                   key=lambda f: (os.path.getmtime(f), f))
    payloads = []
    for f in files:
        with open(f) as fh:
            p = json.load(fh)
        p.pop("job_id", None)
        p.pop("timestamp", None)
        payloads.append(without_clock(p))
    return {"db": db, "json": payloads,
            "gallery": sorted(engine.vector_db.ids())}


def record_diff(a, b, tol, path="record"):
    """None when the records agree (floats within ``tol``), else the path
    of the first difference and the two values."""
    if isinstance(a, float) or isinstance(b, float):
        if (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and abs(a - b) <= tol):
            return None
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            d = record_diff(a[k], b[k], tol, f"{path}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = record_diff(x, y, tol, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def engine_config(tmp, **vdb):
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG, deep_update)

    return deep_update(DEFAULT_CONFIG, {
        "system": {"database_path": os.path.join(tmp, "face.db"),
                   "image_cache_dir": os.path.join(tmp, "cache")},
        "vector_database": vdb})


def faces_close(want, got):
    """The microbatch contract: same face count, bbox atol 1e-2,
    embeddings atol 1e-3."""
    if len(want) != len(got):
        return False
    return all(np.allclose(a.bbox, b.bbox, atol=1e-2, rtol=0)
               and np.allclose(a.normed_embedding, b.normed_embedding,
                               atol=1e-3, rtol=0)
               for a, b in zip(want, got))


@contextlib.contextmanager
def captured_calls(module, name, key=None):
    """Calls of ``module.<name>`` go through unchanged; the list this
    yields gets a clone of the positional arguments of every call, or with
    ``key`` of the first call for each ``key(args)``. The clones are made
    before the call, so they are the inputs that call saw."""
    fn = getattr(module, name)
    kept, seen = [], set()

    def wrapped(*a, **k):
        sig = key(a) if key else len(kept)
        if sig not in seen:
            seen.add(sig)
            kept.append(tuple(x.clone() if hasattr(x, "clone") else x
                              for x in a))
        return fn(*a, **k)

    setattr(module, name, wrapped)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def k1_capture():
    """K1's inputs on the facade path: the first call for each frame-batch
    shape (each static chunk shape and each dynamic bucket)."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    return captured_calls(ops, "warp_align_crops",
                          key=lambda a: tuple(a[0].shape))


def k1_on_path(torch, wa, calls):
    """K1 against its plain version on captured (frames, minv, frame_idx)
    calls: the largest error in u8 units and a summary of the inputs."""
    worst = 0.0
    for frames, minv, fidx in calls:
        err, _ = compare_k1(torch, wa, frames, minv, fidx)
        worst = max(worst, err)
    shapes = ", ".join(f"{len(m)} crops over {'x'.join(map(str, f.shape[:3]))}"
                       for f, m, _ in calls)
    return worst, f"{len(calls)} calls ({shapes})"


class LogRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def port_log(what):
    """The port's log records at INFO and above during the block, in the
    list this yields; an ERROR record fails the run once the block ends
    (the engines log a fault they absorb at ERROR)."""
    lg = logging.getLogger("scrfd_arcface_facerecognition_tpu_torch")
    handler, level = LogRecords(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        yield handler.records
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    errors = [r for r in handler.records if r.levelno >= logging.ERROR]
    if errors:
        fail(f"{what}: the port logged {len(errors)} error(s), the first: "
             f"{errors[0].name}: {errors[0].getMessage()}")


# the engine's gates that count a visit as "no face", by the message each
# logs (apps/clustering.py _gate_face); a visit with no face logs nothing
NO_FACE_GATES = (("confidence", "face confidence too low"),
                 ("side face", "side face rejected"))


def no_face_split(records, n_no_face):
    """The "no face" count split by the gate that gave it."""
    split = {name: sum(r.msg.startswith(prefix) for r in records)
             for name, prefix in NO_FACE_GATES}
    split["no face detected"] = n_no_face - sum(split.values())
    return split


def phase_facade(torch, rep):
    """12a: get_batch over the three routes; returns the facade."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    t0 = time.perf_counter()
    app = FaceAnalysis(det_variant=FACADE["det"], rec_variant=FACADE["rec"],
                       max_det=FACADE["max_det"], seed=0, device=DEV)
    app.prepare(det_size=FACADE["det_size"])
    rng = np.random.default_rng(12)
    (ns, hs, ws), (nt, ht, wt) = FACADE["static"], FACADE["stream"]
    static = [rng.integers(0, 256, (hs, ws, 3), dtype=np.uint8)
              for _ in range(ns)]
    stream = [rng.integers(0, 256, (ht, wt, 3), dtype=np.uint8)
              for _ in range(nt)]
    oneoff = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FACADE["oneoff"]]
    images = static + stream + oneoff
    chunks, buckets = app.routes(images)
    if len(chunks) < 2 or not buckets:
        fail(f"facade: routing gave {len(chunks)} static chunks and "
             f"{len(buckets)} buckets")
    with k1_capture() as k1_calls:          # warm-up (cuDNN, allocator)
        app.get_batch(images)
    torch.cuda.synchronize()
    rep.say(f"facade: FaceAnalysis({FACADE['det']} + {FACADE['rec']}, "
            f"seeded, max_det {FACADE['max_det']}) on {app.device}, "
            f"det_size {FACADE['det_size']}; "
            f"setup + warm-up {time.perf_counter() - t0:.2f} s")

    seen = []
    pipe = app._pipe

    def spy(route, fn):
        def wrapped(frames, *a, **k):
            seen.append((route, tuple(np.shape(frames))))
            return fn(frames, *a, **k)
        return wrapped

    pipe.process_stream = spy("stream", pipe.process_stream)
    pipe.call_dynamic = spy("dynamic", pipe.call_dynamic)
    wa.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    faces = app.get_batch(images)
    torch.cuda.synchronize()
    mixed_ms = (time.perf_counter() - t) * 1e3
    launches = wa.launches
    del pipe.process_stream, pipe.call_dynamic
    if launches <= 0:
        fail("facade path launched K1 no time")
    for f in (x for fs in faces for x in fs):
        e = np.asarray(f.normed_embedding)
        if e.shape != (512,) or not np.isfinite(e).all() or abs(
                float(np.linalg.norm(e)) - 1) > 1e-3:
            fail("facade: an embedding is not a finite unit 512-vector")
    routes = {r for r, _ in seen}
    if routes != {"stream", "dynamic"}:
        fail(f"facade: routes taken {sorted(routes)}")
    per = [len(f) for f in faces]
    rep.say(f"facade: get_batch of {len(images)} images in {mixed_ms:.2f} ms, "
            f"K1 launches {launches}; faces per image: static "
            f"{ns}x{hs}x{ws} {per[:ns]}, {nt}x{ht}x{wt} "
            f"{per[ns:ns + nt]}, one-off {per[ns + nt:]}; routes: "
            f"{len(chunks)} static chunks "
            f"{[len(c) for c in chunks]} streamed through process_stream, "
            + ", ".join(f"bucket {bh}x{bw} {len(ix)} image(s)"
                        for (bh, bw), ix in buckets.items())
            + f" through call_dynamic ({sum(r == 'dynamic' for r, _ in seen)}"
            f" calls)")

    # ms by route (medians of 3)
    by_route = {}
    for name, group in (("static (one chunk)", static),
                        ("two static chunks, streamed", static + stream),
                        ("dynamic buckets", oneoff)):
        by_route[name] = median_ms(torch, lambda: app.get_batch(group),
                                   n=3)[0]
    rep.say("facade: ms per get_batch by route (median of 3): " + "; ".join(
        f"{k} {v:.2f} ms ({v / n:.2f} an image)" for (k, v), n in zip(
            by_route.items(), (ns, ns + nt, len(oneoff)))))

    # each one-off image's dynamic canvas against its exact-shape letterbox
    worst = 0.0
    model_hw = app.detector.input_size
    step = max(1, min(app.chunk, app.DYNAMIC_CHUNK))
    for bucket_hw, idxs in buckets.items():
        for c in range(0, len(idxs), step):
            part = idxs[c:c + step]
            frames, wy, wx, _, hws = app.dynamic_inputs(images, part,
                                                        bucket_hw)
            canvas = ops.letterbox_dynamic(
                torch.from_numpy(frames).to(DEV),
                torch.from_numpy(wy).to(DEV), torch.from_numpy(wx).to(DEV))
            for bi, i in enumerate(part):
                h, w = (int(v) for v in hws[bi])
                exact = ops.letterbox(torch.from_numpy(images[i]).to(DEV),
                                      ops.letterbox_plan((h, w), model_hw))
                worst = max(worst, float((canvas[bi] - exact).abs().max()))
    if not worst <= TOL_CANVAS:
        fail(f"facade: dynamic canvas differs from the exact-shape "
             f"letterbox by {worst} (tolerance {TOL_CANVAS})")
    rep.say(f"facade: {len(oneoff)} one-off images' dynamic canvases vs "
            f"exact-shape letterbox: max |d| {worst:.3g} (tolerance "
            f"{TOL_CANVAS})")

    # K1 against its plain version on the inputs this path gave it
    err, what = k1_on_path(torch, wa, k1_calls)
    if len({tuple(f.shape) for f, _, _ in k1_calls}) < len(chunks) + 1:
        fail(f"facade: K1's inputs captured from {what}")
    rep.say(f"facade: K1 vs plain on the get_batch call's inputs, {what}: "
            f"max abs err {err:.6g} u8 (tolerance {TOL_U8})")
    return app, dict(launches=launches, mixed_ms=mixed_ms, routes=by_route,
                     err=err)


def phase_microbatch(torch, rep, app):
    """12b: 16 threads, one get() each, through the collector."""
    import threading

    rng = np.random.default_rng(13)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FACADE["microbatch"]]
    groups = []
    direct = app._get_batch_direct

    def recorded(imgs, max_num=0):
        groups.append([next(i for i, im in enumerate(images) if im is x)
                       for x in imgs])
        return direct(imgs, max_num=max_num)

    app._get_batch_direct = recorded
    mb = app.enable_microbatch(max_batch=len(images), max_wait_ms=50.0)
    got = [None] * len(images)

    def worker(i):
        got[i] = app.get(images[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(images))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    app.disable_microbatch()
    del app._get_batch_direct
    n_items, n_batches = mb.n_items, mb.n_batches
    if n_items != len(images) or sorted(sum(groups, [])) != list(
            range(len(images))):
        fail(f"microbatch: {n_items} items served, groups {groups}")
    bad = []
    for g in groups:
        want = app.get_batch([images[i] for i in g])
        bad += [i for i, w in zip(g, want) if not faces_close(w, got[i])]
    if bad:
        fail(f"microbatch: images {bad} differ from the direct get_batch")
    rep.say(f"microbatch: {len(images)} threads x get(), n_items {n_items}, "
            f"n_batches {n_batches} (groups {[len(g) for g in groups]}); "
            f"every image's faces equal the direct get_batch of its batch "
            f"(bbox atol 1e-2, embeddings atol 1e-3; "
            f"{sum(len(f) for f in got)} faces)")
    return dict(n_items=n_items, n_batches=n_batches)


def run_engine(tmp, app, loader, visits, batches, device, **vdb):
    from scrfd_arcface_facerecognition_tpu_torch.apps import SmartFaceEngine

    eng = SmartFaceEngine(config=engine_config(tmp, **vdb), app=app,
                          image_loader=loader,
                          results_dir=os.path.join(tmp, "results"),
                          device=device)
    totals = {}
    step = -(-len(visits["visits"]) // batches)
    for c in range(0, len(visits["visits"]), step):
        res = eng.process_visit_data_from_json(
            {"visits": visits["visits"][c:c + step]}, save_images=False)
        for k, v in res.items():
            totals[k] = totals.get(k, 0) + v
    return eng, totals


def phase_engine(torch, rep, app):
    """12c: the clustering engine on the facade."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    hw = FACADE["visit_hw"]
    loader = (lambda src, save_path=None, timeout=30:
              loader_image(src, hw))
    n = FACADE["visits"]
    visits = engine_visits(n, lambda i: f"http://cam/visit_{i}.jpg")
    with tempfile.TemporaryDirectory() as tmp, port_log(
            "engine") as records, k1_capture() as k1_calls:
        wa.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng, res = run_engine(tmp, app, loader, visits, 1, DEV)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        k1 = wa.launches
        files = [os.path.join(eng.json_storage.output_dir, f)
                 for f in os.listdir(eng.json_storage.output_dir)]
        size = sum(os.path.getsize(f) for f in files)
    # each visit lands in exactly one of these counters
    if k1 <= 0 or sum(res[k] for k in (
            "new_persons", "recognized", "duplicate_faces", "no_faces",
            "low_quality", "download_failed")) != n:
        fail(f"engine: K1 launches {k1}, results {res}")
    rep.say(f"engine: SmartFaceEngine on the facade, {n} visits of "
            f"{hw[0]}x{hw[1]} images (seeded weights: groupings are not "
            f"meaningful): new persons {res['new_persons']}, assigned "
            f"{res['recognized']}, skipped (duplicates) "
            f"{res['duplicate_faces']}, no face {res['no_faces']}, low "
            f"quality {res['low_quality']}; {ms:.1f} ms, {ms / n:.2f} ms a "
            f"visit; K1 launches {k1}; clustering_results {len(files)} "
            f"file(s), {size} B")
    split = no_face_split(records, res["no_faces"])
    if split["no face detected"] < 0:
        fail(f"engine: {res['no_faces']} visits counted no face, but the "
             f"gates logged {split}")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"engine: 'no face' by gate: " + ", ".join(
        f"{k} {v}" for k, v in split.items()) + f"; no ERROR logged; K1 vs "
        f"plain on the run's inputs, {what}: max abs err {err:.6g} u8")
    return dict(k1=k1, ms_visit=ms / n, err=err, no_face=split)


def phase_engine_pq(torch, rep):
    """12c: the clustering engine on the PQ tier, identity-coded; its
    decisions on the card equal those on the CPU."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq, pq_adc

    cfg = ENGINE_PQ
    ident = [(i % cfg["idents"], i // cfg["idents"])
             for i in range(cfg["visits"])]
    pq_visits = engine_visits(cfg["visits"],
                              lambda i: "http://cam/id_%d_%d.jpg" % ident[i])

    def pq_loader(src, save_path=None, timeout=30):
        a, b = src.rsplit("/", 1)[1][3:-4].split("_")
        return identity_image(int(a), int(b))

    vdb = dict(tier="pq", pq_min_train_rows=cfg["min_train_rows"])
    runs = []                     # (results, ms, K2 launches, tier, record)
    for device in (DEV, "cpu"):
        with tempfile.TemporaryDirectory() as tmp, port_log(
                "engine on the PQ tier"), captured_calls(
                pq, "pq_adc_scores") as calls:
            pq_adc.launches = 0
            t = time.perf_counter()
            eng, res = run_engine(tmp, IdentityApp(), pq_loader, pq_visits,
                                  cfg["batches"], device, **vdb)
            runs.append((res, (time.perf_counter() - t) * 1e3,
                         pq_adc.launches, eng.vector_db.tier,
                         engine_record(eng)))
        if not runs[1:]:
            k2_calls = calls             # the searches of the card's run
    (res, ms, k2, tier, card), cpu = runs
    if tier != "pq" or k2 <= 0 or not k2_calls:
        fail(f"engine on the PQ tier: tier {tier}, K2 launches {k2}, "
             f"{len(k2_calls)} searches captured")
    # K2 against its plain version on each search's LUT and codes: the
    # decisions come from the exact rerank of K2's shortlist, so they
    # alone would not show a wrong score
    err, rel = 0.0, 0.0
    for lut, codes, precision in k2_calls:
        e, r = compare_k2(torch, pq_adc, lut, codes, precision)
        err, rel = max(err, e), max(rel, r)
    diff = record_diff(card, cpu[4], TOL_RECORD)
    if diff:
        fail(f"engine on the PQ tier: card and CPU decide differently: "
             f"{diff}")
    n_rows = sum(len(v) for v in card["db"].values())
    rep.say(f"engine, PQ tier (min_train_rows {cfg['min_train_rows']}), "
            f"identity-coded app, {cfg['visits']} visits of "
            f"{cfg['idents']} identities in {cfg['batches']} batches: new "
            f"persons {res['new_persons']}, assigned {res['recognized']}, "
            f"skipped {res['duplicate_faces']}, no face {res['no_faces']}; "
            f"{ms / cfg['visits']:.2f} ms a visit on the card "
            f"({cpu[1] / cfg['visits']:.2f} on the CPU); K2 launches "
            f"{k2}; decisions ({n_rows} SQLite rows, "
            f"{len(card['json'])} results files) equal to the CPU "
            f"run's (floats within {TOL_RECORD}); K2 vs plain on the "
            f"searches' inputs (" + ", ".join(
                f"LUT {tuple(lut.shape)} {prec}, codes {tuple(codes.shape)}"
                for lut, codes, prec in k2_calls) + f"): max abs err "
            f"{err:.6g} = {rel:.3g} of max |score| (tolerance {TOL_K2})")
    return dict(k2=k2, ms_visit=ms / cfg["visits"], err=err)


def phase_verification(torch, rep, app):
    """12d: FaceComparison on the facade."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceComparison
    from scrfd_arcface_facerecognition_tpu_torch.apps.verification import (
        build_comparison_results_json)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG)

    hw = FACADE["visit_hw"]
    n = FACADE["pairs"]
    fc = FaceComparison(config=DEFAULT_CONFIG, app=app,
                        image_loader=lambda src: loader_image(src, hw),
                        log_file=None, device=DEV)
    records = fc.transform_records([
        {"id": f"r{i}", "image": f"http://cam/a_{i}.jpg",
         "refImage": f"http://cam/{'a' if i % 3 == 0 else 'b'}_{i}.jpg",
         "isConverted": i % 2 == 0, "branchId": "b1"} for i in range(n)])
    with port_log("verification"):
        wa.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fc.process_face_comparisons(records)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        k1 = wa.launches
    keys = {"total_comparisons", "processed", "same_person",
            "different_person", "errors", "accuracy_vs_api", "api_matches",
            "total_with_api_data", "results"}
    ok = (keys <= set(out) and out["total_comparisons"] == n
          and out["processed"] == n == len(out["results"])
          and out["same_person"] + out["different_person"]
          + out["errors"] == n
          and out["total_with_api_data"] == n
          and 0 <= out["api_matches"] <= n
          and abs(out["accuracy_vs_api"] - 100.0 * out["api_matches"] / n)
          < 1e-9)
    payload = build_comparison_results_json(out)
    if not ok or len(payload["comparisons"]) != n or k1 <= 0:
        fail(f"verification: malformed accuracy block "
             f"{ {k: v for k, v in out.items() if k != 'results'} }, "
             f"K1 launches {k1}")
    block = {k: out[k] for k in ("total_comparisons", "same_person",
                                 "different_person", "errors",
                                 "accuracy_vs_api", "api_matches")}
    rep.say(f"verification: FaceComparison on the facade, {n} pairs of "
            f"{hw[0]}x{hw[1]} images: {json.dumps(block)}; {ms:.1f} ms, "
            f"{ms / n:.2f} ms a pair; K1 launches {k1}")
    return dict(ms_pair=ms / n, k1=k1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from scrfd_arcface_facerecognition_tpu_torch import cuda_build
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    t_start = time.perf_counter()
    card = card_line()
    rep = Report(card)
    # 1. toolchain
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError:
        print("triton does not import")
    print(f"card: {card}")

    # 2. build
    secs = cuda_build.build_all()
    rep.say("built " + ", ".join(f"{n} in {s:.2f} s" for n, s in secs.items())
            + " (nvcc, sm_90a)")

    # 3. K1 against its plain version
    err3 = phase_kernel_vs_plain(torch, wa, rep)

    # 4. the main path at full width
    launches, err4, t, main_emb = phase_main_path(torch, rep)

    # 5. card vs CPU, TF32 off for this phase only
    with full_f32(torch):
        phase_card_vs_cpu(torch, rep)

    # 6. K2 against its plain version
    err6 = phase_k2_vs_plain(torch, pq_adc, rep)

    # 7. the gallery path at full width
    gal = phase_gallery_path(torch, rep, main_emb)

    # 8. the PQ gallery, card vs CPU
    phase_gallery_card_vs_cpu(torch, rep, gal["codec"], gal["rows"],
                              gal["ids"], gal["queries"])

    # 9. K3 on its path; 10. K4 on its path; 11. the stand-in main path
    k3 = phase_k3(torch, rep)
    k4 = phase_k4(torch, rep)
    sp = phase_standin_path(torch, rep)

    # 12. the facade and the engines
    app, fa = phase_facade(torch, rep)
    phase_microbatch(torch, rep, app)
    eng = phase_engine(torch, rep, app)
    eng_pq = phase_engine_pq(torch, rep)
    phase_verification(torch, rep, app)

    # 13. kernels
    t2 = gal["times"]
    kernels = [{
        "name": wa.NAME, "route": "cuda",
        "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/warp_align.cu",
        "replaces": "scrfd_arcface_facerecognition_tpu/ops/pallas_warp.py:430",
        "launches": launches,
        "max_abs_err": max(err3, err4, sp["err1"], fa["err"], eng["err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }, {
        "name": pq_adc.NAME, "route": "cuda",
        "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/pq_adc.cu",
        "replaces": "scrfd_arcface_facerecognition_tpu/gallery/pq.py:302",
        "launches": gal["launches"],
        "max_abs_err": max(err6, gal["err"], eng_pq["err"]),
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
        "library_ms": t2["library_ms"],
    }, {
        "name": "warp_band", "route": "cuda",
        "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/warp_band.cu",
        "replaces": "tools/exp_warp2.py:188",
        "launches": k3["launches"], "max_abs_err": max(k3["err"], sp["err"]),
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None,
    }, {
        "name": "conv3x3", "route": "cuda",
        "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/conv3x3.cu",
        "replaces": "tools/exp_pallas_conv.py:110",
        "launches": k4["launches"], "max_abs_err": k4["err"],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]
    rep.say(f"chip_smoke done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
