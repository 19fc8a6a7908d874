"""Kernel K1's walk (``csrc/warp_align.cu``) emulated on the CPU.

The kernel splits each crop into tiles of a few output rows, one CTA a
tile, and gives each thread 4 pixels of one row, whose 48 byte loads it
issues from clamped addresses before it sums; the tile passes through
shared memory so that each thread then stores 4 consecutive pixels. It
runs only on the card; here its walk is replayed step by step, with the
geometry read from the source, in f32 with one rounding a step as the
kernel (built with --fmad=false) rounds, and held bit for bit, NaN for
NaN, to ``warp_align_plain``: every output pixel written exactly once, by
the thread and tile the kernel gives it. The emulation also agrees with
the JAX reference's warp + ArcFace normalize within 1e-3 u8, and the
plain version follows the kernel's rule for frame indices outside
[0, B).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu.ops import warp as jwarp
from scrfd_arcface_facerecognition_tpu_torch import cuda_build
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
from scrfd_arcface_facerecognition_tpu_torch.ops.warp import invert_affine
from scrfd_arcface_facerecognition_tpu_torch.tools import warp_align_ablate
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def _geometry(src=None):
    """kRows, kQuad, kQuads, kThreads and the grid cap of the kernel's
    source, and whether its tile_col is the mapping ``_emulate`` uses."""
    src = src or cuda_build.source_path(wa.NAME).read_text()
    geo = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kRows", "kQuad", "kQuads", "kMaxGridY")}
    assert "constexpr int kThreads = kRows * kQuads;" in src
    geo["kThreads"] = geo["kRows"] * geo["kQuads"]
    geo["strided"] = "{ return q + kQuads * k; }" in src
    return geo


def _frames(rng, b, h, w):
    low = rng.uniform(0, 255, (b, 3, max(h // 8, 2), max(w // 8, 2)))
    big = torch.nn.functional.interpolate(
        torch.from_numpy(low.astype(np.float32)), size=(h, w),
        mode="bilinear", align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1
                                                            ).contiguous()


def _matrices(rng, n, h, w):
    """(n, 2, 3) dst -> src: scales 0.2-4, any rotation, centers up to 30 %
    off the frame; then a singular source matrix (inf / NaN inverse), a
    NaN translation and a wholly off-frame crop."""
    ms = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        sigma = rng.uniform(0.2, 4.0)
        ang = rng.uniform(-np.pi, np.pi)
        c = rng.uniform([-0.3 * w, -0.3 * h], [1.3 * w, 1.3 * h])
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        ms[i, :, :2] = rot
        ms[i, :, 2] = np.array([55.5, 55.5]) - rot @ c
    ms[0] = 0.0
    ms[1, :, 2] = np.nan
    ms[2] = [[1, 0, -1e6], [0, 1, 0]]
    return ms, invert_affine(torch.from_numpy(ms)).contiguous()


def _emulate(frames, minv, frame_idx, out_hw, geo, grid_x=None, grid_y=None):
    """The kernel's walk on the CPU: for each CTA (tile column bx of
    ``grid_x``, crop row by of ``grid_y``, each looping as the kernel
    does) and each tile of kRows x kCols output pixels, thread (r, q)
    computes the pixels at tile columns q + kQuads * k (its 4 pixels'
    coordinates and weights, the 48 loads from clamped addresses, the sums
    in tap order) into the tile, then stores the tile columns 4q .. 4q + 3
    of its row (float4 when OW % 4 == 0, else scalars up to OW). Returns
    the output, started as NaN, and how many times each element was
    written."""
    rows, quad, quads = geo["kRows"], geo["kQuad"], geo["kQuads"]
    cols = quad * quads
    b, h, w, _ = frames.shape
    oh, ow = out_hw
    f = minv.shape[0]
    out = torch.full((f, 3, oh, ow), float("nan"))
    writes = torch.zeros((f, 3, oh, ow), dtype=torch.int64)
    nbands, nchunks = -(-oh // rows), -(-ow // cols)
    grid_x = nbands * nchunks if grid_x is None else grid_x
    grid_y = min(f, geo["kMaxGridY"]) if grid_y is None else grid_y
    flat = frames.reshape(-1)
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    inv_std = torch.tensor(1.0 / 127.5, dtype=torch.float32)
    # the CTA's threads: thread x is (r, q) = (x // kQuads, x % kQuads)
    x = torch.arange(geo["kThreads"])
    r, q = x // quads, x % quads
    for by in range(grid_y):
        for fi in range(by, f, grid_y):
            m = minv[fi].reshape(6)
            bi = int(frame_idx[fi])
            frame_ok = 0 <= bi < b
            base = bi * h * w * 3 if frame_ok else 0
            for bx in range(grid_x):
                for t in range(bx, nbands * nchunks, grid_x):
                    i = (t // nchunks) * rows + r
                    c0 = (t % nchunks) * cols
                    tile = torch.full((3, rows, cols), float("nan"))
                    live = i < oh
                    il, ql, rl = i[live], q[live], r[live]
                    gy = il.to(torch.float32)
                    wts, pix = [], []
                    for k in range(quad):
                        gx = (c0 + ql + quads * k).to(torch.float32)
                        sx = (m[0] * gx + m[1] * gy) + m[2]
                        sy = (m[3] * gx + m[4] * gy) + m[5]
                        x0, y0 = torch.floor(sx), torch.floor(sy)
                        fx, fy = sx - x0, sy - y0
                        gx0, gy0 = one - fx, one - fy
                        x1, y1 = x0 + one, y0 + one
                        wk = (gx0 * gy0, fx * gy0, gx0 * fy, fx * fy)
                        for xt, yt, wt in zip((x0, x1, x0, x1),
                                              (y0, y0, y1, y1), wk):
                            inside = (frame_ok & (xt >= 0) & (xt <= w - 1)
                                      & (yt >= 0) & (yt <= h - 1))
                            xi = torch.where(inside, xt, zero).to(torch.int64)
                            yi = torch.where(inside, yt, zero).to(torch.int64)
                            pix.append(yi * w + xi)
                            wts.append(wt * torch.where(inside, one, zero))
                    # every load of the 4 pixels, from always-valid addresses
                    vals = [[flat[base + p * 3 + c].to(torch.float32)
                             for c in range(3)] for p in pix]
                    for k in range(quad):
                        for c in range(3):
                            s = [vals[k * 4 + n][c] * wts[k * 4 + n]
                                 for n in range(4)]
                            acc = ((s[0] + s[1]) + s[2]) + s[3]
                            tile[2 - c, rl, ql + quads * k] = \
                                (acc - 127.5) * inv_std
                    # the stores: thread (r, q) writes tile columns 4q + k
                    for k in range(quad):
                        j = c0 + quad * q + k
                        keep = live & (j < ow)
                        for c in range(3):
                            out[fi, c, i[keep], j[keep]] = \
                                tile[c, r[keep], quad * q[keep] + k]
                            writes[fi, c, i[keep], j[keep]] += 1
    return out, writes


def _case(seed, b, h, w, n):
    rng = np.random.default_rng(seed)
    frames = _frames(rng, b, h, w)
    _, minv = _matrices(rng, n, h, w)
    fidx = torch.from_numpy(rng.integers(0, b, n).astype(np.int32))
    return frames, minv, fidx


def test_kernel_geometry_is_the_emulated_one():
    """A tile is kRows x 112 output pixels, 28 threads a row, 4 pixels a
    thread taken 28 apart: the mapping the emulation replays; the
    ablation's quad_cols variant is the other mapping."""
    geo = _geometry()
    assert geo["kQuad"] == 4 and geo["kQuad"] * geo["kQuads"] == 112
    assert geo["strided"]
    assert not _geometry(warp_align_ablate.variant_source("quad_cols")
                         )["strided"]
    for name, rows in (("rows2", 2), ("rows8", 8)):
        assert _geometry(warp_align_ablate.variant_source(name))[
            "kRows"] == rows


@pytest.mark.parametrize("variant", ["rows2", "rows8"])
def test_emulated_walk_of_the_ablation_geometries(variant):
    """The ablation's other tile shapes replay to the same crops."""
    frames, minv, fidx = _case(6, 2, 30, 50, 4)
    geo = _geometry(warp_align_ablate.variant_source(variant))
    got, writes = _emulate(frames, minv, fidx, (14, 118), geo)
    assert bool((writes == 1).all())
    torch.testing.assert_close(got, wa.warp_align_plain(frames, minv, fidx,
                                                        (14, 118)),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("out_hw", [(112, 112), (112, 110), (13, 7),
                                    (9, 230)])
def test_emulated_walk_is_bit_equal_to_the_plain_version(out_hw):
    """Every tile of the walk, including an OW off the 4-pixel quads (the
    scalar tail), an OH off the tile's rows, an OW of three 112-column
    tiles, NaN and degenerate matrices, off-frame crops."""
    frames, minv, fidx = _case(1, 3, 40, 64, 7)
    got, writes = _emulate(frames, minv, fidx, out_hw, _geometry())
    want = wa.warp_align_plain(frames, minv, fidx, out_hw)
    assert bool((writes == 1).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[:2]).all()) and bool(torch.isfinite(got[2:]
                                                                    ).all())


def test_emulated_walk_with_fewer_ctas_than_bands_and_crops():
    """A CTA loops over tiles (one CTA a crop, the ablation's
    ``one_cta_per_crop``) and over crops (more crops than the grid's y
    limit): the same crops."""
    frames, minv, fidx = _case(2, 2, 30, 50, 5)
    geo = _geometry()
    want = wa.warp_align_plain(frames, minv, fidx, (20, 12))
    for gx, gy in ((1, None), (2, 2), (None, 1)):
        got, writes = _emulate(frames, minv, fidx, (20, 12), geo, gx, gy)
        assert bool((writes == 1).all())
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_emulated_walk_matches_the_jax_warp_and_normalize():
    """The same seeded inputs through the JAX package's warp_affine_flat +
    ArcFace normalize (src -> dst matrices) and through the emulated
    kernel: within 1e-3 u8, NaN where the reference is NaN."""
    rng = np.random.default_rng(3)
    frames = _frames(rng, 2, 48, 80)
    ms, minv = _matrices(rng, 6, 48, 80)
    fidx = rng.integers(0, 2, 6).astype(np.int32)
    crops = jwarp.warp_affine_flat(jnp.asarray(frames.numpy()),
                                   jnp.asarray(ms), jnp.asarray(fidx))
    want = np.asarray(jops.normalize_image(crops, jops.ARCFACE_MEAN,
                                           jops.ARCFACE_STD)
                      ).transpose(0, 3, 1, 2)
    got, _ = _emulate(frames, minv, torch.from_numpy(fidx), (112, 112),
                      _geometry())
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got * 127.5, want * 127.5, atol=1e-3)


def test_frame_index_outside_the_batch_samples_the_border():
    """frame_idx < 0 or >= B: every tap outside, as in the kernel, so a
    finite matrix gives the border value (0 - 127.5) / 127.5 = -1 and a
    NaN matrix NaN; the other crops are as they are alone; the emulated
    kernel agrees bit for bit."""
    frames, minv, fidx = _case(4, 3, 40, 64, 8)
    bad = fidx.clone()
    bad[3], bad[5], bad[1] = -1, 3, 7
    got = wa.warp_align_crops(frames, minv, bad)
    assert bool((got[[3, 5]] == -1.0).all())
    assert bool(torch.isnan(got[1]).all())
    keep = [0, 2, 4, 6, 7]
    torch.testing.assert_close(
        got[keep], wa.warp_align_plain(frames, minv[keep], fidx[keep]),
        rtol=0, atol=0, equal_nan=True)
    emu, _ = _emulate(frames, minv, bad, (112, 112), _geometry())
    torch.testing.assert_close(emu, got, rtol=0, atol=0, equal_nan=True)


def test_frames_smaller_than_a_crops_footprint():
    """Frames of 6 x 9 px under crops of scale 0.2-4: most taps outside,
    the walk and the plain version still equal."""
    frames, minv, fidx = _case(5, 2, 6, 9, 6)
    got, writes = _emulate(frames, minv, fidx, (112, 112), _geometry())
    assert bool((writes == 1).all())
    torch.testing.assert_close(got, wa.warp_align_plain(frames, minv, fidx),
                               rtol=0, atol=0, equal_nan=True)


def test_launch_function_types_every_argument():
    """``warp_align_launch`` takes pointers and the stream as c_void_p (a
    64-bit pointer passed as an int would be cut) and sizes as c_int."""
    import ctypes

    class Lib:
        @staticmethod
        def warp_align_launch(*args):
            return 0

    fn = wa.launch_function(Lib)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    assert fn.argtypes == [ptr, i, i, i, ptr, ptr, i, ptr, i, i, ptr]
    assert fn.restype is ctypes.c_int
