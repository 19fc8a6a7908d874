"""The port's experiment kernels K3 (band-mix warp) and K4 (narrow 3x3 conv)
on the CPU against the JAX scripts' Pallas kernels in interpret mode.

The same seeded numpy inputs go to both. Tolerances: WarpParams integers
and orders equal, floats within 1e-6 relative, fallback flags equal; K3
crops inside the envelope within 1e-2 u8 (the port's plain version is the
five band passes in the reference's f32 order); K4 equal or one bf16 step
apart on every one of the Wp lanes. K4's kernel (tensor cores, its own
sum order) is held to its plain version by ``sum_tolerance_ratio`` <= 1;
here that check passes a float64-summed reference and fails a misplaced or
dropped tap.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import exp_pallas_conv as jconv  # noqa: E402
import exp_warp2 as jwarp  # noqa: E402
from scrfd_arcface_facerecognition_tpu import ops as jops  # noqa: E402
from scrfd_arcface_facerecognition_tpu.ops import pallas_warp as jpw  # noqa: E402
from scrfd_arcface_facerecognition_tpu_torch import ops as tops  # noqa: E402
from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as twp  # noqa: E402
from scrfd_arcface_facerecognition_tpu_torch import cuda_build  # noqa: E402
from scrfd_arcface_facerecognition_tpu_torch.tools import (  # noqa: E402
    conv3x3_ablate, exp_pallas_conv as tconv, exp_warp2 as twarp,
    pq_adc_ablate, warp_align_ablate, warp_band_ablate)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def _similarity(sigma, ang, cx, cy):
    """src -> dst matrix putting (cx, cy) at the crop center, sigma source
    px per crop px, rotated by ang."""
    rot = np.array([[np.cos(ang), -np.sin(ang)],
                    [np.sin(ang), np.cos(ang)]]) / sigma
    t = np.array([twp.C0, twp.C0]) - rot @ np.array([cx, cy])
    return np.concatenate([rot, t[:, None]], axis=1)


def _crops(rng, n, fh, fw):
    """make_workload's draws, then a large face (level 1, in the envelope
    where the canvas is smaller than the frame), a face rotated past
    PHI_MAX, an upside-down face and a face at the frame's edge."""
    ms = [_similarity(rng.uniform(0.5, 1.7), rng.uniform(-0.2, 0.2),
                      rng.uniform(150, fw - 150), rng.uniform(150, fh - 150))
          for _ in range(n)]
    ms += [_similarity(2.5, 0.1, fw / 2, fh / 2),
           _similarity(1.0, 0.5, fw / 2, fh / 2),
           _similarity(1.0, np.pi, fw / 2, fh / 2),
           _similarity(1.2, -0.15, fw - 20, 15)]
    ms = np.stack(ms).astype(np.float32)
    fidx = np.sort(rng.integers(0, 2, len(ms))).astype(np.int32)
    return ms, fidx


@pytest.mark.parametrize("frame_hw", [(540, 960), (320, 1024), (300, 400),
                                      (1080, 1920)])
def test_prepare_warp_params_matches_jax(frame_hw):
    rng = np.random.default_rng(sum(frame_hw))
    ms, fidx = _crops(rng, 12, *frame_hw)
    plan = jops.tight_letterbox_plan(frame_hw, (640, 640))
    want = jpw.prepare_warp_params(jnp.asarray(ms), jnp.asarray(fidx),
                                   frame_hw, plan.det_scale,
                                   canvas_hw=plan.model_hw)
    got = twp.prepare_warp_params(torch.from_numpy(ms),
                                  torch.from_numpy(fidx), frame_hw,
                                  plan.det_scale, canvas_hw=plan.model_hw)
    np.testing.assert_array_equal(got.iparams.numpy(), np.asarray(want.iparams))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.fallback.numpy(),
                                  np.asarray(want.fallback))
    np.testing.assert_allclose(got.fparams.numpy(), np.asarray(want.fparams),
                               rtol=1e-6, atol=0)
    levels = got.iparams[:, 1].numpy()
    if frame_hw[1] < twp.PW:
        assert (levels == 1).all()
    else:
        assert (levels == 0).any() and (levels == 1).any()
    assert got.fallback.any() and not got.fallback.all()


def test_make_workload_matches_jax():
    want = jwarp.make_workload(np.random.default_rng(7), 2, 12, fh=320,
                               fw=640)
    got = twarp.make_workload(np.random.default_rng(7), 2, 12, fh=320,
                              fw=640, device="cpu")
    for g, w in zip(got[:4], want[:4]):
        if g.dtype == torch.uint8 and g.shape[1] != 320:       # the canvas
            d = np.abs(g.numpy().astype(int) - np.asarray(w).astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_warp_crops_band_matches_jax_interpret():
    """2 frames of 320x1024: the canvas (256x640) is smaller than the
    frames, so a large face runs in the envelope at level 1.

    The frames are smooth (16x upsampled noise). XLA:CPU contracts the
    reference's multiply-adds into FMAs, so its band positions can sit an
    ulp away from the plain f32 order; on white noise (255 u8 a pixel) one
    ulp of a position near 500 is 0.016 u8, on these frames about 16x
    less."""
    rng = np.random.default_rng(3)
    fh, fw = 320, 1024
    small = torch.from_numpy(rng.uniform(0, 255, (2, 3, fh // 16, fw // 16))
                             .astype(np.float32))
    frames = torch.nn.functional.interpolate(
        small, size=(fh, fw), mode="bilinear", align_corners=False).round(
        ).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    ms, fidx = _crops(rng, 2, fh, fw)
    plan = jops.tight_letterbox_plan((fh, fw), (640, 640))
    canvas = np.array(jnp.clip(jnp.round(jops.letterbox(
        jnp.asarray(frames), plan)), 0, 255).astype(jnp.uint8))
    jprm = jpw.prepare_warp_params(jnp.asarray(ms), jnp.asarray(fidx),
                                   (fh, fw), plan.det_scale,
                                   canvas_hw=canvas.shape[1:3])
    want = np.asarray(jwarp.warp_crops_band(
        jpw.planarize(jnp.asarray(frames)), jpw.planarize(jnp.asarray(canvas)),
        jprm, interpret=True))
    prm = twp.prepare_warp_params(torch.from_numpy(ms), torch.from_numpy(fidx),
                                  (fh, fw), plan.det_scale,
                                  canvas_hw=canvas.shape[1:3])
    launches = twarp.launches
    got = twarp.warp_crops_band(twp.planarize(torch.from_numpy(frames)),
                                twp.planarize(torch.from_numpy(canvas)), prm)
    assert twarp.launches == launches       # the CPU path launches no kernel
    assert got.shape == want.shape == (len(ms), 112, 112, 3)
    ok = ~prm.fallback.numpy()
    level = prm.iparams[:, 1].numpy()
    assert (ok & (level == 1)).any() and (ok & (level == 0)).any()
    assert not ok.all()
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=0, atol=1e-2)
    assert np.isfinite(want).all() and float(want.max()) > 100


def test_k3_needed_pixels_are_all_the_crops_read():
    """The source pixels `needed` traces back from the crops are all they
    depend on: any other frame or canvas pixel can change and the crops
    stay bit for bit the same. The set is far smaller than the crops'
    512-lane windows over the rows pass 1 reads."""
    rng = np.random.default_rng(5)
    fh, fw = 320, 640
    ms, fidx = _crops(rng, 3, fh, fw)
    frames = torch.from_numpy(rng.integers(0, 256, (2, fh, fw, 3),
                                           dtype=np.uint8))
    plan = tops.tight_letterbox_plan((fh, fw), (640, 640))
    canvas = tops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = twp.prepare_warp_params(torch.from_numpy(ms), torch.from_numpy(fidx),
                                  (fh, fw), plan.det_scale,
                                  canvas_hw=tuple(canvas.shape[1:3]))
    fp, cp = twp.planarize(frames), twp.planarize(canvas)
    counts, hit_f, hit_c = twarp.needed(fp, cp, prm)
    level = prm.iparams[:, 1]
    assert (level == 0).any() and (level == 1).any() and prm.fallback.any()
    assert hit_f.any() and hit_c.any()
    assert 0 < hit_f.float().mean() < 0.5 and 0 < hit_c.float().mean() < 0.5
    f = len(ms)
    assert counts[0] == f * twp.OUT * twp.OUT
    assert all(0 < n < f * twp.Q * twp.Q for n in counts[1:4])
    assert 0 < counts[4] < 0.6 * f * twp.Q * twp.PW
    want = twarp.warp_crops_band_plain(fp, cp, prm)
    noise_f = torch.from_numpy(rng.integers(0, 256, fp.shape, dtype=np.uint8))
    noise_c = torch.from_numpy(rng.integers(0, 256, cp.shape, dtype=np.uint8))
    fp2 = torch.where(hit_f[:, None], fp, noise_f)
    cp2 = torch.where(hit_c[:, None], cp, noise_c)
    assert not torch.equal(fp2, fp) and not torch.equal(cp2, cp)
    got = twarp.warp_crops_band_plain(fp2, cp2, prm)
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])
    # and the traced set is not loose: noise on it changes the crops
    bad = twarp.warp_crops_band_plain(noise_f, noise_c, prm)
    assert not torch.equal(bad[fin], want[fin])


def test_k3_script_paths_run_on_the_cpu(capsys):
    r = twarp.run(batch=2, faces=4, iters=1, fh=320, fw=640, device="cpu")
    assert r["crops"] == 4 and r["in_envelope"] == 4
    assert np.isfinite(r["max_vs_k1"]) and r["band_ms"] > 0
    # the passes match exact bilinear closely on smooth content
    frames, canvas, ms, fidx, prm = twarp.make_workload(
        np.random.default_rng(1), 1, 6, fh=320, fw=640, device="cpu")
    yy, xx = torch.meshgrid(torch.arange(320.0), torch.arange(640.0),
                            indexing="ij")
    smooth = (127 + 60 * torch.sin(xx / 17) + 60 * torch.cos(yy / 23)).round()
    frames = smooth.to(torch.uint8)[None, :, :, None].repeat(1, 1, 1, 3)
    plan = tops.tight_letterbox_plan((320, 640), (640, 640))
    canvas = tops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    band = twarp.warp_crops_band(twp.planarize(frames), twp.planarize(canvas),
                                 prm)
    exact = tops.warp_affine_flat(frames, ms, fidx)
    assert float((band - exact).abs()[~prm.fallback].mean()) < 0.5
    twarp.main(["--check", "--device", "cpu"])
    assert "K3 vs exact bilinear" in capsys.readouterr().out


# --------------------------------------------------------------------------
# K3's fused kernel: its window arithmetic (``fused_plan``) and its schedule


def _stress_params(rng, nb, h, w, n):
    """chip_smoke.py's K3 stress draws: scales to 8 source px a crop px,
    rotations to 0.6 rad and upside down, centers near and past the frame
    edge; smooth frames, the letterbox canvas and the WarpParams."""
    small = torch.from_numpy(rng.uniform(0, 255, (nb, 3, max(h // 16, 2),
                                                  max(w // 16, 2)))
                             .astype(np.float32))
    frames = torch.nn.functional.interpolate(
        small, size=(h, w), mode="bilinear", align_corners=False).round(
        ).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    ms = []
    for _ in range(n):
        sigma = rng.uniform(0.4, 8.0)
        pick = rng.random()
        ang = (rng.uniform(-0.24, 0.24) if pick < 0.6 else
               rng.uniform(-0.6, 0.6) if pick < 0.85 else
               np.pi + rng.uniform(-0.3, 0.3))
        cx = rng.choice([rng.uniform(-60, 120), rng.uniform(w - 120, w + 60),
                         rng.uniform(0, w)])
        cy = rng.choice([rng.uniform(-60, 120), rng.uniform(h - 120, h + 60),
                         rng.uniform(0, h)])
        ms.append(_similarity(sigma, ang, cx, cy))
    fidx = torch.from_numpy(rng.integers(0, nb, n).astype(np.int32))
    plan = tops.tight_letterbox_plan((h, w), (640, 640))
    canvas = tops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = twp.prepare_warp_params(
        torch.from_numpy(np.stack(ms).astype(np.float32)), fidx, (h, w),
        plan.det_scale, canvas_hw=tuple(canvas.shape[1:3]))
    return twp.planarize(frames), twp.planarize(canvas), prm


def _edge_params(rng):
    """Hand-made crops at the edges of the window arithmetic on 2 frames of
    384x512: NaN and infinite sigma / u / v / my / mx, |v| = 1 both ways,
    windows clipped at 0 and at Q - 72, shears past the envelope, my / mx
    at +-inf, frame indices outside [0, B), both pyramid levels."""
    nan, inf = float("nan"), float("inf")
    rows = [  # b, level, ox, sigma, u, v, my, mx
        (0, 0, 0, nan, 0.0, 0.0, 190.0, 250.0),
        (0, 0, 0, 1.0, nan, 0.1, 190.0, 250.0),
        (1, 0, 0, 1.0, -0.05, nan, 190.0, 250.0),
        (0, 1, 0, 1.0, 0.0, 0.1, nan, 250.0),
        (1, 0, 0, 1.0, 0.0, 0.1, 190.0, nan),
        (0, 0, 0, inf, 0.0, 0.0, 190.0, 250.0),
        (1, 0, 0, 1.0, -inf, 0.1, 190.0, 250.0),
        (0, 0, 0, 1.0, 0.0, inf, 190.0, 250.0),
        (0, 0, 0, 1.0, -1.0, 1.0, 190.0, 250.0),     # |v| = 1
        (1, 1, 0, 1.3, 1.0, -1.0, 200.0, 260.0),
        (0, 0, 0, 1.0, -0.5, 0.9, 190.0, 250.0),     # j0_4 clipped at 0
        (1, 0, 0, 1.0, 0.05, -0.1, 190.0, 250.0),    # clipped at Q - 72
        (0, 0, 0, 0.7, 6.5, -0.6, 100.0, 150.0),     # upside down
        (1, 0, 0, 2.0, 0.0, 0.0, inf, 250.0),
        (0, 1, 0, 1.0, 0.0, 0.0, 190.0, -inf),
        (-1, 0, 0, 1.0, 0.0, 0.1, 190.0, 250.0),      # b outside [0, B)
        (2, 1, 0, 1.0, 0.0, 0.1, 190.0, 250.0),
        (0, 0, 0, 8.0, 0.2, 0.2, 10.0, 20.0),        # windows off the top
        (1, 0, 0, 1.5, -0.2, -0.24, 370.0, 480.0),   # ... and the bottom
        (0, 1, 0, 0.25, 0.1, 0.1, 380.0, 500.0),
    ]
    ip = torch.tensor([[b, lv, 0, ox, 0, 0, 0, 0] for b, lv, ox, *_ in rows],
                      dtype=torch.int32)
    fp = torch.tensor([[*r[3:], 0.0, 0.0, 0.0] for r in rows],
                      dtype=torch.float32)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 3, 384, 512),
                                           dtype=np.uint8))
    canvas = torch.from_numpy(rng.integers(0, 256, (2, 3, 384, 512),
                                           dtype=np.uint8))
    prm = twp.WarpParams(ip, fp, torch.zeros(len(rows), dtype=torch.bool),
                         torch.arange(len(rows), dtype=torch.int32))
    return frames, canvas, prm


def _k3_set(name):
    rng = np.random.default_rng(11)
    if name == "workload":
        frames, canvas, _, _, prm = twarp.make_workload(
            rng, 2, 24, fh=540, fw=960, device="cpu")
        return twp.planarize(frames), twp.planarize(canvas), prm
    if name == "edges":
        return _edge_params(rng)
    h, w = dict(stress_wide=(540, 960), stress_512=(384, 512),
                stress_400=(300, 400))[name]
    return _stress_params(rng, 2, h, w, 24)


K3_SETS = ("workload", "stress_wide", "stress_512", "stress_400", "edges")


def _ranges(plan):
    return [plan[:, k:k + 1, None] for k in range(6)]


def test_k3_pass4_band_start_steps_by_0_8_or_16():
    """Pass 4 (alpha 1, 8-aligned) moves its window by 0, 8 or 16 rows from
    one group to the next, whatever v: f32 rounding of base + c can move
    floor by one either way, and the 8-alignment turns that into a step of
    0 or 16. So a group takes at most 16 new p3 rows."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(np.concatenate([
        rng.uniform(-1, 1, 20000), [-1.0, 1.0, 0.0, -0.0, 1e-7, -1e-7],
        np.linspace(-1, 1, 4001)]).astype(np.float32))
    bm = torch.minimum(v * 0.0, v * float(twp.Q - 1))
    base = torch.arange(twp.Q // twarp.G, dtype=torch.float32) * twarp.G
    j0 = twarp.band_start(torch.ones_like(v)[:, None], bm[:, None],
                          (-v * twp.CQ)[:, None], base, twp.Q,
                          twarp.BAND_VY, 8)
    steps = torch.unique(j0[:, 1:] - j0[:, :-1])
    assert set(steps.tolist()) <= {0, 8, 16}
    assert 8 in steps.tolist() and 0 in steps.tolist()
    assert int(j0.min()) == 0 and int(j0.max()) == twp.Q - twarp.BAND_VY


@pytest.mark.parametrize("name", K3_SETS)
def test_k3_fused_plan_covers_every_tap(name):
    """Every tap inside its window, zero weight or not, of every position
    the fused kernel computes lies inside the range the kernel computes
    the pass before at (``fused_plan``), and so does every position
    ``needed_masks`` marks; each pass-4 group's rows are in the ring
    (produced, and not yet overwritten) when the group reads them."""
    _, _, prm = _k3_set(name)
    plan = twarp.fused_plan(prm)
    live = plan[:, 6] == 0
    assert live.any()
    if name == "edges":
        assert int((~live).sum()) == 8
    sigma, u, v, _, mx = (prm.fparams[:, k] for k in range(5))
    one, zero = torch.ones_like(sigma), torch.zeros_like(sigma)
    l4lo, l4hi, l3lo, l3hi, ylo, yhi = _ranges(plan)
    lanes = torch.arange(twp.Q)
    i_q = lanes[None, :, None]                        # output row i
    l_q = lanes[None, None, :]                        # output lane l

    def inside(r, ok, lo, hi, where):
        ok = ok & where & live[:, None, None]
        return bool(((r >= lo) & (r < hi) | ~ok).all())

    # pass 5 (i = x_out, l = y kept) taps p4 lanes x
    kept = torch.arange(twp.LANE_OFF, twp.LANE_OFF + twp.OUT)
    r, ok = twarp._taps(one, u, (twp.CQ - twp.C0) - u * twp.CQ, twp.OUT,
                        kept, twp.Q, twp.Q, twarp.BAND_HX, 8, nonzero=False)
    assert all(inside(r[k], ok[k], l4lo, l4hi, True) for k in range(2))
    # pass 4 (i = y kept, l = x in L4) taps p3 rows y: the group's rows
    r, ok = twarp._taps(one, v, -v * twp.CQ, twp.Q, lanes, twp.Q, twp.Q,
                        twarp.BAND_VY, 8, nonzero=False)
    g = (i_q // twarp.G - twarp.G4).clamp(0, twarp.NG4 - 1)
    rd_lo = plan[:, 8:8 + twarp.NG4].gather(1, g[0, :, 0][None].expand(
        len(plan), -1))[:, :, None]
    rd_hi = plan[:, 8 + twarp.NG4:].gather(1, g[0, :, 0][None].expand(
        len(plan), -1))[:, :, None]
    computed4 = ((i_q >= twp.LANE_OFF) & (i_q < twp.LANE_OFF + twp.OUT)
                 & (l_q >= l4lo) & (l_q < l4hi))
    assert all(inside(r[k], ok[k], rd_lo, rd_hi, computed4)
               for k in range(2))
    assert all(inside(r[k], ok[k], ylo, yhi, computed4) for k in range(2))
    # the ring: rows [made - RING, made) are resident when group g reads,
    # made the production cursor after group g
    made = torch.maximum(plan[:, 8 + twarp.NG4:].cummax(1).values,
                         plan[:, 4:5])
    grp_lo, grp_hi = plan[:, 8:8 + twarp.NG4], plan[:, 8 + twarp.NG4:]
    nonempty = grp_hi > grp_lo
    assert bool(((grp_lo >= made - twarp.RING) & (grp_hi <= made)
                 | ~nonempty).all())
    assert bool(((grp_lo >= plan[:, 4:5]) | ~nonempty).all())
    # pass 3 (i = x in L4, l = y in [Ylo, Yhi)) taps p2 rows x
    r, ok = twarp._taps(one, u, -u * twp.CQ, twp.Q, lanes, twp.Q, twp.Q,
                        twarp.BAND_HX, 8, nonzero=False)
    computed3 = (i_q >= l4lo) & (i_q < l4hi) & (l_q >= ylo) & (l_q < yhi)
    assert all(inside(r[k], ok[k], l3lo, l3hi, computed3) for k in range(2))
    # pass 2 (i = x in L3, l = y in [Ylo, Yhi)) taps pass-1 lanes t < PW
    r, ok = twarp._taps(sigma, zero, mx - sigma * twp.CQ, twp.Q, lanes,
                        twp.Q, twp.PW, twarp.BAND_SCALE, 8, nonzero=False)
    computed2 = (i_q >= l3lo) & (i_q < l3hi) & (l_q >= ylo) & (l_q < yhi)
    assert all(inside(r[k], ok[k], 0, twp.PW, computed2) for k in range(2))
    # what the crops need lies inside what the kernel computes
    n4, n3, n2, n1 = twarp.needed_masks(prm)
    lv = live[:, None, None]
    assert not (n4 & lv & ~computed4).any()
    yx3 = (l_q >= l4lo) & (l_q < l4hi) & (i_q >= ylo) & (i_q < yhi)
    assert not (n3.transpose(1, 2) & lv & ~yx3).any()   # p3 as (y, x)
    assert not (n2 & lv & ~computed2).any()
    rows1 = (torch.arange(twp.Q)[None, :, None] >= ylo) & (
        torch.arange(twp.Q)[None, :, None] < yhi)
    assert not (n1 & lv & ~rows1).any()


def _kernel_mix(pos, j0, band, src_rows, read):
    """The kernel's band-mix output: its two taps inside the window, summed
    in tap order; ``read(rows)`` gives (3, ...) values; NaN positions
    NaN."""
    t0 = torch.floor(pos)
    acc = torch.zeros((3,) + pos.shape)
    for k in (0.0, 1.0):
        rt = t0 + k
        ok = (rt >= j0) & (rt < j0 + band) & (rt < src_rows)
        w = torch.clamp_min(1.0 - torch.abs(pos - rt), 0.0)
        val = read(torch.where(ok, rt, 0.0).to(torch.int64))
        acc = acc + torch.where(ok, val * w, 0.0)
    return torch.where(pos.isnan(), float("nan"), acc)


def _emulate_fused(frames_planar, canvas_planar, prm):
    """The fused kernel's schedule on the CPU: the ranges of ``fused_plan``,
    p3 rows produced in batches of 16 into a ring of RING slots, each pass
    reading only its buffer. Buffers start as NaN, so a read of a slot not
    written (or overwritten) shows in the crops."""
    Q, G, CQ = twp.Q, twarp.G, twp.CQ
    plan = twarp.fused_plan(prm)
    f = len(plan)
    out = torch.full((f, twp.OUT, twp.OUT, 3), float("nan"))
    for n in range(f):
        if plan[n, 6]:
            continue
        b, level, _, ox = (int(t) for t in prm.iparams[n, :4])
        sigma, u, v, my, mx = prm.fparams[n, :5]
        src = frames_planar if level == 0 else canvas_planar
        nb, _, rows, w = src.shape
        l4lo, l4hi, l3lo, l3hi, ylo, yhi = (int(t) for t in plan[n, :6])
        rd_hi = plan[n, 8 + twarp.NG4:].tolist()
        one, zero = torch.ones(()), torch.zeros(())

        def j0(alpha, beta, gamma, i, src_rows, band, align):
            bm = torch.minimum(beta * 0.0, beta * float(Q - 1))
            base = torch.div(i, G, rounding_mode="floor").float() * G
            return twarp.band_start(alpha, bm, gamma, base, src_rows, band,
                                    align).float()

        def pos(alpha, beta, gamma, i, l):
            return (alpha * i.float() + beta * l.float()) + gamma

        g1, g2 = my - sigma * CQ, mx - sigma * CQ
        g3, g4, g5 = -u * CQ, -v * CQ, (CQ - twp.C0) - u * CQ
        ring = torch.full((3, twarp.RING, Q), float("nan"))
        made = ylo
        for g in range(twarp.NG4):
            while made < rd_hi[g]:
                y = torch.arange(made, min(made + 16, rd_hi[g]))[:, None]
                x = torch.arange(l3lo, l3hi)[None, :]
                p1 = pos(sigma, zero, g1, y, torch.zeros_like(y))
                j1 = j0(sigma, zero, g1, y, rows, twarp.BAND_SRC, 16)

                def a1(t):
                    col = ox + t
                    ok = (0 <= b < nb) & (col >= 0) & (col < w)
                    bc = min(max(b, 0), nb - 1)
                    p = p1.expand_as(t)

                    def read(r):
                        v8 = src[bc, :, r.clamp(0, rows - 1),
                                 col.clamp(0, w - 1)]
                        return torch.where(ok, v8.float(), 0.0)
                    return _kernel_mix(p, j1.expand_as(t), twarp.BAND_SRC,
                                       rows, read)

                p2b = torch.full((3, len(y), Q), float("nan"))
                p2b[:, :, l3lo:l3hi] = _kernel_mix(
                    pos(sigma, zero, g2, x, y).expand(len(y), -1),
                    j0(sigma, zero, g2, x, twp.PW, twarp.BAND_SCALE,
                       8).expand(len(y), -1), twarp.BAND_SCALE, twp.PW, a1)
                x4 = torch.arange(l4lo, l4hi)[None, :]
                rr = torch.arange(len(y))[:, None]
                ring[:, y[:, 0] % twarp.RING, l4lo:l4hi] = _kernel_mix(
                    pos(one, u, g3, x4, y),
                    j0(one, u, g3, x4, Q, twarp.BAND_HX, 8).expand(
                        len(y), -1), twarp.BAND_HX, Q,
                    lambda t: p2b[:, rr.expand_as(t), t])
                made = int(y[-1]) + 1
            gy = torch.arange((twarp.G4 + g) * G, (twarp.G4 + g + 1) * G
                              )[:, None]
            x4 = torch.arange(l4lo, l4hi)[None, :]
            p4b = torch.full((3, G, Q), float("nan"))
            p4b[:, :, l4lo:l4hi] = _kernel_mix(
                pos(one, v, g4, gy, x4),
                j0(one, v, g4, gy, Q, twarp.BAND_VY, 8).expand(-1, len(x4[0])),
                twarp.BAND_VY, Q,
                lambda t: ring[:, t % twarp.RING, x4.expand_as(t)])
            xo = torch.arange(twp.OUT)[None, :]
            rr = torch.arange(G)[:, None]
            p5 = _kernel_mix(pos(one, u, g5, xo, gy),
                             j0(one, u, g5, xo, Q, twarp.BAND_HX, 8).expand(
                                 G, -1), twarp.BAND_HX, Q,
                             lambda t: p4b[:, rr.expand_as(t), t])
            out[n, gy[:, 0] - twp.LANE_OFF] = p5.permute(1, 2, 0)
    return out


@pytest.mark.parametrize("name", K3_SETS)
def test_k3_fused_schedule_equals_the_plain_version(name):
    """The fused kernel's schedule, emulated on the CPU with its ranges,
    ring and tap rule, gives the plain version's crops bit for bit, NaN
    positions included."""
    fp, cp, prm = _k3_set(name)
    want = twarp.warp_crops_band_plain(fp, cp, prm)
    got = _emulate_fused(fp, cp, prm)
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])
    assert fin.any()


def test_k3_nonfinite_params_make_the_whole_crop_nan():
    """The fused kernel writes a crop all NaN when its sigma, u or v is not
    finite or its my or mx is NaN, because the plain version does: some
    pass's positions are NaN everywhere, and each later window carries
    the NaN on. An infinite my or mx only moves every tap out of the
    window: zeros."""
    fp, cp, prm = _edge_params(np.random.default_rng(4))
    want = twarp.warp_crops_band_plain(fp, cp, prm)
    dead = twarp.fused_plan(prm)[:, 6] == 1
    assert int(dead.sum()) == 8
    assert want[dead].isnan().all()
    assert not want[~dead].isnan().any()
    inf_m = torch.isinf(prm.fparams[:, 3]) | torch.isinf(prm.fparams[:, 4])
    assert inf_m.any() and (want[inf_m] == 0).all()


def _conv_inputs(seed, b=2, c=8, h=16, wp=32, f=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, h, wp)).astype(np.float32)
    k = rng.normal(scale=0.3, size=(3, 3, c, f)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    return x, tconv.pack_weights(k), scale, bias


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_conv3x3_matches_jax_interpret(relu, affine):
    x, w3, scale, bias = _conv_inputs(0)
    np.testing.assert_array_equal(w3, jconv.pack_weights(
        w3.reshape(3, 3, 8, 16)))
    kw = dict(scale=scale, bias=bias) if affine else {}
    want = jconv.pallas_conv3x3(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(w3).astype(jnp.bfloat16),
                                relu=relu, interpret=True, **kw)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(
        torch.bfloat16)
    launches = tconv.launches
    got = tconv.conv3x3(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w3).to(torch.bfloat16), relu=relu,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tconv.launches == launches
    assert got.shape == want.shape == (2, 16, 16, 32)
    assert tconv.bf16_ulps(got, want) <= 1
    if relu:
        assert float(got.float().min()) == 0.0


def test_conv3x3_lanes_are_circular_and_rows_zero_padded():
    """The plain version against a float64 numpy loop of the definition."""
    x, w3, scale, bias = _conv_inputs(1, b=1, c=3, h=8, wp=9, f=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w3).to(torch.bfloat16)
    got = tconv.conv3x3(xb, wb, torch.from_numpy(scale),
                        torch.from_numpy(bias)).float().numpy()
    xd = xb.double().numpy()
    wd = wb.double().numpy()
    c, h, wp = 3, 8, 9
    want = np.zeros((1, 5, h, wp))
    for dy in range(3):
        for dx in range(3):
            for ci in range(c):
                for hh in range(h):
                    r = hh + dy - 1
                    if not 0 <= r < h:
                        continue
                    src = xd[0, ci, r, (np.arange(wp) + dx - 1) % wp]
                    want[0, :, hh] += wd[dy, dx * c + ci][:, None] * src
    want = want * scale[None, :, None, None] + bias[None, :, None, None]
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


def test_conv3x3_refuses_heights_off_the_8_row_grid():
    x, w3, _, _ = _conv_inputs(2, h=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        jconv.pallas_conv3x3(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(w3).astype(jnp.bfloat16),
                             interpret=True)
    for fn in (tconv.conv3x3, tconv.conv3x3_plain):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(torch.from_numpy(x).to(torch.bfloat16),
               torch.from_numpy(w3).to(torch.bfloat16))


def _conv_f64(xb, wb):
    """The definition's sum (before the affine) in float64, from bf16
    tensors: rows zero-padded, lanes circular."""
    xd, wd = xb.double().numpy(), wb.double().numpy()
    b, c, h, wp = xd.shape
    xp = np.pad(xd, ((0, 0), (0, 0), (1, 1), (0, 0)))
    out = np.zeros((b, wd.shape[2], h, wp))
    for dy in range(3):
        for dx in range(3):
            src = np.roll(xp[:, :, dy:dy + h], 1 - dx, axis=3)
            for ci in range(c):
                out += wd[dy, dx * c + ci][None, :, None, None] * src[:, ci:ci
                                                                    + 1]
    return out


def test_tap_abs_sum_matches_a_float64_loop():
    x, w3, _, _ = _conv_inputs(1, b=1, c=3, h=8, wp=9, f=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w3).to(torch.bfloat16)
    got = tconv.tap_abs_sum(xb, wb)
    assert got.dtype == torch.float32 and got.shape == (1, 5, 8, 9)
    want = _conv_f64(xb.abs(), wb.abs())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    # the sum of |w||x| bounds the sum itself
    assert (np.abs(_conv_f64(xb, wb)) <= want * (1 + 1e-6)).all()


@pytest.mark.parametrize("relu", [False, True])
def test_sum_tolerance_ratio_passes_a_float64_summed_reference(relu):
    x, w3, scale, bias = _conv_inputs(3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w3).to(torch.bfloat16)
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    plain = tconv.conv3x3_plain(xb, wb, sc, bi, relu=relu)
    a = tconv.tap_abs_sum(xb, wb)
    assert tconv.sum_tolerance_ratio(plain, plain, a, sc) == 0.0
    ref = _conv_f64(xb, wb) * scale[None, :, None, None] + bias[
        None, :, None, None]
    if relu:
        ref = np.maximum(ref, 0.0)
    ref = torch.from_numpy(ref).to(torch.bfloat16)
    ratio = tconv.sum_tolerance_ratio(plain, ref, a, sc)
    assert 0.0 <= ratio <= 1.0
    assert not torch.equal(plain, ref)          # the orders do differ


@pytest.mark.parametrize("fault", ["tap_at_the_wrong_dx", "channel_dropped"])
def test_sum_tolerance_ratio_fails_a_wrong_or_dropped_tap(fault):
    x, w3, scale, bias = _conv_inputs(4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w3).to(torch.bfloat16)
    c = x.shape[1]
    bad = wb.clone()
    if fault == "tap_at_the_wrong_dx":      # dy=1, channel 3: dx 0 -> dx 2
        bad[1, 2 * c + 3] += bad[1, 3]
        bad[1, 3] = 0
    else:                                   # channel 5's weights, all taps
        bad[:, 5::c] = 0
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    want = tconv.conv3x3_plain(xb, wb, sc, bi)
    got = tconv.conv3x3_plain(xb, bad, sc, bi)
    assert tconv.sum_tolerance_ratio(got, want, tconv.tap_abs_sum(xb, wb),
                                     sc) > 1.0


def test_sum_tolerance_ratio_holds_nan_positions_and_infinities():
    want = torch.tensor([[[[1.0, float("nan"), float("inf"), -2.0]]]],
                        dtype=torch.bfloat16)
    a = torch.ones((1, 1, 1, 4))
    assert tconv.sum_tolerance_ratio(want.clone(), want, a) == 0.0
    moved = want.clone()
    moved[..., 1], moved[..., 3] = -2.0, float("nan")
    assert tconv.sum_tolerance_ratio(moved, want, a) == -1.0
    lost = want.clone()
    lost[..., 2] = 3.0                       # an infinity became finite
    assert tconv.sum_tolerance_ratio(lost, want, a) == float("inf")
    # one bf16 step apart passes, two do not (a = 0: no sum error allowed)
    one = torch.tensor([[[[1.0, 1.0078125]]]], dtype=torch.bfloat16)
    two = torch.tensor([[[[1.0, 1.015625]]]], dtype=torch.bfloat16)
    ref = torch.tensor([[[[1.0, 1.0]]]], dtype=torch.bfloat16)
    z = torch.zeros((1, 1, 1, 2))
    assert tconv.sum_tolerance_ratio(one, ref, z) == pytest.approx(
        0.0078125 / 0.0078125)
    assert tconv.sum_tolerance_ratio(two, ref, z) == pytest.approx(2.0)


def test_k4_ablation_variants_edit_the_kernel_source():
    """Each variant of ``tools/conv3x3_ablate.py`` applies to the current
    source (every edit found exactly once); timing them needs the card."""
    full = conv3x3_ablate.variant_source("full")
    assert "mma.sync.aligned.m16n8k16" in full
    for name in conv3x3_ablate.VARIANTS:
        src = conv3x3_ablate.variant_source(name)
        assert (src == full) == (name == "full"), name
    assert "s_ == 1234.5f" in conv3x3_ablate.variant_source("mma_only")
    with pytest.raises(RuntimeError, match="on the card"):
        conv3x3_ablate.run(device="cpu")


def test_k3_ablation_variants_edit_the_kernel_source():
    """Each variant of ``tools/warp_band_ablate.py`` applies to the
    current source (every edit found exactly once); timing them needs the
    card."""
    full = warp_band_ablate.variant_source("full")
    assert "cp.async.cg.shared.global" in full
    for name in warp_band_ablate.VARIANTS:
        src = warp_band_ablate.variant_source(name)
        assert (src == full) == (name == "full"), name
    assert "stage(made)" not in warp_band_ablate.variant_source("no_src")
    assert full.count("__syncthreads()") - warp_band_ablate.variant_source(
        "no_sync").count("__syncthreads()") == 5
    with pytest.raises(RuntimeError, match="on the card"):
        warp_band_ablate.run(device="cpu")


def test_k1_ablation_variants_edit_the_kernel_source():
    """Each variant of ``tools/warp_align_ablate.py`` applies to the
    current ``csrc/warp_align.cu`` (every edit found exactly once), the
    docstring names every variant and those that still compute the crops;
    timing them needs the card."""
    full = warp_align_ablate.variant_source("full")
    assert "reinterpret_cast<float4*>" in full and "__ldg" in full
    for name in warp_align_ablate.VARIANTS:
        src = warp_align_ablate.variant_source(name)
        assert (src == full) == (name == "full"), name
        assert f"- ``{name}``:" in warp_align_ablate.__doc__, name
    assert set(warp_align_ablate.EXACT) < set(warp_align_ablate.VARIANTS)
    assert "__ldg" not in warp_align_ablate.variant_source("no_load")
    assert "reinterpret_cast<float4*>" not in warp_align_ablate.variant_source(
        "scalar_stores")
    assert "tile[c][r][tile_col(q, k)] = res" not in (
        warp_align_ablate.variant_source("direct_stores"))
    assert "const dim3 grid(1, " in warp_align_ablate.variant_source(
        "one_cta_per_crop")
    assert warp_align_ablate.variant_source("no_store").count(
        "1234.5f") == 2
    with pytest.raises(RuntimeError, match="on the card"):
        warp_align_ablate.run(device="cpu")


def test_k1_ablation_workload_is_face_like():
    """The ablation's crops: scales 0.5-2, rotations within max_deg,
    centers inside the frame, crop i from frame i % nb; the plain version
    gives finite crops on them."""
    frames, minv, fidx = warp_align_ablate.workload(
        np.random.default_rng(0), 2, 10, h=120, w=200)
    assert frames.shape == (2, 120, 200, 3) and frames.dtype == torch.uint8
    assert fidx.tolist() == [i % 2 for i in range(10)]
    lin = minv[:, :, :2].double()
    sigma = lin.det().sqrt()
    assert bool(((sigma > 0.5 - 1e-5) & (sigma < 2 + 1e-5)).all())
    ang = torch.atan2(lin[:, 1, 0], lin[:, 0, 0]).abs()
    assert bool((ang <= np.pi / 6 + 1e-5).all())
    center = (minv @ torch.tensor([55.5, 55.5, 1.0])).double()
    assert bool(((center[:, 0] > 20) & (center[:, 0] < 180)
                 & (center[:, 1] > 12) & (center[:, 1] < 108)).all())
    crops = tops.warp_align_plain(frames, minv, fidx)
    assert bool(torch.isfinite(crops).all())


def test_k2_ablation_variants_edit_the_kernel_source():
    """Each variant of ``tools/pq_adc_ablate.py`` applies to the current
    ``csrc/pq_adc.cu`` (every edit found exactly once), the docstring names
    every variant, and the variants that still compute the scores are
    named as such; timing them needs the card."""
    full = pq_adc_ablate.variant_source("full")
    assert "Grp::load(tj + c * GB, w);" in full
    for name in pq_adc_ablate.VARIANTS:
        src = pq_adc_ablate.variant_source(name)
        assert (src == full) == (name == "full"), name
        assert f"- ``{name}``:" in pq_adc_ablate.__doc__, name
    assert set(pq_adc_ablate.EXACT) < set(pq_adc_ablate.VARIANTS)
    exact_line = ", ".join(f"``{n}``" for n in pq_adc_ablate.EXACT[:-1])
    assert exact_line in " ".join(pq_adc_ablate.__doc__.split())
    assert "Grp::load" not in pq_adc_ablate.variant_source("no_lookup")
    assert "mix_(h_)" in pq_adc_ablate.variant_source("lookup_only")
    assert "1234.5f" in pq_adc_ablate.variant_source("lookup_only")
    assert "want = MaxW;" in pq_adc_ablate.variant_source("w_max")
    assert set(pq_adc_ablate.SMALL_Q_VARIANTS) <= set(pq_adc_ablate.EXACT)
    with pytest.raises(RuntimeError, match="on the card"):
        pq_adc_ablate.run(device="cpu")


def test_build_variants_starts_one_compiler_per_variant(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "true")
    libs = cuda_build.build_variants("pq_adc", {"a": "// a", "b": "// b"})
    assert set(libs) == {"a", "b"}
    assert libs["a"] == (tmp_path / "ablate" / "libpq_adc_a.so").resolve()
    assert (tmp_path / "ablate" / "pq_adc_b.cu").read_text() == "// b"
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="pq_adc variant"):
        cuda_build.build_variants("pq_adc", {"a": "// a"})


def test_k4_script_path_runs_on_the_cpu():
    r = tconv.run(dict(b=2, h=16, w=24, c=8, f=16, wp=32), iters=1,
                  device="cpu")
    assert r["ulps"] == 0 and r["ratio"] == 0.0
    assert r["cudnn_wp_ms"] > 0 and r["cudnn_ms"] > 0
    # cuDNN's stand-in on the CPU agrees on the W real lanes to a bf16 step
    assert r["cudnn_max_abs"] <= r["scale"] * 2 ** -7


def test_kernel_wrappers_refuse_other_devices():
    """Checks that run before any launch, on 'meta' tensors, which no
    kernel can take."""
    with pytest.raises(ValueError, match="unsupported device"):
        tconv.conv3x3(torch.empty((1, 2, 8, 8), dtype=torch.bfloat16,
                                  device="meta"),
                      torch.empty((3, 6, 4), dtype=torch.bfloat16,
                                  device="meta"))
    prm = twp.WarpParams(*(torch.empty(s, dtype=d, device="meta") for s, d in
                           (((1, 8), torch.int32), ((1, 8), torch.float32),
                            ((1,), torch.bool), ((1,), torch.int32))))
    frames = torch.empty((1, 3, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        twarp.warp_crops_band(frames, frames, prm)
