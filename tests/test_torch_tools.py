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
    pq_adc_ablate)


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
