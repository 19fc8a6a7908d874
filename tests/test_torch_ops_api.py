"""The rest of ``ops``' public API against the JAX package's, on the CPU:
``warp_affine``, ``warp_affine_batch``, ``norm_crop`` (the reference's
``norm_crop_image``) and the sequential ``nms_mask``.

Tolerances: the warps within 1e-3 on the 0-255 scale (float32 on both
sides, the same operand order); ``norm_crop`` within 1e-3 of JAX's warp
of the port's own alignment matrix, and within 0.05 of JAX's
``norm_crop``: its matrix comes from ``estimate_norm``, which
``tests/test_torch_ops.py`` holds to JAX's within 1e-5 relative, and 1e-5
of a 200-pixel coordinate moves a tap by 2e-3 pixel (0.5 of an intensity
step at the steepest edge of 0-255 noise; measured 0.0064);
``nms_mask`` equal to JAX's and to the port's own ``nms_mask_blocked``,
mask for mask, as the JAX package's property test holds its two.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu import ops as jops
from scrfd_arcface_facerecognition_tpu_torch import ops as tops

WARP_ATOL = 1e-3
CROP_ATOL = 0.05


def _image(rng, h=96, w=128):
    return rng.integers(0, 255, (h, w, 3)).astype(np.float32)


def _matrices(rng, n, h, w):
    """src -> dst similarities onto 112 x 112: scale, rotation (some past
    90 degrees), shifts that put part of the crop outside the image."""
    out = []
    for _ in range(n):
        s = rng.uniform(0.5, 2.0)
        a = rng.uniform(-np.pi, np.pi)
        c, si = s * np.cos(a), s * np.sin(a)
        cx, cy = rng.uniform(-10, w + 10), rng.uniform(-10, h + 10)
        out.append([[c, -si, 56 - (c * cx - si * cy)],
                    [si, c, 56 - (si * cx + c * cy)]])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("out_hw", [(112, 112), (50, 70)])
def test_warp_affine_and_batch_match_jax(out_hw):
    rng = np.random.default_rng(0)
    img = _image(rng)
    ms = _matrices(rng, 6, *img.shape[:2])
    want = np.asarray(jops.warp_affine(jnp.asarray(img), jnp.asarray(ms[0]),
                                       out_hw))
    got = tops.warp_affine(torch.from_numpy(img), torch.from_numpy(ms[0]),
                           out_hw)
    assert got.shape == (*out_hw, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    from scrfd_arcface_facerecognition_tpu.ops.warp import warp_affine_batch

    want = np.asarray(warp_affine_batch(jnp.asarray(img), jnp.asarray(ms),
                                        out_hw))
    got = tops.warp_affine_batch(torch.from_numpy(img), torch.from_numpy(ms),
                                 out_hw)
    assert got.shape == (6, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    # a u8 image warps as its float32 values do
    u8 = tops.warp_affine(torch.from_numpy(img.astype(np.uint8)),
                          torch.from_numpy(ms[0]), out_hw)
    np.testing.assert_allclose(u8.numpy(), got[0].numpy(), rtol=0,
                               atol=WARP_ATOL)


@pytest.mark.parametrize("image_size", [112, 128])
def test_norm_crop_matches_jax_one_and_batched(image_size):
    rng = np.random.default_rng(1)
    img = _image(rng, 160, 200)
    template = np.asarray(jops.ARCFACE_DST, np.float32)
    lms = np.stack([template * rng.uniform(0.8, 1.6)
                    + rng.uniform(0, 60, size=2)
                    + rng.normal(scale=2.0, size=(5, 2))
                    for _ in range(4)]).astype(np.float32)
    from scrfd_arcface_facerecognition_tpu.ops.warp import warp_affine_batch

    size = (image_size, image_size)
    for lm in (lms[0], lms):
        want = np.asarray(jops.norm_crop(jnp.asarray(img), jnp.asarray(lm),
                                         image_size))
        got = tops.norm_crop(torch.from_numpy(img), torch.from_numpy(lm),
                             image_size)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=CROP_ATOL)
        m = tops.estimate_norm(torch.from_numpy(lm), image_size).numpy()
        same_m = (jops.warp_affine(jnp.asarray(img), jnp.asarray(m), size)
                  if lm.ndim == 2 else warp_affine_batch(
                      jnp.asarray(img), jnp.asarray(m), size))
        np.testing.assert_allclose(got.numpy(), np.asarray(same_m), rtol=0,
                                   atol=WARP_ATOL)


def _slate(rng, k):
    """Score-sorted (K, 4) boxes in overlapping clusters, a validity mask
    with holes."""
    centers = rng.uniform(0, 200, size=(max(k // 6, 1), 2))
    c = centers[rng.integers(0, len(centers), size=k)]
    c = c + rng.normal(scale=6.0, size=(k, 2))
    side = rng.uniform(10, 40, size=(k, 1))
    boxes = np.concatenate([c - side / 2, c + side / 2], 1).astype(
        np.float32)
    valid = rng.uniform(size=k) > 0.15
    return boxes, valid


@pytest.mark.parametrize("k", [1, 7, 32, 50, 96])
def test_nms_mask_matches_jax_and_the_blocked_form(k):
    rng = np.random.default_rng(k)
    for trial in range(4):
        boxes, valid = _slate(rng, k)
        for v in (None, valid):
            for thr in (0.3, 0.5):
                want = np.asarray(jops.nms_mask(
                    jnp.asarray(boxes), thr,
                    None if v is None else jnp.asarray(v)))
                tv = None if v is None else torch.from_numpy(v)
                got = tops.nms_mask(torch.from_numpy(boxes), thr, tv)
                np.testing.assert_array_equal(got.numpy(), want)
                blocked = tops.nms_mask_blocked(torch.from_numpy(boxes), thr,
                                                tv, block=8)
                np.testing.assert_array_equal(got.numpy(), blocked.numpy())
    # leading batch dims: each row as alone
    boxes = np.stack([_slate(rng, k)[0] for _ in range(3)])
    got = tops.nms_mask(torch.from_numpy(boxes), 0.4)
    for b in range(3):
        want = np.asarray(jops.nms_mask(jnp.asarray(boxes[b]), 0.4))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_the_api_is_exported():
    for name in ("warp_affine", "warp_affine_batch", "norm_crop",
                 "nms_mask"):
        assert name in tops.__all__ and callable(getattr(tops, name))
