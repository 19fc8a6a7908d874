"""The counting functions against hand counts at small shapes."""
from __future__ import annotations

import pytest
import torch

from benchmark import counts


def test_k2_bound_counts_codes_table_and_scores_once():
    t, by = counts.k2_bound(q=2, m=4, k=16, g=10, precision="hilo")
    # codes 10 x 4, table 2 x 4 x 16 f32, scores 2 x 10 f32
    assert by == "bytes"
    assert t == pytest.approx((40 + 512 + 80) / counts.PEAK_HBM_BYTES)
    t_hi, _ = counts.k2_bound(q=2, m=4, k=16, g=10, precision="hi")
    assert t_hi == pytest.approx((40 + 256 + 80) / counts.PEAK_HBM_BYTES)
    t_big, by_big = counts.k2_bound(q=64, m=64, k=256, g=10_000_000,
                                    precision="hilo")
    nbytes = 640_000_000 + 64 * 64 * 256 * 4 + 64 * 10_000_000 * 4
    assert by_big == "bytes"
    assert t_big == pytest.approx(nbytes / 3.35e12)


def test_lookup_bound_is_the_adds_at_scale():
    t = counts.lookup_bound(q=64, d=512, m=64, k=256, g=10_000_000)
    assert t == pytest.approx((2 * 64 * 512 * 256 + 64 * 10_000_000 * 64)
                              / 67e12)


def test_k1_bound_counts_each_source_pixel_once():
    # one crop whose matrix is the identity: its taps are the pixels
    # (x, y) and (x + 1, y + 1) of a 113 x 113 square
    minv = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    t, by = counts.k1_bound((1, 200, 300), minv, torch.zeros(1), 1)
    nbytes = 113 * 113 * 3 + 3 * 112 * 112 * 4 + 6 * 4 + 4
    assert by == "bytes"
    assert t == pytest.approx(nbytes / counts.PEAK_HBM_BYTES)
    # two crops on the same pixels of one frame read them once
    t2, _ = counts.k1_bound((1, 200, 300), minv.repeat(2, 1, 1),
                            torch.zeros(2), 2)
    assert t2 == pytest.approx((113 * 113 * 3 + 2 * (3 * 112 * 112 * 4
                                                     + 28)) / 3.35e12)
    # ... and on two frames twice; taps past the frame are not read
    t3, _ = counts.k1_bound((2, 60, 300), minv.repeat(2, 1, 1),
                            torch.tensor([0, 1]), 2)
    assert t3 == pytest.approx((2 * 113 * 60 * 3 + 2 * (3 * 112 * 112 * 4
                                                        + 28)) / 3.35e12)


def hand_flops(model: torch.nn.Module, x: torch.Tensor) -> float:
    """2 x the multiply-adds of every convolution and dense layer, from
    their weights' and outputs' shapes."""
    total = [0.0]

    def conv(m, _, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        total[0] += 2.0 * out.numel() * k

    def dense(m, _, out):
        total[0] += 2.0 * out.numel() * m.weight.shape[1]

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(dense)
    model(x)
    return total[0]


@pytest.mark.parametrize("spec, chw", [
    ({"family": "scrfd", "stem": 8, "blocks": [1, 1, 1, 1],
      "planes": [8, 8, 16, 16], "neck": 8, "head_feat": 16,
      "head_stacks": 1, "gn_groups": 4}, (3, 64, 96)),
    ({"family": "iresnet", "blocks": [1, 1, 1, 1], "planes": [4, 8, 8, 8],
      "emb": 16}, (3, 112, 112)),
    # a stride-2 stage as wide as the one before (det_10g's 88 -> 88)
    ({"family": "scrfd", "stem": 8, "blocks": [1, 2, 1, 1],
      "planes": [8, 16, 16, 24], "neck": 8, "head_feat": 16,
      "head_stacks": 2, "gn_groups": 4}, (3, 64, 96)),
], ids=["scrfd", "iresnet", "scrfd_equal_stage_widths"])
def test_model_flops_equal_a_count_by_layer_shapes(spec, chw):
    from benchmark.reference.standins import architecture

    model = architecture(spec).eval().requires_grad_(False)
    want = hand_flops(model, torch.zeros((1, *chw)))
    assert counts.model_flops(spec, chw) == pytest.approx(want)


# buffalo_l's models on the card cell's shapes, as counted on the tree
# before the families had files of their own (e7ac93b)
RECORDED_FLOPS = {"detector": ((3, 384, 640), 15_449_226_240),
                  "embedder": ((3, 112, 112), 12_618_661_888)}


@pytest.mark.parametrize("part", sorted(RECORDED_FLOPS))
def test_model_flops_of_buffalo_l_are_the_recorded_counts(part):
    from benchmark import core

    chw, want = RECORDED_FLOPS[part]
    spec = core.read_json(core.config_file("buffalo_l"))[part]
    assert counts.model_flops(spec, chw) == want
