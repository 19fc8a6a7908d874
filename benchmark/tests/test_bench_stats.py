"""The statistics, the seeds and the traffic generators."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.drivers import lookup, stream

CPU = torch.device("cpu")


def test_tail_is_the_nearest_rank_quantile():
    values = list(range(1, 101))
    assert core.tail(values) == 95
    assert core.tail(values[::-1]) == 95
    assert core.tail([7.0]) == 7.0
    assert core.tail(list(range(1, 21)), 0.95) == 19
    with pytest.raises(ValueError):
        core.tail([])


def test_rate_over_the_window():
    assert core.rate(960, 1.25) == 768.0
    with pytest.raises(ValueError):
        core.rate(1, 0.0)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Out:
    def __init__(self, b):
        self.boxes = torch.zeros((b, 1, 4))
        self.count = torch.ones(b, dtype=torch.int32)


class FakePipe:
    """process_stream at depth 2 with a clock: each dispatch takes 0.1 s,
    each finish 0.2 s."""

    def __init__(self, clock):
        self.clock = clock

    def process_stream(self, it, max_num, depth):
        pending = []
        for frames in it:
            self.clock.t += 0.1
            pending.append(frames)
            if len(pending) > depth:
                self.clock.t += 0.2
                yield Out(len(pending.pop(0)))
        while pending:
            self.clock.t += 0.2
            yield Out(len(pending.pop(0)))


def test_stream_window_times_batches_from_take_to_yield(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(stream.time, "perf_counter", clock)
    batches = [np.zeros((4, 2, 2, 3), np.uint8)] * 2
    w = stream.window(FakePipe(clock), batches, 1.0, 2, 1,
                      np.ones(100, bool), lambda: None, count_faces=True)
    # taken at 100.0, 100.1, 100.2, 100.5, 100.8 (none at 101.1, past the
    # window); yielded at 100.5, 100.8, 101.1, then drained at 101.3, 101.5
    assert w["latency"] == pytest.approx([0.5, 0.7, 0.9, 0.8, 0.7])
    assert w["frames"] == 20 and w["faces"] == 20
    assert w["seconds"] == pytest.approx(1.5)
    assert sorted(w["kept"]) == list(range(5))
    assert core.tail(w["latency"]) == pytest.approx(0.9)
    assert core.rate(w["frames"], w["seconds"]) == pytest.approx(20 / 1.5)


def test_sub_seeds_are_fixed_distinct_and_take_large_seeds():
    big = 2 ** 31 + 12345
    assert core.sub_seed(big, "frames") == core.sub_seed(big, "frames")
    assert core.sub_seed(big, "frames") != core.sub_seed(big, "det")
    assert core.sub_seed(big, "det") != core.sub_seed(big + 1, "det")
    assert core.sub_seed(2 ** 62, "x") < 2 ** 63


TRAFFIC = dict(pool=2, frames=2, height=8, width=12, gallery_rows=6,
               gallery_near=3, rows=500, identities=40, m=8, k=16,
               changed_share=0.25, queries=4, query_noise=0.3)


@pytest.mark.parametrize("make", [
    lambda s: stream.frame_pool(TRAFFIC, s, CPU),
    lambda s: stream.gallery_rows(TRAFFIC, _faces(), s, CPU),
    lambda s: stream.reference_models(
        SMALL_MODELS, dict(TRAFFIC, calib_frames=2), stream.seeds(s),
        stream.frame_pool(TRAFFIC, 5, CPU), CPU)[2],
    lambda s: lookup.codebook(TRAFFIC, 32, s, CPU),
    lambda s: lookup.gallery_codes(TRAFFIC, s, CPU, block=128),
    lambda s: lookup.query_pool(TRAFFIC, lookup.codebook(TRAFFIC, 32, s, CPU),
                                lookup.gallery_codes(TRAFFIC, s, CPU), s,
                                CPU),
], ids=["frames", "gallery", "calibrated_models", "codebook", "codes",
        "queries"])
def test_generators_are_deterministic_in_the_seed(make):
    a, b, c = make(2 ** 33 + 1), make(2 ** 33 + 1), make(2 ** 33 + 2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def _faces():
    g = torch.Generator().manual_seed(0)
    return torch.nn.functional.normalize(torch.randn((5, 8), generator=g),
                                         dim=1)


# the configuration's models cut to one block a stage and narrow widths
SMALL_MODELS = dict(
    detector=dict(family="scrfd", variant="det_10g", stem=8,
                  blocks=[1, 1, 1, 1], planes=[8, 8, 16, 16], neck=8,
                  head_feat=16, head_stacks=1, gn_groups=4,
                  score_logit_shift=0.5),
    embedder=dict(family="iresnet", variant="w600k_r50",
                  blocks=[1, 1, 1, 1], planes=[4, 8, 8, 8], emb=8),
    det_size=[640, 640], conf_thres=0.5, iou_thres=0.4, pre_nms=256,
    max_det=16, max_num=10)


def test_codes_keep_identity_structure():
    codes = lookup.gallery_codes(dict(TRAFFIC, rows=4000, identities=10,
                                      changed_share=0.1), 5, CPU)
    # ten identities: most rows share most sub-codes with another row
    same = (codes[:200, None] == codes[None, :200]).float().mean(-1)
    assert (same.topk(2, dim=1).values[:, 1] > 0.7).float().mean() > 0.9
