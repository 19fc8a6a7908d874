"""The whole step's share of the card's bf16 peak, in %: the FLOPs of one
detector forward a frame and one embedder forward a reported face
(``FlopCounterMode`` on the reference modules), summed over the traced
run's window, over the window's seconds and 989 TFLOP/s."""

from benchmark.counts import PEAK_BF16_FLOPS


def read(data):
    if not data.get("det_flops") or data.get("faces") is None:
        return None
    flops = (data["frames"] * data["det_flops"]
             + data["faces"] * data["rec_flops"])
    return 100.0 * flops / (data["window_s"] * PEAK_BF16_FLOPS)
