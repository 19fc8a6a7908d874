"""Device ms a batch of the detector's stages (letterbox, SCRFD, decode +
NMS), from the CUDA events the port's stage hook places around them over
the traced run's window."""

STAGES = ("letterbox", "scrfd", "decode_nms")


def read(data):
    ms = data.get("stage_ms")
    if not ms or not data.get("batches") or not any(s in ms for s in STAGES):
        return None
    return sum(ms.get(s, 0.0) for s in STAGES) / data["batches"]
