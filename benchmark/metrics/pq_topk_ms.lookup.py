"""Device ms a lookup of the gallery's ``pq_topk`` stage (the mask, the
sorts and the copy of the winners to the host), from the CUDA events the
port's stage hook places around it over the traced run's window."""


def read(data):
    ms = data.get("stage_ms")
    if not ms or "pq_topk" not in ms or not data.get("lookups"):
        return None
    return ms["pq_topk"] / data["lookups"]
